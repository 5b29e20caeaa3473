"""The port's parallel layer: the five-axis mesh over a gang's ranks
(`mesh`), the collectives with their transposes (`collectives`: psum's
two, the ring's rotation, the all-to-all and the pipeline's shift),
sequence-parallel attention (`ring_attention`, `ulysses_attention`),
ZeRO-1's state split over dp (`zero`) and the pipeline schedules over pp
(`pipeline`: the gpipe, interleaved and 1f1b timetables and the loop
that runs them)."""

from .mesh import (
    AXIS_NAMES,
    DATA_AXES,
    LOSS_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    default_mesh_config,
    rank_grid,
)
from .pipeline import (
    drive,
    interleave_stage_params,
    schedule_1f1b,
    schedule_steps,
    timetable,
)
from .ring_attention import ring_attention
from .ulysses_attention import ulysses_attention
from .zero import shard_state, widen_spec, zero1_plan

__all__ = ["AXIS_NAMES", "DATA_AXES", "LOSS_AXES", "Mesh", "MeshConfig", "build_mesh",
           "default_mesh_config", "drive", "interleave_stage_params", "rank_grid",
           "ring_attention", "schedule_1f1b", "schedule_steps", "shard_state", "timetable",
           "ulysses_attention", "widen_spec", "zero1_plan"]
