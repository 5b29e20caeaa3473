"""The port's parallel layer: the five-axis mesh over a gang's ranks
(`mesh`), the collectives with their transposes (`collectives`: psum's
two, the ring's rotation and the all-to-all), sequence-parallel attention
(`ring_attention`, `ulysses_attention`) and ZeRO-1's state split over dp
(`zero`)."""

from .mesh import (
    AXIS_NAMES,
    DATA_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    default_mesh_config,
    rank_grid,
)
from .ring_attention import ring_attention
from .ulysses_attention import ulysses_attention
from .zero import shard_state, widen_spec, zero1_plan

__all__ = ["AXIS_NAMES", "DATA_AXES", "Mesh", "MeshConfig", "build_mesh", "default_mesh_config",
           "rank_grid", "ring_attention", "shard_state", "ulysses_attention", "widen_spec",
           "zero1_plan"]
