"""The port's parallel layer: the five-axis mesh over a gang's ranks
(`mesh`), the collectives with psum's two transposes (`collectives`),
and sequence-parallel attention (sp = 1 only so far)."""

from .mesh import AXIS_NAMES, Mesh, MeshConfig, build_mesh, default_mesh_config, rank_grid
from .ring_attention import ring_attention

__all__ = ["AXIS_NAMES", "Mesh", "MeshConfig", "build_mesh", "default_mesh_config",
           "rank_grid", "ring_attention"]
