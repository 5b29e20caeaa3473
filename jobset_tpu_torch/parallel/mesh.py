"""The five-axis mesh over a gang's ranks: the port's counterpart of
`jobset_tpu/parallel/mesh.py`.

    dp  data parallel (batch rows), outermost
    pp  pipeline stages
    ep  expert shards
    sp  sequence chunks
    tp  tensor shards (heads, hidden columns, vocab), innermost

The reference lays a `jax.sharding.Mesh` over devices; the port runs one
process per device, so its mesh lies over `torch.distributed` ranks, in
the reference's device order: rank `r` sits where the reference puts
device `r` (`rank_grid`), so dp is outermost and process-major and tp
varies fastest. `build_mesh` makes a `DeviceMesh` over the ranks with
`mesh_dim_names=AXIS_NAMES` and exposes one process group per axis
(`Mesh.group`); an axis of size 1 has no group, and every collective over
it is the identity, as in the reference. More groups join axes
(`JOINT_AXES`), one all-reduce where the reference names several axes in
one psum: the batch is split over dp and sp (`DATA_AXES`), so the
layers' gradients reduce over the pair; the loss's sums and the gradients
of the leaves every pipeline stage shares (the embedding, the final norm,
the unembedding) reduce over dp, sp and pp (`LOSS_AXES`); a mixture-of-
experts layer sums its experts' partial outputs over ep and tp
(`EXPERT_AXES`) and pools its balancing statistics over dp, sp and ep
(`STATS_AXES`).
`single_device_mesh()` is the mesh of a run with no process group at
all.

The reference's varying-axes helpers (`vma_union`, `pvary_like`,
`pvary_to`) have no counterpart: torch has no varying-axes typing, and
the port's collectives (`parallel.collectives`) carry the two transposes
of `psum` themselves ("reduce": all-reduce forward, identity backward;
"copy": identity forward, all-reduce backward), placed where the
reference's shard_map inserts a psum or an implicit pvary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

AXIS_NAMES = ("dp", "pp", "ep", "sp", "tp")
# The axes the batch is split over (rows over dp, positions over sp): the
# layers' gradients reduce over both at once.
DATA_AXES = ("dp", "sp")
# The batch's axes and the pipeline's: the loss's sums, and the gradients of
# the leaves outside the stacked layers, reduce over all three.
LOSS_AXES = ("dp", "sp", "pp")
# The expert-sharded layer's axes: its experts' partial outputs sum over
# ep and tp; its balancing statistics pool over the batch's axes and ep.
EXPERT_AXES = ("ep", "tp")
STATS_AXES = ("dp", "sp", "ep")
# The joint groups every mesh makes, each where two or more of its axes
# are above 1, in this order on every rank.
JOINT_AXES = (DATA_AXES, LOSS_AXES, EXPERT_AXES, STATS_AXES)


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.ep, self.sp, self.tp)

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))

    def __post_init__(self):
        for name, size in zip(AXIS_NAMES, self.shape):
            if size < 1:
                raise ValueError(f"mesh axis {name} must be >= 1, got {size}")

    @classmethod
    def of(cls, mesh_shape) -> "MeshConfig":
        """A MeshConfig from a payload's `mesh` mapping (axis -> size), a
        MeshConfig, or None (every axis 1)."""
        if isinstance(mesh_shape, cls):
            return mesh_shape
        return cls(**{axis: int(size) for axis, size in (mesh_shape or {}).items()})


def default_mesh_config(n_devices: int) -> MeshConfig:
    """Factor a device count into a config, preferring tp, then sp, then pp;
    dp takes the rest."""
    remaining = n_devices
    tp = _take_factor(remaining, 2)
    remaining //= tp
    sp = _take_factor(remaining, 2)
    remaining //= sp
    pp = _take_factor(remaining, 2)
    remaining //= pp
    return MeshConfig(dp=remaining, pp=pp, ep=1, sp=sp, tp=tp)


def _take_factor(n: int, f: int) -> int:
    return f if n % f == 0 and n >= f else 1


def rank_grid(config: MeshConfig) -> np.ndarray:
    """The ranks laid on the mesh, shape `config.shape`: rank r where the
    reference's `build_mesh` puts device r (row-major, tp fastest)."""
    return np.arange(config.num_devices).reshape(config.shape)


def multislice_rank_grid(ici: MeshConfig, dcn: MeshConfig) -> np.ndarray:
    """The reference's multislice layout without slice topology
    (`build_multislice_mesh`'s contiguous-block path): each slice is a
    contiguous block of ici.num_devices ranks laid out by `ici`, and the dcn
    axes are outermost within each axis, so axis a has size dcn[a] * ici[a]."""
    per_slice = ici.num_devices
    blocks = np.arange(per_slice * dcn.num_devices).reshape((*dcn.shape, per_slice))
    grid = np.empty((*dcn.shape, *ici.shape), dtype=np.int64)
    for idx in np.ndindex(*dcn.shape):
        grid[idx] = blocks[idx].reshape(ici.shape)
    order = [ax + off for ax in range(5) for off in (0, 5)]
    return grid.transpose(order).reshape(tuple(d * i for d, i in zip(dcn.shape, ici.shape)))


class Mesh:
    """This process's place on the five axes, and one process group per axis
    of size > 1 (None for an axis of size 1: its collectives are
    identities). `Mesh(config, grid, rank)` without groups describes a rank
    for slicing (`convert.shard_params`) and builds no process group."""

    def __init__(self, config: MeshConfig, grid: np.ndarray, rank: int, groups=None):
        self.config = config
        self.grid = grid
        self.rank = rank
        where = np.argwhere(grid == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {config.shape}")
        self.coords = dict(zip(AXIS_NAMES, (int(i) for i in where[0])))
        self.groups = dict(groups or {})

    @classmethod
    def at(cls, config: MeshConfig, rank: int) -> "Mesh":
        """The mesh as rank `rank` sees it, without process groups."""
        return cls(config, rank_grid(config), rank)

    @property
    def shape(self) -> dict:
        return dict(zip(AXIS_NAMES, self.config.shape))

    def size(self, axis) -> int:
        """An axis's size; of a tuple of axes, their product."""
        if isinstance(axis, tuple):
            return int(np.prod([self.size(a) for a in axis]))
        return getattr(self.config, axis)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis):
        """The axis's process group; None where the axis has size 1. A tuple
        of axes (one of `JOINT_AXES`) names their joint group, which is one
        axis's group where the others have size 1."""
        if self.size(axis) == 1:
            return None
        if isinstance(axis, tuple):
            wide = [a for a in axis if self.size(a) > 1]
            if len(wide) == 1:
                return self.group(wide[0])
        if axis not in self.groups:
            raise RuntimeError(f"mesh axis {axis} has no process group: build the mesh with "
                               "build_mesh after runtime.distributed.initialize")
        return self.groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _world() -> int:
    """The process group's size; raises before `distributed.initialize`."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call runtime.distributed.initialize "
                           "before building a mesh")
    return dist.get_world_size()


def _joint_group(grid: np.ndarray, axes: tuple):
    """This rank's group of the axes of `axes` that are above 1, where two
    or more are, else None. torch asks every rank of the gang to make every
    group, in one order, so every rank (one past a submesh too) makes one
    for each place on the other axes and keeps its own."""
    import torch.distributed as dist

    wide = [AXIS_NAMES.index(axis) for axis in axes if grid.shape[AXIS_NAMES.index(axis)] > 1]
    if len(wide) < 2:
        return None
    rest = [i for i in range(grid.ndim) if i not in wide]
    by_place = np.moveaxis(grid, wide, list(range(grid.ndim - len(wide), grid.ndim)))
    mine = None
    for place in np.ndindex(*[grid.shape[i] for i in rest]):
        ranks = sorted(int(r) for r in by_place[place].flatten())
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    return mine


def _device_mesh(grid: np.ndarray, device) -> Optional[Mesh]:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..device import resolve_device

    dm = DeviceMesh(resolve_device(device).type, torch.as_tensor(grid),
                    mesh_dim_names=AXIS_NAMES)
    joint = {axes: _joint_group(grid, axes) for axes in JOINT_AXES}
    if dm.get_coordinate() is None:  # a rank past a submesh
        return None
    groups = {axis: dm.get_group(axis) for axis, size in zip(AXIS_NAMES, grid.shape)
              if size > 1}
    groups.update({axes: group for axes, group in joint.items() if group is not None})
    return Mesh(MeshConfig(*grid.shape), grid, dist.get_rank(), groups)


def build_mesh(config: Optional[MeshConfig] = None, device=None,
               allow_submesh: bool = False) -> Optional[Mesh]:
    """The five-axis mesh over the process group's ranks, its groups for
    `device` (the card unless the caller names the CPU). Every rank of the
    gang calls it (the groups are made together). The config must use
    exactly the gang's ranks; `allow_submesh=True` lays it on a prefix of
    them, and a rank past the prefix gets None (otherwise a too-small
    config is an error, not silently idle ranks)."""
    world = _world()
    if config is None:
        config = default_mesh_config(world)
    if config.num_devices > world or (config.num_devices < world and not allow_submesh):
        raise ValueError(
            f"mesh config {config.shape} needs {config.num_devices} devices, got {world} "
            "(pass allow_submesh=True to use a subset)"
        )
    return _device_mesh(rank_grid(config), device)


def build_multislice_mesh(ici: MeshConfig, dcn: MeshConfig, device=None) -> Mesh:
    """The multislice mesh over the process group's ranks: dcn axes span
    slices, ici axes live in each slice, each slice a contiguous block of
    ranks (`multislice_rank_grid`)."""
    world = _world()
    total = ici.num_devices * dcn.num_devices
    if total != world:
        raise ValueError(
            f"multislice mesh ici{ici.shape} x dcn{dcn.shape} needs {total} devices, "
            f"got {world}"
        )
    return _device_mesh(multislice_rank_grid(ici, dcn), device)


def single_device_mesh() -> Mesh:
    """Every axis at size 1 and no process group: the single-device path."""
    return Mesh.at(MeshConfig(), 0)

