"""The rank grid (counterpart of procyon_tpu/parallel/mesh.py).

JAX builds one `Mesh` over (data, fsdp, model) and GSPMD inserts every
collective. The port's parameters are plain trees of tensors and its
kernels take plain tensors, so its collectives are explicit
(`torch.distributed`): the mesh here is the same grid of ranks, with one
process group per axis and one over data x fsdp for the batch.

  * data  - batch parallelism (rank-interleaved rows of the global batch)
  * fsdp  - parameter / optimizer sharding (ZeRO), also batch rows
  * model - tensor parallelism (whole kv heads / MLP columns, Megatron's
            split)

Rank r sits at np.unravel_index(r, (data, fsdp, model)), as JAX reshapes
its device list. A mesh whose axes are all 1 has no groups: every caller
then takes its one-process path.
"""

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

AXES = ("data", "fsdp", "model")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = -1  # -1: all remaining ranks
    model: int = 1

    def resolve(self, n_devices: int):
        known = [d for d in (self.data, self.fsdp, self.model) if d != -1]
        prod = math.prod(known)
        missing = n_devices // max(prod, 1)
        dims = tuple(missing if d == -1 else d
                     for d in (self.data, self.fsdp, self.model))
        assert math.prod(dims) == n_devices, (
            f"mesh {dims} != {n_devices} devices")
        return dims


class Mesh:
    """This rank's place in the (data, fsdp, model) grid and its groups.

    shape: {axis: size}; coords: {axis: this rank's index}; groups: {axis
    or "batch": ProcessGroup, or None where the axis has size 1}. The
    batch group spans data x fsdp (data major, as JAX's
    PartitionSpec(("data", "fsdp")) orders the rows)."""

    def __init__(self, dims, rank: int, groups: Dict[str, object]):
        self.shape = dict(zip(AXES, (int(d) for d in dims)))
        self.rank = int(rank)
        self.coords = dict(zip(AXES, (int(i) for i in np.unravel_index(
            self.rank, tuple(self.shape.values())))))
        self.groups = groups

    def size(self, axis: str) -> int:
        if axis == "batch":
            return self.shape["data"] * self.shape["fsdp"]
        return self.shape[axis]

    def index(self, axis: str) -> int:
        if axis == "batch":
            return self.coords["data"] * self.shape["fsdp"] \
                + self.coords["fsdp"]
        return self.coords[axis]

    def group(self, axis: str):
        """The axis's process group, None when the axis has size 1."""
        return self.groups.get(axis)

    @property
    def trivial(self) -> bool:
        return all(v == 1 for v in self.shape.values())


def _axis_groups(dims, axes, dist):
    """One group for each line of the grid along `axes` (every rank makes
    every group, in the same order, as torch.distributed.new_group asks);
    returns the group that holds this rank."""
    ranks = np.arange(math.prod(dims)).reshape(dims)
    keep = [AXES.index(a) for a in axes]
    rest = [i for i in range(3) if i not in keep]
    lines = ranks.transpose(rest + keep).reshape(
        -1, math.prod(dims[i] for i in keep))
    mine = None
    me = dist.get_rank()
    for line in lines:
        g = dist.new_group([int(r) for r in line])
        if me in line:
            mine = g
    return mine


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The grid over the default process group's ranks (or one rank when
    there is none). Every rank must call it, with the same cfg."""
    import torch.distributed as dist

    cfg = cfg or MeshConfig()
    initialized = dist.is_available() and dist.is_initialized()
    world_size = dist.get_world_size() if initialized else 1
    dims = cfg.resolve(world_size)
    groups = {}
    if world_size > 1:
        for name, axes in (("data", ("data",)), ("fsdp", ("fsdp",)),
                           ("model", ("model",)),
                           ("batch", ("data", "fsdp"))):
            n = math.prod(dims[AXES.index(a)] for a in axes)
            groups[name] = _axis_groups(dims, axes, dist) if n > 1 else None
    rank = dist.get_rank() if initialized else 0
    return Mesh(dims, rank, groups)
