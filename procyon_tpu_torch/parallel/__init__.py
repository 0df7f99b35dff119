"""More than one rank (counterpart of procyon_tpu/parallel/): a rank grid
over (data, fsdp, model) with one torch.distributed process group per
axis, the JAX package's sharding rules over plain trees of tensors, and
the collectives GSPMD inserts there, written out (collectives.py)."""

from procyon_tpu_torch.parallel.mesh import AXES, Mesh, MeshConfig, \
    create_mesh
from procyon_tpu_torch.parallel.multihost import initialize_multihost
from procyon_tpu_torch.parallel.sharding import (
    Sharding, batch_sharding, gather_params, param_shardings, replicate,
    shard_batch, shard_params, spec_for)

__all__ = ["AXES", "Mesh", "MeshConfig", "Sharding", "batch_sharding",
           "create_mesh", "gather_params", "initialize_multihost",
           "param_shardings", "replicate", "shard_batch",
           "shard_params", "spec_for"]
