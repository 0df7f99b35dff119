"""Multi-process initialization (counterpart of
procyon_tpu/parallel/multihost.py).

The reference scales out with torchrun's c10d rendezvous and NCCL process
groups. `initialize_multihost` is the port's one entry: it reads
torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
MASTER_PORT) or the run_pretrain flags (--dist_coordinator host:port,
--dist_num_processes, --dist_process_id), as the JAX package reads
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, and starts
the default process group: NCCL when the ranks have cards, gloo on the
CPU. A plain process (no launcher variables, no flags, or one process) is
left alone and gets (0, 1); a process group that already exists (torchrun
code, a caller that made its own, two ranks sharing one card over gloo) is
used as it is.

Division of labor, as in the JAX package: every rank builds the same
global batch stream from the same seed and keeps its rows
(sharding.shard_batch); logging and checkpoint writes happen on rank 0.
"""

import os
from typing import Optional, Tuple


def _launched() -> bool:
    """torchrun (torch.distributed.run) sets these for every worker."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device: Optional[str] = None) -> Tuple[int, int]:
    """Start the default process group when a multi-process run is asked
    for; returns (rank, world size). `device` "cpu" or "cuda" picks the
    backend (gloo / NCCL) unless `backend` names one; by default NCCL when
    a card is present. Sets this rank's card from LOCAL_RANK."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    launched = _launched()
    if not num_processes or num_processes <= 1:
        num_processes = int(env["WORLD_SIZE"]) if launched else 1
    if num_processes == 1 and not (launched or coordinator_address):
        return 0, 1
    if process_id is None or process_id < 0:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None:
        if "MASTER_ADDR" not in env:
            raise ValueError(
                f"{num_processes} processes need a coordinator: pass "
                "--dist_coordinator host:port or run under torchrun")
        coordinator_address = f"{env['MASTER_ADDR']}:" \
                              f"{env.get('MASTER_PORT', '29500')}"
    use_cuda = (device or ("cuda" if torch.cuda.is_available()
                           else "cpu")) != "cpu"
    if use_cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or ("nccl" if use_cuda else "gloo"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()
