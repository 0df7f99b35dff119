"""The collectives GSPMD inserts for the JAX package, written out
(torch.distributed; no JAX counterpart).

Every helper takes a process group (a Mesh's `group(axis)`) and does
nothing when it is None, so a one-rank run takes the code path it had
before the mesh existed.

  * all_gather_dim / all_gather_batch: tensors gathered along a dim; the
    batch gather is differentiable (its backward sums the ranks'
    gradients and keeps this rank's block: a reduce-scatter), for the
    global contrastive batch;
  * Megatron's pairs for tensor parallelism: `copy_to` (identity forward,
    all-reduce backward) before a column-split product, `reduce_from`
    (all-reduce forward, identity backward) after a row-split one,
    `split_to` (keep this rank's columns; all-gather backward) and
    `gather_from` (all-gather; keep this rank's columns backward);
  * gradient reduction: `reduce_grad` sums a replicated leaf's gradient
    over the batch ranks and reduce-scatters an fsdp-sharded one;
  * `global_mean`: a loss or metric that is a mean over the global batch.
"""

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place on a copy (x itself is untouched)."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in group-rank order."""
    if group is None:
        return x
    n = size(group)
    xt = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _local_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = size(group)
    width = x.shape[dim] // n
    return x.narrow(dim, rank(group) * width, width).contiguous()


def reduce_scatter_dim(x: torch.Tensor, group, dim: int = 0):
    """Sum over the group, keeping this rank's block of `dim`."""
    if group is None:
        return x
    n = size(group)
    xt = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, 0), None


def all_gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """Rows of every rank, differentiable: rank r's rows are the block
    [r * n_local, (r + 1) * n_local)."""
    if group is None:
        return x
    return _GatherBatch.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _local_block(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, -1), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return _local_block(g, ctx.group, -1), None


def copy_to(x, group):
    """Identity forward, the gradient summed over the group backward: the
    input of a column-split product."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The partial products of a row-split product summed over the group
    (identity backward)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def split_to(x, group):
    """This rank's block of the last dim of a replicated tensor (its
    gradient gathered backward)."""
    return x if group is None else _SplitTo.apply(x, group)


def gather_from(x, group):
    """The ranks' blocks of the last dim concatenated (this rank's block
    of the gradient kept backward)."""
    return x if group is None else _GatherFrom.apply(x, group)


def reduce_grad(g: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A leaf's gradient summed over the batch ranks: reduce-scattered over
    fsdp along the dim its spec shards (then summed over data), or summed
    over data x fsdp for a leaf that fsdp does not shard. The losses are
    each rank's share of the global mean, so the sum is the global
    gradient. `model` needs nothing: a column / row split leaf's gradient
    is its own, and a replicated one's is the same on every model rank."""
    if mesh is None:
        return g
    if "fsdp" in spec and mesh.group("fsdp") is not None:
        g = reduce_scatter_dim(g, mesh.group("fsdp"), spec.index("fsdp"))
        return all_reduce(g, mesh.group("data"))
    return all_reduce(g, mesh.group("batch"))


class _ValueOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_mean(total: torch.Tensor, count: torch.Tensor, group):
    """total / count over the global batch, from this rank's total and
    count: its value is the global mean (the same on every rank), its
    gradient that of this rank's share, total / global count, so that the
    ranks' gradients sum to the global mean's. With no group,
    total / max(count, 1)."""
    if group is None:
        return total / count.clamp_min(1)
    n = all_reduce(count.detach(), group).clamp_min(1)
    share = total / n
    return _ValueOf.apply(share, all_reduce(share.detach(), group))
