"""Device kernels a protein in the traced calls of an index cell: the
trace's kernel events (the profiler's lead kernels left out) over the
proteins of the traced calls."""


def read(ctx):
    proteins = sum(r["proteins"] for r in ctx.traced)
    return len(ctx.table.kernels) / proteins
