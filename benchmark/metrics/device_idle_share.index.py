"""Share of the traced window in which no operation ran on the card, in an
index cell: 1 - busy / window, from the trace."""


def read(ctx):
    return 100.0 * (1.0 - ctx.table.busy_s / ctx.table.window_s)
