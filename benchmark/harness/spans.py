"""The traced window's idle time charged to the program's phases.

The program marks its phases with named host ranges
(procyon_tpu_torch/utils/profiling.span), which the profiler records beside
the kernels. Every microsecond of the window in which no device operation
runs is charged to the phase whose spans hold it on the host's timeline,
the first phase in a family's order where spans nest or overlap, and to
`outside` where no phase's span holds it. Spans are matched by name and by
interval, never by thread: the autograd engine runs a backward on a thread
of its own while the main thread waits inside its span.

A family's shares (each a % of the window) add up to the device's idle
share of the window. A trace without the family's own span (a program that
marks no phases) reads nothing.
"""

import weakref

INDEX = ("index.call", (
    ("prep", ("index.tokenize", "index.to_device")),
    ("rotary", ("esm2.rotary",)),
    ("to_host", ("index.to_host",)),
    # the launches of encode, pool, regroup and project
    ("encoder", ("index.call",)),
))
MLM = ("train.step", (
    ("to_device", ("train.to_device",)),
    # esm2.rotary runs inside the forward and is charged to it
    ("forward", ("train.forward",)),
    ("backward", ("train.backward",)),
    ("optimizer", ("train.optimizer", "train.step")),
))

# each family's shares of a table, once read (five metrics read them)
_SHARES = weakref.WeakKeyDictionary()


def merge(intervals):
    """Sorted disjoint (start, end) intervals covering the same points."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys):
    """The points in both of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys):
    """The points of merged list xs in no interval of merged list ys."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def length(xs):
    return sum(b - a for a, b in xs)


def idle(table):
    """Merged intervals (us) of the window in which no device operation
    runs."""
    busy = merge((e["ts"], e["ts"] + e.get("dur", 0)) for e in table._device)
    return subtract([(table._lo, table._hi)], busy)


def spans(table, names):
    """Merged host intervals (us) of the spans named in `names`."""
    return merge((e["ts"], e["ts"] + e.get("dur", 0)) for e in table._host
                 if e.get("name") in names)


def idle_shares(table, family):
    """{phase: % of the window idle in it, ..., "outside": ...} for a
    family (INDEX or MLM); None when the trace holds no span named by the
    family's first entry."""
    top, phases = family
    known = _SHARES.setdefault(table, {})
    if top in known:
        return known[top]
    out = None
    if spans(table, (top,)):
        window = table._hi - table._lo
        left, out = idle(table), {}
        for phase, names in phases:
            cover = spans(table, names)
            out[phase] = 100.0 * length(intersect(left, cover)) / window
            left = subtract(left, cover)
        out["outside"] = 100.0 * length(left) / window
    known[top] = out
    return out


def idle_share(ctx, family, phase):
    """One phase's share of a run's traced window, or None (no spans)."""
    shares = idle_shares(ctx.table, family)
    return None if shares is None else shares[phase]
