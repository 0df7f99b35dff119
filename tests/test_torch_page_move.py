"""ops/page_move of the port against procyon_tpu.ops.page_move on the same
numpy inputs: the plain versions (which the wrappers take for CPU tensors)
of the direct move and of the staged move against the Pallas kernels in
interpret mode. A page move copies bytes, so the comparison is exact.

The staged move's plans hold a swap, a 3-cycle, a chain (a row that is a
source and a destination) and repeated sources. Interpret mode runs the
reference's grid in order, so these cases cannot tell a chain-unsafe
kernel from a safe one: the card-only tests and chip_smoke.py do that."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import page_move as jpm
from procyon_tpu_torch import bridge
from procyon_tpu_torch.ops import page_move as tpm


def _moves(rng, n_rows, n_moves):
    """Distinct destinations; sources that repeat and are no destination."""
    perm = rng.permutation(n_rows)
    dst = perm[:n_moves].astype(np.int32)
    src = rng.choice(perm[n_moves:], n_moves).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("dtype,tail", [
    ("bfloat16", (8, 128)),    # bf16 pages
    ("int8", (8, 128)),        # int8 pages
    ("float32", (8, 4)),       # an int8 pool's f32 scale slabs
])
def test_plain_version_matches_pallas_interpret(dtype, tail):
    rng = np.random.default_rng(len(dtype))
    N, M = 24, 9
    vals = rng.integers(-100, 100, (N, *tail))
    jpool = jnp.asarray(vals, getattr(jnp, dtype))
    src, dst = _moves(rng, N, M)
    assert len(set(src)) < M                      # a source repeats
    want = np.asarray(jpm.move_pages_direct(
        jpool, jnp.asarray(src), jnp.asarray(dst), interpret=True))
    pool = bridge.to_torch(np.asarray(jpool))
    before = pool.clone()
    n0 = tpm.launches
    got = tpm.move_pages_direct(pool, torch.from_numpy(src),
                                torch.from_numpy(dst))
    assert got is pool and tpm.launches == n0     # in place, no kernel here
    np.testing.assert_array_equal(bridge.to_numpy(got),
                                  want.astype(np.float32)
                                  if dtype == "bfloat16" else want)
    untouched = np.setdiff1d(np.arange(N), dst)
    assert torch.equal(got[untouched], before[untouched])
    assert torch.equal(got[dst.astype(np.int64)], before[src.astype(np.int64)])


def test_plain_version_checks_the_page_plan():
    """The direct move is right only on disjoint sets: the plain version
    raises where a plan breaks that, so every CPU beam test checks it."""
    pool = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 2, 2)
    t = lambda *a: torch.tensor(a, dtype=torch.int32)
    with pytest.raises(ValueError, match="also a destination"):
        tpm.move_pages_direct(pool, t(0, 1), t(1, 2))
    with pytest.raises(ValueError, match="repeats"):
        tpm.move_pages_direct(pool, t(0, 1), t(3, 3))
    with pytest.raises(ValueError, match="outside"):
        tpm.move_pages_direct(pool, t(0), t(6))
    with pytest.raises(ValueError, match="alike"):
        tpm.move_pages_direct(pool, t(0, 1), t(2))
    assert tpm.move_pages_direct(pool, t(), t()) is pool
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError, ValueError)):
            tpm.move_pages_direct(pool.to("meta"), t().to("meta"),
                                  t().to("meta"))


def _staged_moves(rng, n_rows):
    """Distinct destinations; sources with a swap (0 <-> 1), a 3-cycle
    (2 -> 3 -> 4 -> 2), a chain (5 -> 6 -> 7: row 6 is both) and rows that
    repeat (8 twice, 9 three times, 10 a source and a destination)."""
    p = rng.permutation(n_rows)
    pairs = [(p[0], p[1]), (p[1], p[0]),
             (p[2], p[3]), (p[3], p[4]), (p[4], p[2]),
             (p[5], p[6]), (p[6], p[7]),
             (p[8], p[11]), (p[8], p[12]), (p[9], p[13]), (p[9], p[14]),
             (p[9], p[10]), (p[10], p[15])]
    order = rng.permutation(len(pairs))
    src = np.array([pairs[i][0] for i in order], np.int32)
    dst = np.array([pairs[i][1] for i in order], np.int32)
    return src, dst


@pytest.mark.parametrize("dtype,tail", [
    ("bfloat16", (8, 128)),
    ("int8", (8, 128)),
    ("float32", (8, 4)),
])
def test_staged_move_matches_pallas_interpret(dtype, tail):
    rng = np.random.default_rng(7 + len(dtype))
    N = 24
    vals = rng.integers(-100, 100, (N, *tail))
    jpool = jnp.asarray(vals, getattr(jnp, dtype))
    src, dst = _staged_moves(rng, N)
    assert np.isin(src, dst).any() and len(set(src)) < len(src)
    want = np.asarray(jpm.move_pages(
        jpool, jnp.asarray(src), jnp.asarray(dst), interpret=True))
    pool = bridge.to_torch(np.asarray(jpool))
    before = pool.clone()
    n0 = tpm.launches_staged
    got = tpm.move_pages(pool, torch.from_numpy(src), torch.from_numpy(dst))
    assert got is pool and tpm.launches_staged == n0
    np.testing.assert_array_equal(bridge.to_numpy(got),
                                  want.astype(np.float32)
                                  if dtype == "bfloat16" else want)
    # every destination holds the OLD source row, the rest is untouched
    assert torch.equal(got[dst.astype(np.int64)],
                       before[src.astype(np.int64)])
    untouched = np.setdiff1d(np.arange(N), dst)
    assert torch.equal(got[untouched], before[untouched])


def test_staged_plain_version_checks_only_what_it_needs():
    """Overlap is the staged move's case, so its plain version takes it;
    a destination that repeats or a row out of range still raises."""
    pool = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 2, 2)
    before = pool.clone()
    t = lambda *a: torch.tensor(a, dtype=torch.int32)
    tpm.move_pages_ref(pool, t(0, 1, 2), t(1, 2, 0))
    assert torch.equal(pool[t(1, 2, 0).long()], before[t(0, 1, 2).long()])
    with pytest.raises(ValueError, match="repeats"):
        tpm.move_pages_ref(pool, t(0, 1), t(3, 3))
    with pytest.raises(ValueError, match="outside"):
        tpm.move_pages_ref(pool, t(-1), t(2))
    with pytest.raises(ValueError, match="alike"):
        tpm.move_pages(pool, t(0, 1), t(2))
    assert tpm.move_pages(pool, t(), t()) is pool
    with pytest.raises(ValueError, match="device"):
        tpm.move_pages(pool.to("meta"), t(0).to("meta"), t(1).to("meta"))


def _plan_cases(rng, n_rows):
    """(name, src, dst): the mixed plan above with 64 destinations moved
    among themselves, no overlap at all, and every source a destination."""
    src, dst = _staged_moves(rng, n_rows)
    p = rng.permutation(np.setdiff1d(np.arange(n_rows), np.union1d(src, dst)))
    perm = p[:64][rng.permutation(64)]
    mixed = (np.concatenate([src, perm]).astype(np.int32),
             np.concatenate([dst, p[:64]]).astype(np.int32))
    q = rng.permutation(n_rows)
    disjoint = (rng.choice(q[:20], 30).astype(np.int32),
                q[20:50].astype(np.int32))
    every = (q[:40].astype(np.int32), q[:40][rng.permutation(40)].astype(
        np.int32))
    return [("mixed", *mixed), ("disjoint", *disjoint), ("every", *every)]


def _apply_plan(pool, src, dst, plan, order):
    """The staged move through plain code, one move at a time in `order`:
    the staged rows copied aside first, then each move from its staged
    copy or from the pool as it stands."""
    staged, slot = plan
    copies = pool[staged].clone()
    for i in order:
        pool[dst[i]] = copies[slot[i]] if slot[i] >= 0 else pool[src[i]]
    return pool


@pytest.mark.parametrize("case", ["mixed", "disjoint", "every"])
def test_staging_plan_stages_what_is_overwritten(case):
    """`staging_plan` stages exactly the sources that some move overwrites
    (a swap, a 3-cycle, a chain, 64 permuted destinations and repeated
    sources; none without overlap; all where every source is a
    destination), and the plan applied move by move, in order, reversed
    and shuffled, equals move_pages_ref and the reference's staged move in
    interpret mode."""
    rng = np.random.default_rng(11)
    N = 160
    name, src, dst = next(c for c in _plan_cases(rng, N) if c[0] == case)
    staged, slot = tpm.staging_plan(torch.from_numpy(src),
                                    torch.from_numpy(dst), N)
    want_rows = np.intersect1d(src, dst)
    np.testing.assert_array_equal(staged.numpy(), want_rows)
    assert {"mixed": 71, "disjoint": 0, "every": 40}[name] == len(want_rows)
    s = slot.numpy()
    np.testing.assert_array_equal(s >= 0, np.isin(src, dst))
    np.testing.assert_array_equal(staged.numpy()[s[s >= 0]], src[s >= 0])
    vals = rng.integers(-100, 100, (N, 8, 4))
    jpool = jnp.asarray(vals, jnp.float32)
    want = np.asarray(jpm.move_pages(jpool, jnp.asarray(src),
                                     jnp.asarray(dst), interpret=True))
    ref = tpm.move_pages_ref(torch.from_numpy(vals).float(),
                             torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(ref.numpy(), want)
    M = len(src)
    for order in (range(M), range(M - 1, -1, -1), rng.permutation(M)):
        got = _apply_plan(torch.from_numpy(vals).float(), src, dst,
                          (staged, slot), order)
        np.testing.assert_array_equal(got.numpy(), want)
