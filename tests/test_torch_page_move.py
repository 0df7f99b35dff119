"""ops/page_move of the port against procyon_tpu.ops.page_move on the same
numpy inputs: the plain version (which the wrapper takes for CPU tensors)
against the Pallas kernel in interpret mode. A page move copies bytes, so
the comparison is exact."""

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
