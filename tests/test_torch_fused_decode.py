"""procyon_tpu_torch's fused int8 decode MLP (ops/fused_decode: the plain
version of the CUDA kernels in csrc/fused_decode_mlp.cu) against the
reference's Pallas probe kernel `fused_decode_mlp` of
scripts/probe_fused_decode.py in interpret mode under jax.jit, in f32 on
the same numpy inputs, at 1, 8 and 16 rows (d 128, I 512: two of the
reference's 256-column blocks). The reference is loaded by its path: the
port never imports it.

Tolerance: 1e-5 of the output's largest magnitude. Both sides compute the
same f32 function; only the order of the f32 sums over d and over I
differs (the reference adds its I blocks in turn, the plain version sums
in one product).

Also: the kernels' grid plan (k slices of each launch) fills the card at
Llama-3-8B's and the Bind decoder's widths and stays within what the
kernels take at small widths; the wrapper takes the plain version for CPU
tensors and launches nothing; other devices raise; the port's probe
script runs its three routes on the CPU.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procyon_tpu.ops import quant as jquant
from procyon_tpu_torch.ops import fused_decode as tfd
from procyon_tpu_torch.scripts import probe_fused_decode as tprobe
from torch_cpu_common import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
D, I = 128, 512
RTOL_OF_MAX = 1e-5


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "reference_probe_fused_decode",
        REPO / "scripts" / "probe_fused_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(rng, M):
    x = rng.standard_normal((M, D)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    def leaf(rows, cols):
        q = jquant.quantize(jnp.asarray(
            rng.standard_normal((rows, cols)).astype(np.float32)
            / np.sqrt(rows)))
        return {"q": np.array(q["q"]), "s": np.array(q["s"])}

    return x, nw, leaf(D, I), leaf(D, I), leaf(I, D)


def _torch(args):
    return [({k: torch.from_numpy(v) for k, v in a.items()}
             if isinstance(a, dict) else torch.from_numpy(a)) for a in args]


def _jax(args):
    return [({k: jnp.asarray(v) for k, v in a.items()}
             if isinstance(a, dict) else jnp.asarray(a)) for a in args]


@pytest.mark.parametrize("M", [1, 8, 16])
def test_plain_version_matches_pallas_interpret(jprobe, M):
    args = _inputs(np.random.default_rng(M), M)
    want = np.asarray(jax.jit(functools.partial(
        jprobe.fused_decode_mlp, interpret=True))(*_jax(args)))
    got = tfd.fused_decode_mlp_ref(*_torch(args)).numpy()
    scale = np.abs(want).max()
    assert scale > 1.0
    # the MLP's own part is of the order of x: the check sees it
    assert np.abs(want - args[0]).max() > 0.1 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_MAX * scale)


def _plan_blocks(d, I):
    gu, dn = tfd.plan(d, I)
    return (I // tfd.COL_TILE) * gu, (d // tfd.COL_TILE) * dn


@pytest.mark.parametrize("d,I", [(4096, 14336), (8192, 28672)])
def test_plan_fills_the_card_within_what_the_kernel_takes(d, I):
    """At Llama-3-8B's MLP (and Llama-3-70B's), both launches give every
    SM a block and stay within two blocks an SM (what the kernels' shared
    memory allows at once), with slices that divide the k range into whole
    ring stages, at most 16 (the largest cluster)."""
    for blocks, slices, k in zip(_plan_blocks(d, I), tfd.plan(d, I),
                                 (d, I)):
        assert tfd._build.SMS <= blocks <= tfd.BLOCKS_PER_SM * tfd._build.SMS
        assert 1 <= slices <= tfd.MAX_SLICES
        assert (k // tfd.STAGE_ROWS) % slices == 0


@pytest.mark.parametrize("d,I", [(128, 512), (256, 1024), (128, 256),
                                 (384, 768), (1024, 2816), (4096, 11008)])
def test_plan_stays_within_what_the_kernel_takes(d, I):
    """Small shapes (the card tests' d 128 / I 512 and d 256 / I 1024) and
    the Bind decoder's (its down launch: 32 column tiles, 172 stages, whose
    divisors up to 16 are 1, 2 and 4): where the column tiles times the
    even slices cannot fill 132 SMs, the plan takes the most even slices
    there are, and never slices that do not divide the stages."""
    for blocks, slices, k, n in zip(_plan_blocks(d, I), tfd.plan(d, I),
                                    (d, I), (I, d)):
        stages = k // tfd.STAGE_ROWS
        assert 1 <= slices <= min(tfd.MAX_SLICES, stages)
        assert stages % slices == 0
        if blocks < tfd._build.SMS:
            assert slices == max(s for s in range(1, tfd.MAX_SLICES + 1)
                                 if stages % s == 0)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _torch(_inputs(np.random.default_rng(3), 8))
    before = tfd.launches
    out = tfd.fused_decode_mlp(*args)
    assert tfd.launches == before
    assert torch.equal(out, tfd.fused_decode_mlp_ref(*args))
    # bf16 on the CPU: the same function in the working dtype
    xb = args[0].to(torch.bfloat16)
    outb = tfd.fused_decode_mlp(xb, *args[1:])
    assert outb.dtype == torch.bfloat16
    np.testing.assert_allclose(outb.float().numpy(), out.numpy(),
                               atol=0.05 * out.abs().max().item())


def test_wrapper_refuses_other_devices():
    x = torch.empty((4, D), device="meta")
    leaf = {"q": torch.empty((D, I), dtype=torch.int8, device="meta"),
            "s": torch.empty((1, I), device="meta")}
    with pytest.raises(ValueError, match="device"):
        tfd.fused_decode_mlp(x, torch.empty(D, device="meta"), leaf, leaf,
                             {"q": leaf["q"].t(), "s": leaf["s"]})


def test_port_probe_runs_its_routes_on_the_cpu(capsys):
    res = tprobe.main(["--device", "cpu", "--dim", str(D), "--inter",
                       str(I), "--layers", "3", "--m", "4"])
    assert res["finite"] and res["kernel_us"] is None
    # f32 on the CPU: the plain version and the int8 route are one function
    assert res["max_abs_diff"] <= 1e-4 * res["ref_max"]
    assert res["bf16_max_abs_diff"] <= 1e-4 * res["ref_max"]
    assert abs(res["floor_us"] - 3 * D * I / 3.35e12 * 1e6) < 1e-9
    assert "not measured" in capsys.readouterr().out
