"""Fused LayerNorm -> int8 W1 -> GELU -> int8 W2 MLP (counterparts of
procyon_tpu/ops/fused_mlp.py::fused_ln_mlp_int8, ::ln_quant_rows_pallas and
::fused_mlp_int8_prequant).

Three wrappers, each with its plain PyTorch version beside it. On a CUDA
tensor a wrapper launches its hand-written kernel in
csrc/fused_ln_mlp_int8.cu (bf16 activations) or raises; on a CPU tensor it
runs the plain version; any other device raises.

  * `fused_ln_mlp_int8` (`fused_ln_mlp_int8_ref`): the one-pass MLP;
    `launches` counts its kernel.
  * `ln_quant_rows` (`ln_quant_rows_ref`): LayerNorm + per-row int8
    quantization, (xq int8 [M, d], sx f32 [M, 1]); `launches_ln_quant`.
  * `fused_mlp_int8_prequant` (`fused_mlp_int8_prequant_ref`): the
    two-pass form, `ln_quant_rows` then the MLP on the int8 rows; its
    requantization group comes from `prequant_group` (block_n from 512, not
    1024), and the residual is added after the output cast, in x's dtype
    (one rounding more than the one-pass form). `launches_prequant` counts
    the MLP kernel (the row pass counts in `launches_ln_quant`).

Numerics (both versions, as the TPU kernel): LayerNorm in f32, per-row int8
quantization of its output, s8 x s8 -> s32 with W1, `h1 = acc*(sx*s1)+b1`,
sigmoid-form GELU `0.5 h1 (1 + tanh(0.851 h1))`, requantization per
(row, G-column group), s8 x s8 -> s32 with W2, `acc2*(sg*s2)` summed in f32,
`+b2`, `+x` when add_residual. G is numerics, not tuning: `requant_group`
derives it from the reference's block_n / sub_tiles rule.
"""

import ctypes

import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.ops import _build

launches = 0
launches_ln_quant = 0
launches_prequant = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "fused_ln_mlp_int8_bf16": [_P] * 10 + [_I] * 5
    + [ctypes.c_float, _I, _P],
    "fused_ln_mlp_int8_smem": [_I, _I, _I],
    "fused_mlp_int8_prequant_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "fused_mlp_int8_prequant_smem": [_I, _I, _I, _I],
    "ln_quant_rows_bf16": [_P] * 5 + [_I, _I, ctypes.c_float, _P],
}


def requant_group(H: int) -> int:
    """Width of the hidden tile over which the GELU output shares one int8
    scale: block_n halves from min(1024, H) until it divides H, sub_tiles
    halves from 2 until block_n % (sub_tiles*128) == 0, G = block_n /
    sub_tiles (fused_mlp.py:311-316, 347-348)."""
    block_n = _block_n(H)
    sub_tiles = 2
    while block_n % (sub_tiles * 128):
        sub_tiles //= 2
    return block_n // max(sub_tiles, 1)


def _block_n(H: int) -> int:
    block_n = 1024
    if H % block_n:
        block_n = min(block_n, H)
        while H % block_n:
            block_n //= 2
    return block_n


def _prequant_block_n(H: int) -> int:
    block_n = 512
    while H % block_n:
        block_n //= 2
    return block_n


def prequant_group(H: int) -> int:
    """The requantization group of the two-pass form: block_n halves from
    512 until it divides H, then sub_tiles as in `requant_group` (the
    reference's fused_mlp.py:243-246). At H 10240 it is 256 where
    `requant_group` gives 512."""
    block_n = _prequant_block_n(H)
    sub_tiles = 2
    while sub_tiles and block_n % (sub_tiles * 128):
        sub_tiles //= 2
    if not sub_tiles:
        raise ValueError(f"the two-pass MLP needs H with a block_n of at "
                         f"least 128, got H={H}")
    return block_n // sub_tiles


def ln_quant_rows_ref(x, ln_w, ln_b, eps: float = 1e-5):
    """Plain PyTorch version of LayerNorm + per-row symmetric int8
    quantization (the reference's ln_quant_rows, fused_mlp.py:166-178):
    f32 statistics, h = cx * rsqrt(var + eps) * ln_w + ln_b,
    sx = max(amax, 1e-8) / 127, xq = clip(round_half_even(h / sx)).
    Returns (xq int8 [M, d], sx f32 [M, 1])."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    cx = xf - mean
    var = (cx * cx).mean(-1, keepdim=True)
    h = cx * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    amax = h.abs().amax(-1, keepdim=True)
    sx = amax.clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(h / sx).clamp(-127, 127).to(torch.int8)
    return xq, sx


def _mlp_on_codes(xq, sx, w1q, s1, b1, w2q, s2, b2, G, per_step):
    """The MLP from int8 rows: f32 [M, d] = sum over hidden groups of G of
    requantized GELU codes times W2, the groups of one block_n step
    (`per_step` of them) summed first, then into the accumulator, + b2."""
    M, d = xq.shape
    H = w1q.shape[1]
    s1 = s1.reshape(1, H).float()
    s2 = s2.reshape(1, d).float()
    b1 = b1.reshape(1, H).float()
    acc = torch.zeros((M, d), dtype=torch.float32, device=xq.device)
    total = None
    for j in range(H // G):
        sl = slice(j * G, (j + 1) * G)
        a1 = torch._int_mm(xq, w1q[:, sl].contiguous())
        h1 = a1.float() * (sx * s1[:, sl]) + b1[:, sl]
        g = 0.5 * h1 * (1.0 + torch.tanh(0.851 * h1))
        gmax = g.abs().amax(-1, keepdim=True)
        sg = gmax.clamp_min(1e-8) * (1.0 / 127.0)
        gq = torch.round(g / sg).clamp(-127, 127).to(torch.int8)
        a2 = torch._int_mm(gq, w2q[sl, :].contiguous())
        part = a2.float() * (sg * s2)
        total = part if total is None else total + part
        if (j + 1) % per_step == 0:
            acc = acc + total
            total = None
    return acc + b2.reshape(1, d).float()


def fused_ln_mlp_int8_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                          eps: float = 1e-5,
                          add_residual: bool = False) -> torch.Tensor:
    """Plain PyTorch version. x [M, d]; w1q int8 [d, H], s1 f32 [1, H];
    w2q int8 [H, d], s2 f32 [1, d]; b1 [H], b2 [d], ln_w/ln_b [d].
    Sums the per-group partials in the reference's order (the groups of one
    block_n step first, then into the accumulator)."""
    H = w1q.shape[1]
    G = requant_group(H)
    xq, sx = ln_quant_rows_ref(x, ln_w, ln_b, eps)
    out = _mlp_on_codes(xq, sx, w1q, s1, b1, w2q, s2, b2, G,
                        _block_n(H) // G)
    if add_residual:
        out = out + x.float()
    return out.to(x.dtype)


def fused_mlp_int8_prequant_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                                eps: float = 1e-5,
                                add_residual: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the two-pass form: `ln_quant_rows_ref`, the
    MLP with `prequant_group`'s G, the cast to x's dtype, then + x in that
    dtype when add_residual (the reference's fused_mlp.py:276-279)."""
    H = w1q.shape[1]
    G = prequant_group(H)
    xq, sx = ln_quant_rows_ref(x, ln_w, ln_b, eps)
    out = _mlp_on_codes(xq, sx, w1q, s1, b1, w2q, s2, b2, G,
                        _prequant_block_n(H) // G).to(x.dtype)
    return out + x if add_residual else out


def _f32_vectors(dev, *pairs):
    """Each (tensor, length) as a contiguous f32 vector on dev, or raise."""
    out = []
    for t, n in pairs:
        t = t.reshape(-1).float().contiguous()
        if t.numel() != n or t.device != dev:
            raise ValueError(f"vector of {t.numel()} on {t.device}, "
                             f"expected {n} on {dev}")
        out.append(t)
    return out


def row_block(kind: str, M: int, d: int, H: int) -> int:
    """Rows a block of the MLP kernel takes ("one_pass": fused_ln_mlp_int8,
    "two_pass": fused_mlp_int8_prequant's kernel): 32 or 16, the larger
    that divides M and whose block fits shared memory. Loads the kernel
    library (a CUDA machine's)."""
    lib = _build.load("fused_ln_mlp_int8", _SIG)
    if kind == "one_pass":
        def fits(b):
            return lib.fused_ln_mlp_int8_smem(b, d, requant_group(H)) > 0
    else:
        G = prequant_group(H)
        spg = _prequant_block_n(H) // G

        def fits(b):
            return lib.fused_mlp_int8_prequant_smem(b, d, G, spg) > 0
    bm = next((b for b in (32, 16) if M % b == 0 and fits(b)), None)
    if bm is None:
        raise ValueError(f"no row block fits: M={M}, d={d}, H={H} ({kind})")
    return bm


def _check_weights(x, w1q, w2q):
    d, H = x.shape[1], w1q.shape[1]
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8 \
            or w1q.shape != (d, H) or w2q.shape != (H, d):
        raise ValueError(f"int8 weights [d, H] / [H, d] expected, got "
                         f"{w1q.dtype} {tuple(w1q.shape)} / {w2q.dtype} "
                         f"{tuple(w2q.shape)}")
    if w1q.device != x.device or w2q.device != x.device:
        raise ValueError("weights and x on different devices")


def _launch(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps, add_residual):
    global launches
    M, d = x.shape
    H = w1q.shape[1]
    G = requant_group(H)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"fused MLP kernel takes contiguous bf16 x, got "
                        f"{x.dtype} contiguous={x.is_contiguous()}")
    _check_weights(x, w1q, w2q)
    if d % 64 or G not in (256, 512) or H % G:
        raise ValueError(f"fused MLP kernel needs d % 64 == 0 and a "
                         f"requantization group of 256 or 512: d={d}, H={H}, "
                         f"G={G}")
    dev = x.device
    lnw, lnb, s1f, b1f, s2f, b2f = _f32_vectors(
        dev, (ln_w, d), (ln_b, d), (s1, H), (b1, H), (s2, d), (b2, d))
    w1t, w2t = bridge.int8_k_major(w1q), bridge.int8_k_major(w2q)
    lib = _build.load("fused_ln_mlp_int8", _SIG)
    bm = row_block("one_pass", M, d, H)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_ln_mlp_int8_bf16(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1t.data_ptr(),
        s1f.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), s2f.data_ptr(),
        b2f.data_ptr(), out.data_ptr(), M, d, H, G, bm, eps,
        int(add_residual), stream)
    _build.check(err, "fused_ln_mlp_int8_bf16")
    launches += 1
    return out


def fused_ln_mlp_int8(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                      eps: float = 1e-5,
                      add_residual: bool = False) -> torch.Tensor:
    """x [M, d] -> LN -> int8 GELU MLP -> [M, d] (+ x when add_residual).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _build.refuse_grad("fused LN + int8 MLP", x, ln_w, ln_b, b1, b2)
    if x.is_cuda:
        return _launch(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps,
                       add_residual)
    if x.device.type != "cpu":
        raise ValueError(f"no fused MLP for device {x.device}")
    return fused_ln_mlp_int8_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2,
                                 eps=eps, add_residual=add_residual)


def _check_rows(x, what):
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise TypeError(f"{what} takes contiguous, 16-byte aligned bf16 "
                        f"[M, d], got {x.dtype} {tuple(x.shape)} "
                        f"contiguous={x.is_contiguous()}")


def _launch_ln_quant(x, ln_w, ln_b, eps):
    global launches_ln_quant
    _check_rows(x, "LN + row quantization kernel")
    M, d = x.shape
    if d % 8 or d > 6144:
        raise ValueError(f"LN + row quantization kernel needs d % 8 == 0 "
                         f"and d <= 6144, got d={d}")
    lnw, lnb = _f32_vectors(x.device, (ln_w, d), (ln_b, d))
    if lnw.data_ptr() % 16 or lnb.data_ptr() % 16:
        raise ValueError("LN + row quantization kernel reads the LayerNorm "
                         "weight and bias 16 bytes at a time: align them")
    xq = torch.empty((M, d), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    lib = _build.load("fused_ln_mlp_int8", _SIG)
    err = lib.ln_quant_rows_bf16(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), xq.data_ptr(),
        sx.data_ptr(), M, d, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ln_quant_rows_bf16")
    launches_ln_quant += 1
    return xq, sx


def ln_quant_rows(x, ln_w, ln_b, eps: float = 1e-5):
    """x [M, d] -> LayerNorm -> per-row int8: (xq int8 [M, d], sx f32
    [M, 1]). The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _build.refuse_grad("LN + row quantization", x, ln_w, ln_b)
    if x.is_cuda:
        return _launch_ln_quant(x, ln_w, ln_b, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no LN + row quantization for device {x.device}")
    return ln_quant_rows_ref(x, ln_w, ln_b, eps)


def _launch_prequant(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps,
                     add_residual):
    global launches_prequant
    _check_rows(x, "two-pass MLP kernel")
    _check_weights(x, w1q, w2q)
    M, d = x.shape
    H = w1q.shape[1]
    G = prequant_group(H)
    spg = _prequant_block_n(H) // G
    if d % 64 or (G, spg) not in ((256, 2), (128, 2), (128, 1)):
        raise ValueError(f"two-pass MLP kernel needs d % 64 == 0 and a "
                         f"group of 256 or 128: d={d}, H={H}, G={G}")
    dev = x.device
    s1f, b1f, s2f, b2f = _f32_vectors(dev, (s1, H), (b1, H), (s2, d),
                                      (b2, d))
    w1t, w2t = bridge.int8_k_major(w1q), bridge.int8_k_major(w2q)
    lib = _build.load("fused_ln_mlp_int8", _SIG)
    bm = row_block("two_pass", M, d, H)
    xq, sx = ln_quant_rows(x, ln_w, ln_b, eps)
    out = torch.empty_like(x)
    err = lib.fused_mlp_int8_prequant_bf16(
        xq.data_ptr(), sx.data_ptr(), w1t.data_ptr(), s1f.data_ptr(),
        b1f.data_ptr(), w2t.data_ptr(), s2f.data_ptr(), b2f.data_ptr(),
        out.data_ptr(), M, d, H, G, spg, bm,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_mlp_int8_prequant_bf16")
    launches_prequant += 1
    # after the cast, in bf16, as the reference adds it (fused_mlp.py:276)
    return out.add_(x) if add_residual else out


def fused_mlp_int8_prequant(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                            eps: float = 1e-5,
                            add_residual: bool = False) -> torch.Tensor:
    """x [M, d] -> `ln_quant_rows` -> int8 GELU MLP on the int8 rows ->
    [M, d] (+ x after the cast when add_residual). Two launches on a CUDA
    tensor (the row pass, then the MLP kernel); the plain version for CPU
    tensors."""
    _build.refuse_grad("two-pass int8 MLP", x, ln_w, ln_b, b1, b2)
    if x.is_cuda:
        return _launch_prequant(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2,
                                eps, add_residual)
    if x.device.type != "cpu":
        raise ValueError(f"no two-pass MLP for device {x.device}")
    return fused_mlp_int8_prequant_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2,
                                       b2, eps=eps, add_residual=add_residual)
