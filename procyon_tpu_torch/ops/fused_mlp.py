"""Fused int8 MLPs (counterparts of procyon_tpu/ops/fused_mlp.py::
fused_ln_mlp_int8, ::ln_quant_rows_pallas, ::fused_mlp_int8_prequant and
::fused_rms_swiglu_int8).

Four wrappers, each with its plain PyTorch version beside it. On a CUDA
tensor a wrapper launches its hand-written kernels in
csrc/fused_ln_mlp_int8.cu or csrc/fused_rms_swiglu_int8.cu (bf16
activations) or raises; on a CPU tensor it runs the plain version; any
other device raises.

  * `fused_ln_mlp_int8` (`fused_ln_mlp_int8_ref`): the one-pass MLP, three
    kernels on a CUDA tensor (the row pass, the s8 wgmma up product with
    GELU and requantization, the s8 wgmma down product); `launches` counts
    calls that launched them.
  * `ln_quant_rows` (`ln_quant_rows_ref`): LayerNorm + per-row int8
    quantization, (xq int8 [M, d], sx f32 [M, 1]); `launches_ln_quant`.
  * `fused_mlp_int8_prequant` (`fused_mlp_int8_prequant_ref`): the
    two-pass form, `ln_quant_rows` then the MLP on the int8 rows (the up
    and down kernels); its requantization group comes from
    `prequant_group` (block_n from 512, not 1024), and the residual is
    added after the output cast, in x's dtype (one rounding more than the
    one-pass form). `launches_prequant` counts the MLP's launches (the row
    pass counts in `launches_ln_quant`).
  * `fused_rms_swiglu_int8` (`fused_rms_swiglu_int8_ref`): the Llama W8A8
    MLP with its residual, `x + W8A8-SwiGLU(rms_norm(x))`, for the prefill;
    its requantization group comes from `swiglu_group`. On a CUDA tensor
    the row pass, then the s8 wgmma gate / up and down kernels, which read
    the weights K-major: [in, out] views of [out, in] storage without a
    copy (`SWIGLU_WEIGHT_LAYOUT`). `launches_swiglu` counts calls that
    launched its three kernels.

Numerics (both versions, as the TPU kernel): LayerNorm in f32, per-row int8
quantization of its output, s8 x s8 -> s32 with W1, `h1 = acc*(sx*s1)+b1`,
sigmoid-form GELU `0.5 h1 (1 + tanh(0.851 h1))`, requantization per
(row, G-column group), s8 x s8 -> s32 with W2, `acc2*(sg*s2)` summed in f32,
`+b2`, `+x` when add_residual. G is numerics, not tuning: `requant_group`
derives it from the reference's block_n / sub_tiles rule. The plain
version runs in the kernels' stages: `ln_quant_rows_ref`, `gelu_codes_ref`
(the hidden codes and their scales), `mlp_down_ref`.
"""

import ctypes

import torch

from procyon_tpu_torch import bridge
from procyon_tpu_torch.ops import _build, quant

launches = 0
launches_ln_quant = 0
launches_prequant = 0
launches_swiglu = 0
# the weight layout `fused_rms_swiglu_int8` reads without a copy: [in, out]
# views of [out, in] storage ("out_in", what bridge.int8_k_major leaves as
# it is); a contiguous [in, out] weight is transposed at every call
SWIGLU_WEIGHT_LAYOUT = "out_in"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "fused_ln_mlp_int8_bf16": [_P] * 14 + [_I] * 5
    + [ctypes.c_float, _I, _P],
    "fused_mlp_int8_prequant_bf16": [_P] * 11 + [_I] * 5 + [_P],
    "ln_quant_rows_bf16": [_P] * 5 + [_I, _I, ctypes.c_float, _P],
}
_SWIGLU_SIG = {"fused_rms_swiglu_int8_bf16": [_P] * 13 + [_I] * 5
               + [ctypes.c_float, _P]}


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


def gelu_codes_ref(xq, sx, w1q, s1, b1, G):
    """The hidden codes, the up kernel's stage: h1 = (xq W1) * (sx * s1) +
    b1, the sigmoid-form GELU, per (row, G columns) sg = max(amax, 1e-8) /
    127 and gq = clip(round_half_even(g / sg)). Returns (gq int8 [M, H], sg
    f32 [M, H / G])."""
    H = w1q.shape[1]
    s1 = s1.reshape(1, H).float()
    b1 = b1.reshape(1, H).float()
    codes, scales = [], []
    for j in range(H // G):
        sl = slice(j * G, (j + 1) * G)
        a1 = torch._int_mm(xq, w1q[:, sl].contiguous())
        h1 = a1.float() * (sx * s1[:, sl]) + b1[:, sl]
        g = 0.5 * h1 * (1.0 + torch.tanh(0.851 * h1))
        gmax = g.abs().amax(-1, keepdim=True)
        sg = gmax.clamp_min(1e-8) * (1.0 / 127.0)
        codes.append(torch.round(g / sg).clamp(-127, 127).to(torch.int8))
        scales.append(sg)
    return torch.cat(codes, 1), torch.cat(scales, 1)


def mlp_down_ref(gq, sg, w2q, s2, b2, G, per_step):
    """The down kernel's stage: f32 [M, d] = sum over hidden groups of G of
    (gq W2) * (sg * s2), the groups of one block_n step (`per_step` of
    them) summed first, then into the accumulator, + b2."""
    M, H = gq.shape
    d = w2q.shape[1]
    s2 = s2.reshape(1, d).float()
    acc = torch.zeros((M, d), dtype=torch.float32, device=gq.device)
    total = None
    for j in range(H // G):
        sl = slice(j * G, (j + 1) * G)
        a2 = torch._int_mm(gq[:, sl].contiguous(), w2q[sl, :].contiguous())
        part = a2.float() * (sg[:, j:j + 1] * s2)
        total = part if total is None else total + part
        if (j + 1) % per_step == 0:
            acc = acc + total
            total = None
    return acc + b2.reshape(1, d).float()


def _mlp_on_codes(xq, sx, w1q, s1, b1, w2q, s2, b2, G, per_step):
    """The MLP from int8 rows: `gelu_codes_ref`, then `mlp_down_ref`."""
    gq, sg = gelu_codes_ref(xq, sx, w1q, s1, b1, G)
    return mlp_down_ref(gq, sg, w2q, s2, b2, G, per_step)


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
    """Each (tensor, length) as a contiguous, 16-byte aligned f32 vector on
    dev, or raise."""
    out = []
    for t, n in pairs:
        t = t.reshape(-1).float().contiguous()
        if t.numel() != n or t.device != dev:
            raise ValueError(f"vector of {t.numel()} on {t.device}, "
                             f"expected {n} on {dev}")
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


# the up kernel's block tile (rows, columns: one requantization group) by
# group; the down kernel's is (128, 128) for every group
UP_TILES = {512: (64, 512), 256: (128, 256), 128: (128, 128)}
DOWN_TILE = (128, 128)
_KERNEL_GROUPS = {"one_pass": (256, 512), "two_pass": (128, 256)}


def kernel_shape(kind: str, M: int, d: int, H: int):
    """(G, per_step): the requantization group and the groups a block_n
    step sums first, for the kernels of `kind` ("one_pass":
    fused_ln_mlp_int8, "two_pass": fused_mlp_int8_prequant) at M rows,
    width d and hidden width H; a ValueError for a shape they do not take:
    d a multiple of 64 up to 6144 (the row pass holds a row in registers),
    a group of 256 or 512 (one pass) or 128 or 256 (two passes), M >= 1.
    Any M: rows beyond a tile are zero-filled and never stored."""
    if kind == "one_pass":
        G = requant_group(H)
        per_step = _block_n(H) // G
    else:
        G = prequant_group(H)
        per_step = _prequant_block_n(H) // G
    if M < 1 or d % 64 or not 0 < d <= 6144 \
            or G not in _KERNEL_GROUPS[kind] or H % (G * per_step):
        raise ValueError(
            f"the int8 MLP kernels ({kind}) take M >= 1, d a multiple of 64 "
            f"up to 6144 and a requantization group in "
            f"{_KERNEL_GROUPS[kind]}: M={M}, d={d}, H={H}, G={G}")
    return G, per_step


def _check_weights(x, w1q, w2q):
    d, H = x.shape[1], w1q.shape[1]
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8 \
            or w1q.shape != (d, H) or w2q.shape != (H, d):
        raise ValueError(f"int8 weights [d, H] / [H, d] expected, got "
                         f"{w1q.dtype} {tuple(w1q.shape)} / {w2q.dtype} "
                         f"{tuple(w2q.shape)}")
    if w1q.device != x.device or w2q.device != x.device:
        raise ValueError("weights and x on different devices")


def _check_rows(x, what):
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise TypeError(f"{what} takes contiguous, 16-byte aligned bf16 "
                        f"[M, d], got {x.dtype} {tuple(x.shape)} "
                        f"contiguous={x.is_contiguous()}")


def _launch_mlp(kind, x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, eps,
                add_residual):
    """The kernels of `kind` on x: (out, (xq, sx, gq, sg)), the output and
    the int8 rows, hidden codes and their scales the kernels passed between
    them, for a check against the plain version's stages. The two-pass
    form's out has no residual yet."""
    global launches, launches_prequant
    _check_rows(x, f"int8 MLP kernels ({kind})")
    _check_weights(x, w1q, w2q)
    M, d = x.shape
    H = w1q.shape[1]
    G, per_step = kernel_shape(kind, M, d, H)
    dev = x.device
    s1f, b1f, s2f, b2f = _f32_vectors(dev, (s1, H), (b1, H), (s2, d),
                                      (b2, d))
    w1t, w2t = bridge.int8_k_major(w1q), bridge.int8_k_major(w2q)
    gq = torch.empty((M, H), dtype=torch.int8, device=dev)
    sg = torch.empty((M, H // G), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _build.load("fused_ln_mlp_int8", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind == "one_pass":
        lnw, lnb = _f32_vectors(dev, (ln_w, d), (ln_b, d))
        xq = torch.empty((M, d), dtype=torch.int8, device=dev)
        sx = torch.empty((M, 1), dtype=torch.float32, device=dev)
        err = lib.fused_ln_mlp_int8_bf16(
            x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1t.data_ptr(),
            s1f.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), s2f.data_ptr(),
            b2f.data_ptr(), xq.data_ptr(), sx.data_ptr(), gq.data_ptr(),
            sg.data_ptr(), out.data_ptr(), M, d, H, G, per_step, eps,
            int(add_residual), stream)
        _build.check(err, "fused_ln_mlp_int8_bf16")
        launches += 1
    else:
        xq, sx = ln_quant_rows(x, ln_w, ln_b, eps)
        err = lib.fused_mlp_int8_prequant_bf16(
            xq.data_ptr(), sx.data_ptr(), w1t.data_ptr(), s1f.data_ptr(),
            b1f.data_ptr(), w2t.data_ptr(), s2f.data_ptr(), b2f.data_ptr(),
            gq.data_ptr(), sg.data_ptr(), out.data_ptr(), M, d, H, G,
            per_step, stream)
        _build.check(err, "fused_mlp_int8_prequant_bf16")
        launches_prequant += 1
    return out, (xq, sx, gq, sg)


def fused_ln_mlp_int8(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                      eps: float = 1e-5,
                      add_residual: bool = False) -> torch.Tensor:
    """x [M, d] -> LN -> int8 GELU MLP -> [M, d] (+ x when add_residual).
    The CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    _build.refuse_grad("fused LN + int8 MLP", x, ln_w, ln_b, b1, b2)
    if x.is_cuda:
        return _launch_mlp("one_pass", x, ln_w, ln_b, w1q, s1, b1, w2q, s2,
                           b2, eps, add_residual)[0]
    if x.device.type != "cpu":
        raise ValueError(f"no fused MLP for device {x.device}")
    return fused_ln_mlp_int8_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2,
                                 eps=eps, add_residual=add_residual)


def _launch_ln_quant(x, ln_w, ln_b, eps):
    global launches_ln_quant
    _check_rows(x, "LN + row quantization kernel")
    M, d = x.shape
    if d % 8 or d > 6144:
        raise ValueError(f"LN + row quantization kernel needs d % 8 == 0 "
                         f"and d <= 6144, got d={d}")
    lnw, lnb = _f32_vectors(x.device, (ln_w, d), (ln_b, d))
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


def fused_mlp_int8_prequant(x, ln_w, ln_b, w1q, s1, b1, w2q, s2, b2, *,
                            eps: float = 1e-5,
                            add_residual: bool = False) -> torch.Tensor:
    """x [M, d] -> `ln_quant_rows` -> int8 GELU MLP on the int8 rows ->
    [M, d] (+ x after the cast when add_residual). On a CUDA tensor the row
    pass, then the up and down kernels; the plain version for CPU
    tensors."""
    _build.refuse_grad("two-pass int8 MLP", x, ln_w, ln_b, b1, b2)
    if x.is_cuda:
        out = _launch_mlp("two_pass", x, ln_w, ln_b, w1q, s1, b1, w2q, s2,
                          b2, eps, add_residual)[0]
        # after the cast, in bf16, as the reference adds it
        # (fused_mlp.py:276)
        return out.add_(x) if add_residual else out
    if x.device.type != "cpu":
        raise ValueError(f"no two-pass MLP for device {x.device}")
    return fused_mlp_int8_prequant_ref(x, ln_w, ln_b, w1q, s1, b1, w2q, s2,
                                       b2, eps=eps, add_residual=add_residual)


# ---------------------------------------------------------------------------
# RMSNorm -> W8A8 SwiGLU MLP -> residual (the Llama prefill's MLP)
# ---------------------------------------------------------------------------


def _swiglu_tiles(d: int, H: int, block_n: int = 512, sub_tiles: int = 2):
    """The reference wrapper's (block_n, sub_tiles) rule
    (fused_mlp.py:489-504): block_n capped at 256 from d 4096 on, at H,
    then halved until it divides H; sub_tiles halved until block_n %
    (sub_tiles * 128) == 0."""
    if d >= 4096:
        block_n = min(block_n, 256)
    block_n = min(block_n, H)
    while H % block_n:
        block_n //= 2
    while sub_tiles > 1 and block_n % (sub_tiles * 128):
        sub_tiles //= 2
    return block_n, sub_tiles


def swiglu_group(d: int, H: int, block_n: int = 512,
                 sub_tiles: int = 2) -> int:
    """Columns of the SwiGLU output that share one int8 scale a row:
    block_n / sub_tiles of `_swiglu_tiles`. 128 at d 4096 (H 11008 or
    14336), 256 at d 2560 H 10240, 384 at d 128 H 384."""
    block_n, sub_tiles = _swiglu_tiles(d, H, block_n, sub_tiles)
    return block_n // sub_tiles


def rms_quant_rows_ref(x, nw, eps: float = 1e-5):
    """RMSNorm in f32, never rounded to x's dtype, and per-row int8:
    h = (x * (1 / sqrt(mean(x^2) + eps))) * nw, sx = max(amax, 1e-8) / 127,
    xq = clip(round_half_even(h / sx)). Returns (xq int8 [M, d], sx f32
    [M, 1])."""
    xf = x.float()
    ms = (xf * xf).sum(-1, keepdim=True) / xf.shape[-1]
    return quant.quantize_rows(
        xf * (1.0 / torch.sqrt(ms + eps)) * nw.reshape(1, -1).float())


def swiglu_codes_ref(xq, sx, wgq, sg, wuq, su, G: int):
    """The int8 SiLU(g) * u codes [M, H] and their scales [M, H / G]:
    g = acc * (sx * sg), u = acc * (sx * su), a = (g * sigmoid(g)) * u with
    sigmoid = 1 / (1 + exp(-g)), requantized per (row, G columns)."""
    M = xq.shape[0]
    H = wgq.shape[1]
    sg = sg.reshape(1, H).float()
    su = su.reshape(1, H).float()
    codes, scales = [], []
    for j in range(H // G):
        sl = slice(j * G, (j + 1) * G)
        g = quant.int_mm(xq, wgq[:, sl]).float() * (sx * sg[:, sl])
        u = quant.int_mm(xq, wuq[:, sl]).float() * (sx * su[:, sl])
        aq, sa = quant.quantize_rows(g * (1.0 / (1.0 + torch.exp(-g))) * u)
        codes.append(aq)
        scales.append(sa)
    return torch.cat(codes, 1), torch.cat(scales, 1).reshape(M, -1)


def swiglu_down_ref(aq, sa, wdq, sd, x, G: int, spg: int):
    """x + the down product in x's dtype: each group's int32 sum times
    (sa * sd) in f32, the `spg` groups of one block_n step summed first,
    then into the accumulator; the residual added in f32 before the cast."""
    M, H = aq.shape
    d = wdq.shape[1]
    sd = sd.reshape(1, d).float()
    acc = torch.zeros((M, d), dtype=torch.float32, device=aq.device)
    total = None
    for j in range(H // G):
        sl = slice(j * G, (j + 1) * G)
        part = quant.int_mm(aq[:, sl].contiguous(), wdq[sl, :]).float() \
            * (sa[:, j:j + 1] * sd)
        total = part if total is None else total + part
        if (j + 1) % spg == 0:
            acc = acc + total
            total = None
    return (acc + x.float()).to(x.dtype)


def fused_rms_swiglu_int8_ref(x, nw, wgq, sg, wuq, su, wdq, sd, *,
                              eps: float = 1e-5, block_n: int = 512,
                              sub_tiles: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the reference's _kernel_swiglu: x [M, d],
    nw [d], int8 wgq / wuq [d, H] and wdq [H, d] ([in, out]), f32 scales sg /
    su [1, H] and sd [1, d]. Returns x + MLP in x's dtype."""
    d, H = wgq.shape
    block_n, sub_tiles = _swiglu_tiles(d, H, block_n, sub_tiles)
    G = block_n // sub_tiles
    xq, sx = rms_quant_rows_ref(x, nw, eps)
    aq, sa = swiglu_codes_ref(xq, sx, wgq, sg, wuq, su, G)
    return swiglu_down_ref(aq, sa, wdq, sd, x, G, sub_tiles)


def _launch_swiglu(x, nw, wgq, sg, wuq, su, wdq, sd, eps, block_n,
                   sub_tiles):
    """(out, (xq, sx, aq, sa)): the output and the int8 codes and scales
    the kernels passed between them, for a check against the plain
    version's stages."""
    global launches_swiglu
    _check_rows(x, "RMSNorm + W8A8 SwiGLU kernel")
    M, d = x.shape
    H = wgq.shape[1]
    for w, shape in ((wgq, (d, H)), (wuq, (d, H)), (wdq, (H, d))):
        if w.dtype != torch.int8 or tuple(w.shape) != shape:
            raise ValueError(f"int8 weights [d, H] / [H, d] expected, got "
                             f"{w.dtype} {tuple(w.shape)} against {shape}")
        if w.device != x.device:
            raise ValueError("weights and x on different devices")
    # K-major, as s8 wgmma reads B: no copy for [in, out] views of
    # [out, in] storage (SWIGLU_WEIGHT_LAYOUT), a transposed copy else
    wgt, wut, wdt = (bridge.int8_k_major(w) for w in (wgq, wuq, wdq))
    if any(w.data_ptr() % 16 for w in (wgt, wut, wdt)):
        raise ValueError("the RMSNorm + W8A8 SwiGLU kernels read the "
                         "weights through TMA: 16-byte aligned storage "
                         "needed")
    block_n, sub_tiles = _swiglu_tiles(d, H, block_n, sub_tiles)
    G = block_n // sub_tiles
    if d % 128 or H % 128 or G % 128 or G > 512:
        raise ValueError(f"RMSNorm + W8A8 SwiGLU kernel needs d and H "
                         f"multiples of 128 and a group of at most 512: "
                         f"d={d}, H={H}, G={G}")
    dev = x.device
    nwf, sgf, suf, sdf = _f32_vectors(dev, (nw, d), (sg, H), (su, H),
                                      (sd, d))
    xq = torch.empty((M, d), dtype=torch.int8, device=dev)
    sx = torch.empty((M,), dtype=torch.float32, device=dev)
    aq = torch.empty((M, H), dtype=torch.int8, device=dev)
    sa = torch.empty((M, H // G), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _build.load("fused_rms_swiglu_int8", _SWIGLU_SIG)
    err = lib.fused_rms_swiglu_int8_bf16(
        x.data_ptr(), nwf.data_ptr(), wgt.data_ptr(), sgf.data_ptr(),
        wut.data_ptr(), suf.data_ptr(), wdt.data_ptr(), sdf.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), aq.data_ptr(), sa.data_ptr(),
        out.data_ptr(), M, d, H, G, sub_tiles, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_rms_swiglu_int8_bf16")
    launches_swiglu += 1
    return out, (xq, sx, aq, sa)


def fused_rms_swiglu_int8(x, nw, wgq, sg, wuq, su, wdq, sd, *,
                          eps: float = 1e-5, block_n: int = 512,
                          sub_tiles: int = 2) -> torch.Tensor:
    """x [M, d] -> x + W8A8-SwiGLU(rms_norm(x)), the reference's signature
    (without its TPU block_m): block_n and sub_tiles only set the
    requantization group (`swiglu_group`). The CUDA kernels (three launches:
    the row pass, the s8 wgmma gate / up and down products) for CUDA
    tensors, the plain version for CPU tensors. The int8 weights are
    [in, out]; the kernels read them K-major, so [in, out] views of
    [out, in] storage (`w.t().contiguous().t()`, SWIGLU_WEIGHT_LAYOUT) go
    in without a copy, and contiguous [in, out] weights are transposed at
    every call. Either layout gives the same bits."""
    _build.refuse_grad("RMSNorm + W8A8 SwiGLU", x, nw, sg, su, sd)
    if x.is_cuda:
        return _launch_swiglu(x, nw, wgq, sg, wuq, su, wdq, sd, eps,
                              block_n, sub_tiles)[0]
    if x.device.type != "cpu":
        raise ValueError(f"no RMSNorm + W8A8 SwiGLU for device {x.device}")
    return fused_rms_swiglu_int8_ref(x, nw, wgq, sg, wuq, su, wdq, sd,
                                     eps=eps, block_n=block_n,
                                     sub_tiles=sub_tiles)
