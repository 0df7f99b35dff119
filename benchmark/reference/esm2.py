"""Plain PyTorch reference of the ESM2 encoder, its protein embedding and its
masked-LM fine-tuning step.

Written for the benchmark from the published model (fair-esm's ESM2: pre-LN
blocks, rotary positions on q and k, exact GELU, the tied masked-LM head,
token-dropout rescaling) and the deployment the configuration files state
(mean pooling over the non-pad tokens, chunks of long proteins averaged,
a bias-free shared projector). It shares no code with the program: it
tokenizes, chunks, quantizes and optimizes by itself, from the sequences,
the masked batches and the raw weights the benchmark made.

Every product `linear` computes is f32 with TF32 off, after the inputs are
rounded to `precision`:
  * "f32": as they are;
  * "w8a8": int8 weights (symmetric, per output channel) and int8
    activations (symmetric, per row), the products exact;
  * "w4a8": int4 weights (per output channel) and int8 activations, the
    control one step below "w8a8";
  * "fp8": e4m3 weights (per output channel) and activations (per row), and
    under autograd e5m2 gradients into each product (per row), the control
    one step below bf16.
Attention, norms, GELU, pooling and the loss are f32.
"""

import math

import torch

PAD, CLS, EOS, MASK = 1, 0, 2, 32
# the ESM alphabet's residues, ids 4..23 in this order
RESIDUES = "LAGVSERTIDPKQNFYMHWC"
_RES_ID = {c: 4 + i for i, c in enumerate(RESIDUES)}
PRECISIONS = ("f32", "w8a8", "w4a8", "fp8")


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


def chunk_rows(seq, max_len):
    """The residue chunks of one protein, each as token ids with CLS and EOS:
    a protein longer than max_len is cut into pieces of max_len."""
    ids = [_RES_ID[c] for c in seq]
    return [[CLS] + ids[i:i + max_len] + [EOS]
            for i in range(0, max(len(ids), 1), max_len)]


def pad_rows(rows, device):
    """A [len(rows), longest] int64 tensor, right-padded with PAD."""
    width = max(len(r) for r in rows)
    out = torch.full((len(rows), width), PAD, dtype=torch.long)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.tensor(r, dtype=torch.long)
    return out.to(device)


# ---------------------------------------------------------------------------
# Products at a precision
# ---------------------------------------------------------------------------


def _round_int(x, qmax, dim):
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(x / s).clamp(-qmax, qmax), s


def _round_float(x, dtype, dim):
    top = torch.finfo(dtype).max
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / top
    return (x / s).to(dtype).float(), s


def prepare_weight(w, precision):
    """A weight [in, out] as the product reads it: (codes or values f32,
    per-column scale or None)."""
    w = w.float()
    if precision == "f32":
        return w, None
    if precision == "w8a8":
        return _round_int(w, 127, 0)
    if precision == "w4a8":
        return _round_int(w, 7, 0)
    if precision == "fp8":
        return _round_float(w, torch.float8_e4m3fn, 0)
    raise ValueError(f"unknown precision {precision!r}")


class _Product(torch.autograd.Function):
    """x @ (w * sw) with x rounded per row to the precision's activation
    type. The backward hands x the gradient of the unrounded product,
    after rounding the incoming gradient per row to e5m2 under "fp8" (the
    gradient type of fp8 training)."""

    @staticmethod
    def forward(ctx, x, w, sw, precision):
        if precision == "fp8":
            xq, sx = _round_float(x, torch.float8_e4m3fn, -1)
        else:
            xq, sx = _round_int(x, 127, -1)
        ctx.save_for_backward(w, sw)
        ctx.precision = precision
        return (xq @ w) * sx * sw

    @staticmethod
    def backward(ctx, g):
        w, sw = ctx.saved_tensors
        g = g * sw
        if ctx.precision == "fp8":
            gq, sg = _round_float(g, torch.float8_e5m2, -1)
            return (gq @ w.t()) * sg, None, None, None
        return g @ w.t(), None, None, None


def linear(x, pw, precision):
    """x [..., in] f32 times a prepared weight."""
    w, sw = pw
    if precision == "f32":
        return x @ w
    return _Product.apply(x, w, sw, precision)


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------


def layer_norm(x, p, eps):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], p["w"].float(), p["b"].float(), eps)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="none")


def rotary(head_dim, S, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, device=device,
                                          dtype=torch.float32) / head_dim))
    f = torch.outer(torch.arange(S, device=device, dtype=torch.float32), inv)
    emb = torch.cat([f, f], -1)
    return emb.cos(), emb.sin()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], -1) * sin


def layer_weights(layers, i, precision):
    """Layer i of the stacked raw tree, its products prepared."""
    a, m = layers["attn"], layers["mlp"]
    out = {n: prepare_weight(a[n][i], precision)
           for n in ("wq", "wk", "wv", "wo")}
    out.update({n: prepare_weight(m[n][i], precision) for n in ("w1", "w2")})
    out.update({n: a[n][i].float() for n in ("bq", "bk", "bv", "bo")})
    out.update({n: m[n][i].float() for n in ("b1", "b2")})
    out["attn_norm"] = {k: v[i] for k, v in layers["attn_norm"].items()}
    out["mlp_norm"] = {k: v[i] for k, v in layers["mlp_norm"].items()}
    return out


def _lora_delta(x, bank, i, expert, scaling):
    if bank is None:
        return 0.0
    return scaling * ((x @ bank["A"][i, expert].float())
                      @ bank["B"][i, expert].float())


def block(x, valid, lw, dims, precision, lora=None, i=0):
    """One pre-LN block on x [B, S, d] f32; valid [B, S] bool (keys that
    may be attended). lora: {"banks": {name: {A, B}}, "expert", "scaling"}
    adds each bank's delta to its projection."""
    B, S, d = x.shape
    H, D = dims["heads"], dims["head_dim"]
    banks = lora["banks"] if lora else {}

    def proj(name, inp):
        out = linear(inp, lw[name], precision)
        if name in banks:
            out = out + _lora_delta(inp, banks[name], i, lora["expert"],
                                    lora["scaling"])
        return out

    h = layer_norm(x, lw["attn_norm"], dims["eps"])
    q, k, v = (
        (proj(n, h) + lw["b" + n[1:]]).reshape(B, S, H, D).transpose(1, 2)
        for n in ("wq", "wk", "wv"))
    cos, sin = rotary(D, S, x.device)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, S, H * D)
    x = x + proj("wo", o) + lw["bo"]
    h = layer_norm(x, lw["mlp_norm"], dims["eps"])
    h = gelu(proj("w1", h) + lw["b1"])
    return x + proj("w2", h) + lw["b2"]


def embed(params, tokens, dims):
    """Token embeddings with ESM2's token-dropout rescale: <mask> rows
    zeroed, the rest scaled by (1 - 0.15 * 0.8) / (1 - the row's share of
    <mask> among its non-pad tokens)."""
    x = params["embed"].float()[tokens]
    valid = tokens != PAD
    is_mask = tokens == MASK
    x = x.masked_fill(is_mask[..., None], 0.0)
    ratio = is_mask.sum(-1).float() / valid.sum(-1).clamp_min(1).float()
    return x * ((1 - 0.15 * 0.8) / (1 - ratio))[:, None, None]


@torch.no_grad()
def encode_rows(params, dims, rows, precision, *, device, block_rows=8):
    """Last hidden states, mean-pooled over each row's tokens (CLS and EOS
    included), for token rows (lists of ids): [len(rows), d] f32. Rows go
    in blocks of `block_rows`, each padded to its longest; the layers run
    one at a time over every block, so each layer's weights are prepared
    once."""
    order = sorted(range(len(rows)), key=lambda r: len(rows[r]))
    blocks = [order[i:i + block_rows]
              for i in range(0, len(order), block_rows)]
    toks = [pad_rows([rows[r] for r in b], device) for b in blocks]
    xs = [embed(params, t, dims) for t in toks]
    layers = params["layers"]
    for i in range(dims["layers"]):
        lw = layer_weights(layers, i, precision)
        xs = [block(x, t != PAD, lw, dims, precision)
              for x, t in zip(xs, toks)]
    out = torch.empty((len(rows), dims["dim"]), device=device)
    for b, x, t in zip(blocks, xs, toks):
        x = layer_norm(x, params["final_norm"], dims["eps"])
        m = (t != PAD).float()[..., None]
        out[b] = (x * m).sum(1) / m.sum(1)
    return out


@torch.no_grad()
def protein_embeddings(params, projector, dims, seqs, max_len, precision, *,
                       device):
    """Shared-space embeddings [len(seqs), out] f32: each protein's chunks
    encoded and mean-pooled, the chunks averaged, then the projector."""
    rows, owner = [], []
    for p, s in enumerate(seqs):
        for r in chunk_rows(s, max_len):
            rows.append(r)
            owner.append(p)
    pooled = encode_rows(params, dims, rows, precision, device=device)
    owner = torch.tensor(owner, device=device)
    sums = torch.zeros((len(seqs), dims["dim"]), device=device)
    sums.index_add_(0, owner, pooled)
    counts = torch.bincount(owner, minlength=len(seqs)).float()[:, None]
    return linear(sums / counts, prepare_weight(projector, "f32"), "f32")


# ---------------------------------------------------------------------------
# Masked-LM fine-tuning of LoRA banks
# ---------------------------------------------------------------------------


def mlm_loss(params, banks, dims, tokens, labels, precision, *, expert,
             scaling):
    """Mean cross-entropy over the positions whose label is not -100; the
    banks' expert `expert` adds its delta to every projection it covers.
    Each layer is checkpointed, so only its input is kept."""
    x = embed(params, tokens, dims)
    valid = tokens != PAD
    layers = params["layers"]
    lora = {"banks": banks, "expert": expert, "scaling": scaling}

    def run(x, i):
        lw = layer_weights(layers, i, precision)
        return block(x, valid, lw, dims, precision, lora=lora, i=i)

    for i in range(dims["layers"]):
        x = torch.utils.checkpoint.checkpoint(run, x, i, use_reentrant=False)
    x = layer_norm(x, params["final_norm"], dims["eps"])
    lm = params["lm_head"]
    h = gelu(linear(x, prepare_weight(lm["dense_w"], precision), precision)
             + lm["dense_b"].float())
    h = layer_norm(h, lm["norm"], dims["eps"])
    logits = linear(h, prepare_weight(params["embed"].t(), precision),
                    precision) + lm["bias"].float()
    sel = labels != -100
    return torch.nn.functional.cross_entropy(logits[sel], labels[sel])


class AdamW:
    """AdamW with optax's semantics: the schedule read at the count before
    the update (a linear warm-up from 0, then a cosine decay to
    min_lr_ratio of the base), the group clipped by its global norm, the
    moments bias-corrected, eps outside the square root, the weight decay
    added before the lr scaling. f32 throughout; `moments` and `params`,
    where given, are the dtypes the moments and the params are rounded to
    after each update, as a state kept in them between steps is."""

    def __init__(self, lr, warmup_steps, total_steps, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=1e-3, clip=1.0, min_lr_ratio=0.1,
                 moments=None, params=None):
        self.lr, self.warmup, self.total = lr, warmup_steps, total_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd, self.clip, self.min_ratio = weight_decay, clip, min_lr_ratio
        self.kept = {"moments": moments, "params": params}
        self.count = 0
        self.mu = self.nu = None

    def rate(self, count):
        if count < self.warmup:
            return self.lr * count / self.warmup
        steps = max(self.total - self.warmup, 1)
        c = min(count - self.warmup, steps)
        cos = 0.5 * (1 + math.cos(math.pi * c / steps))
        return self.lr * ((1 - self.min_ratio) * cos + self.min_ratio)

    @torch.no_grad()
    def step(self, params, grads):
        """Updates params in place; returns the clipped gradients."""
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        f = torch.where(norm < self.clip, 1.0, self.clip / norm)
        grads = [g * f for g in grads]
        lr = self.rate(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g.square())
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p
            p.sub_(lr * u)
            for t, dtype in ((mu, self.kept["moments"]),
                             (nu, self.kept["moments"]),
                             (p, self.kept["params"])):
                if dtype is not None:
                    t.copy_(t.to(dtype))
        return grads


def train_steps(params, banks, dims, batches, precision, *, expert, scaling,
                optimizer):
    """The fine-tuning steps over `batches` ((tokens, labels) on the
    device): the banks in f32 trained, everything else frozen. Returns
    {"losses", "grads": each step's clipped gradients by leaf name,
    "banks": the banks after the steps}."""
    names = sorted((n, k) for n in banks for k in ("A", "B"))
    leaves = [banks[n][k].float().clone() for n, k in names]
    out = {"losses": [], "grads": []}
    for tokens, labels in batches:
        for t in leaves:
            t.requires_grad_(True)
        live = {n: {} for n in banks}
        for (n, k), t in zip(names, leaves):
            live[n][k] = t
        loss = mlm_loss(params, live, dims, tokens, labels, precision,
                        expert=expert, scaling=scaling)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        clipped = optimizer.step(leaves, list(grads))
        out["losses"].append(float(loss.detach()))
        out["grads"].append({f"{n}/{k}": g for (n, k), g in zip(names,
                                                                 clipped)})
    out["banks"] = {f"{n}/{k}": t for (n, k), t in zip(names, leaves)}
    return out
