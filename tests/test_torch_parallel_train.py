"""Data parallelism, FSDP and tensor-parallel training on gloo over 4 (or
2) spawned CPU processes, held to the JAX package's single-device step
(computed here under jax.jit; tests/test_multichip.py holds that equal to
the JAX sharded step): the QA step on every listed mesh, the retrieval
step's global contrastive batch, uneven supervised tokens a rank (a mean
of the ranks' means is shown to fail), and the QLoRA joint step on an int8
base with conflict ids. Losses and metrics within 1e-4, the updated
leaves within 1e-5 (test_multichip.py's bounds), and the gradients (the
first moments, (1 - b1) g) within torch_train_common.GRAD_SHARE of each
leaf's largest, the train-step files' bound against JAX. AdamW's
first update is lr * g / (|g| + 1e-8): where |g| < 1e-6 it follows the
gradient's last bits, so those elements (0 < |g| < 1e-6) are held by the
gradient check only (test_multichip.py holds final_norm alone)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procyon_tpu.models import unified as juni
from procyon_tpu.training import train_step as jts
from procyon_tpu.training.combined_step import make_combined_step
from procyon_tpu.training.optimizer import OptimizerConfig, build_optimizer
from procyon_tpu_torch import bridge
from procyon_tpu_torch.models import unified as tuni
from tests.test_unified import make_batch
from torch_dist_common import run_ranks
from torch_train_common import (GRAD_SHARE, flat, jax_batch, make_setup,
                                states)

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant")
LOSS_ATOL = 1e-4
LEAF_ATOL = 1e-5
TINY_GRAD = 1e-6
MESHES = [(4, 1, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2)]


def _np_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """test_multichip.py's setup: the tiny fusion model in frozen-table
    mode, B 8, one step a task on one device."""
    rng = np.random.default_rng(0)
    cfg = juni.tiny_config(esm=None, protein_embed_dim=16)
    params = juni.init_params(jax.random.PRNGKey(0), cfg)
    batch = _np_batch(make_batch(cfg, rng, B=8, L=16, U=4))
    uneven = dict(batch, labels=batch["labels"].copy())
    uneven["labels"][2:, 4:14] = -100     # rows 0-1: 12 tokens, the rest 2
    opt = build_optimizer(OptimizerConfig(**OPT), params)
    out = {"params": bridge.to_torch(bridge.to_numpy(params)),
           "cfg": tuni.tiny_config(esm=None, protein_embed_dim=16),
           "batch": batch, "uneven_batch": uneven}
    for name, task, b in (("qa", "qa", batch),
                          ("retrieval", "retrieval", batch),
                          ("uneven", "qa", uneven)):
        step = jts.make_train_step(cfg, opt, task, donate=False)
        state, m = step(jts.init_train_state(params, opt),
                        {k: jnp.asarray(v) for k, v in b.items()})
        out[name] = _summary(state, m)
    return out


def _summary(jstate, metrics):
    """Metrics, updated params and first moments of a JAX step."""
    t = bridge.train_state_to_torch(jstate)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": bridge.to_numpy(t["params"]),
            "mu": bridge.to_numpy(t["opt_state"]["mu"])}


def _check(got, want, what):
    for k, v in want["metrics"].items():
        tol = LOSS_ATOL * max(1.0, abs(v))
        assert abs(got["metrics"][k] - v) <= tol, (what, k,
                                                    got["metrics"][k], v)
    gp = dict(flat(got["params"]))
    wm = dict(flat(want["mu"]))
    for path, w in flat(want["params"]):
        w = np.asarray(w)
        g = np.abs(wm[path]) if path in wm else np.zeros(w.shape)
        held = (g >= 0.1 * TINY_GRAD) | (g == 0)
        assert held.mean() > 0.5, (what, path, held.mean())
        np.testing.assert_allclose(gp[path][held], w[held], atol=LEAF_ATOL,
                                   rtol=LEAF_ATOL, err_msg=f"{what} {path}")
    gm = dict(flat(got["mu"]))
    n = 0
    for path, w in flat(want["mu"]):
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(gm[path] - w).max())
        assert err <= GRAD_SHARE * scale, (what, path, err, scale)
        n += 1
    assert n >= 3, n


def _run(ref, tmp_path, mesh, task, batch, **kw):
    world = int(np.prod(mesh))
    res = run_ranks("train_step", world, tmp_path, dict(
        cfg=ref["cfg"], params=ref["params"], batch=batch, mesh=mesh,
        opt=OPT, task=task, **kw))
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"], "ranks disagree"
    return res[0]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_qa_step_matches_jax(ref, tmp_path, mesh):
    got = _run(ref, tmp_path, mesh, "qa", ref["batch"])
    _check(got, ref["qa"], f"qa {mesh}")


@pytest.mark.parametrize("mesh", [(4, 1, 1), (2, 2, 1), (1, 2, 2)])
def test_retrieval_global_batch_matches_jax(ref, tmp_path, mesh):
    """Each rank scores its rows against the gathered columns: the
    in-batch InfoNCE of the global batch, the JAX single-device one."""
    got = _run(ref, tmp_path, mesh, "retrieval", ref["batch"])
    _check(got, ref["retrieval"], f"retrieval {mesh}")


@pytest.mark.parametrize("fault", [None, "mean_of_means"])
def test_uneven_tokens_global_mean(ref, tmp_path, fault):
    """Rows with 12 supervised tokens on rank 0 and 2 on the others: the
    global mean over tokens is the JAX loss; the mean of the ranks' means
    is not, and the same check catches it."""
    got = _run(ref, tmp_path, (4, 1, 1), "qa", ref["uneven_batch"],
               fault=[fault] if fault else [])
    want = ref["uneven"]["metrics"]["lm_loss"]
    err = abs(got["metrics"]["lm_loss"] - want)
    if fault is None:
        assert err <= LOSS_ATOL, err
        _check(got, ref["uneven"], "uneven")
    else:
        assert err > 100 * LOSS_ATOL, err


@pytest.fixture(scope="module")
def qlora():
    """torch_train_common's setup: collator batches (qa, retrieval with
    conflict ids), an int8 base with LoRA r4 x 4, and the JAX joint step
    (expert 3, frozen base)."""
    jcfg, tcfg, params, batches = make_setup()
    jstate, tstate, jo, _ = states(jcfg, params, "qlora")
    step = make_combined_step(jcfg, jo, donate=False, expert_override=3,
                              frozen_base=True)
    new, m = step(jstate, {t: jax_batch(batches[t])
                           for t in ("qa", "retrieval")})
    return dict(cfg=tcfg, want=_summary(new, m),
                whole=bridge.merge_params(tstate["params"],
                                          tstate["frozen"]),
                batches={t: {k: v for k, v in batches[t].items()
                             if k != "reference_indices"}
                         for t in ("qa", "retrieval")})


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 2, 1)])
def test_qlora_joint_step_matches_jax(qlora, tmp_path, mesh):
    """The combined QA + retrieval step on an int8 frozen base (the QLoRA
    recipe) on 2 ranks: the rows split, the int8 leaves replicated, the
    LoRA banks sharded by fsdp, the contrastive batch global with
    conflict ids; held to JAX's one-device step (the train-step files'
    leaf bound)."""
    res = run_ranks("train_step", 2, tmp_path, dict(
        cfg=qlora["cfg"], params=qlora["whole"], batch=qlora["batches"],
        mesh=mesh, task="combined", qlora=True, expert=3,
        opt=dict(lr=1e-3, projector_lr=2e-3, warmup_steps=1,
                 total_steps=8, schedule="cosine", grad_clip=1.0)))
    assert res[0]["metrics"] == res[1]["metrics"]
    _check(res[0], qlora["want"], f"qlora {mesh}")
