"""Masked-LM fine-tuning of the encoder's MoLoRA banks: the program's
`training/train_step.make_train_step(cfg, optimizer, "mlm",
frozen_base=True)` on batches of the mix's proteins, a closed loop of one
trainer.

Set-up builds one train state (the frozen bf16 base, the banks trained by
the program's AdamW) and drives it through units 0 .. setup_steps - 1 by
the window's own call and feed; the window goes on from there with the same
object. Every unit's batch is generator.mlm_batch(mix, seed, i), so no two
steps see the same rows. Set-up keeps what the check compares: each
set-up step's loss, the first gradient as the optimizer took it (its first
moment after one step over 1 - b1, as the moment's dtype rounds b1), and
the banks before the first step and after the last set-up step.

The check runs the plain reference through the same set-up steps in f32
from the raw weights drawn again. Each bank leaf [L, E, ...] is compared
one expert slot at a time, so a step that trains the wrong slot shows. It
compares the first gradient's norm by the worst slot and the change of the
slots over the set-up steps by the median slot (a slot's gap of the two
norms over the larger of the reference's norm of the slot and of the median
trained slot). The change is taken by the median slot because the worst
slot's swings from seed to seed: an A slot whose one gradient (B is zero
through step 1) lies within a few of Adam's eps takes a step that follows
the gradient's size, so its change reads the precision of the bf16 step
(`look` gives the readings). A slot whose reference gradient is zero in
every step (another task's expert) or stays under GRAD_FLOOR of the median
trained slot's moves by weight decay or round-off alone, and is left out of
the change. The steps' losses are kept beside them (`detail`) and not
compared: the control's and the faults' loss gaps lie among sound runs'.
"""

import gc

import numpy as np
import torch

from benchmark.models import esm2 as model
from benchmark.reference import esm2 as ref
from benchmark.traffic import generator

GRAD_FLOOR = 1e-3
FAULTS = ("stale_state", "half_batch", "token_altered", "wrong_expert")
CONTROL = "fp8"


def bank_leaves(tree):
    """{"lora_wq/A": tensor, ...} of an encoder tree or a moment tree."""
    layers = tree["esm"]["layers"] if "esm" in tree else tree["layers"]
    return {f"{n}/{k}": t for n in sorted(layers) if n.startswith("lora_")
            for k, t in sorted(layers[n].items())}


def by_expert(leaves, prefix=""):
    """{"wq/A/e2": slot 2 of leaf "wq/A"} of bank leaves [L, E, ...] keyed
    `prefix` + name."""
    return {f"{n[len(prefix):]}/e{e}": t[:, e] for n, t in leaves.items()
            for e in range(t.shape[1])}


def norms(slots):
    return {n: float(t.float().norm()) for n, t in slots.items()}


class Program:

    def __init__(self, cell, seed, device, fault=None):
        from procyon_tpu_torch.models import llama, unified
        from procyon_tpu_torch.training import optimizer as topt
        from procyon_tpu_torch.training import train_step as ts
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no fault {fault!r} for this driver")
        self.cell, self.seed, self.device, self.fault = cell, seed, device, \
            fault
        self.mix, cfg = cell.traffic, cell.config
        self.ts = ts
        dtype = torch.bfloat16 if device != "cpu" else torch.float32
        lora = self.mix["lora"]
        esm_cfg = model.port_esm_config(cfg, dtype=dtype, lora=lora,
                                        remat=True)
        # make_train_step reads the decoder's LoRA config (none here) to
        # size the expert cycle; no decoder weights are made
        self.ucfg = unified.UnifiedConfig(
            llama=llama.tiny_config(), esm=esm_cfg, dtype=dtype)
        raw = model.raw_weights(cfg, seed, device, lora=lora)
        if dtype != torch.bfloat16:
            raw = model.cast_tree(raw, dtype)
        opt = self.mix["optimizer"]
        self.optimizer = topt.build_optimizer(topt.OptimizerConfig(
            lr=opt["lr"], warmup_steps=opt["warmup_steps"],
            total_steps=opt["total_steps"]))
        self.b1_kept = float(torch.tensor(1 - self.optimizer.cfg.b1,
                                          dtype=dtype))
        self.start = {k: v.detach().float().clone()
                      for k, v in bank_leaves(raw).items()}
        self.state = ts.init_train_state(
            {"esm": raw}, self.optimizer,
            trainable_predicate=ts.lora_trainable_predicate)
        del raw
        self.step = ts.make_train_step(self.ucfg, self.optimizer,
                                       self.mix["task"], frozen_base=True)
        self.first_grad = None
        self.setup_losses = []
        for i in range(self.mix["setup_steps"]):
            self.setup_losses.append(self.unit(i)["loss"])
            if i == 0:
                mu = bank_leaves(self.state["opt_state"]["mu"])
                self.first_grad = {k: v.float() / self.b1_kept
                                   for k, v in mu.items()}
        self.after = {k: v.detach().float().clone()
                      for k, v in bank_leaves(self.state["params"]).items()}
        # for `look`: the A slots' first moment after the set-up steps, when
        # it holds only the last step's gradient (B is zero before step 1)
        e = self.mix["expert"]
        self.a_moment = {
            k: v[:, e].float().clone() for k, v in
            bank_leaves(self.state["opt_state"]["mu"]).items()
            if k.endswith("/A")}

    @property
    def first_unit(self):
        return self.mix["setup_steps"]

    def batch(self, i):
        """(the batch the program is fed, the batch as generated)."""
        made = generator.mlm_batch(self.mix, self.seed, i)
        b = dict(made)
        if self.fault == "half_batch":
            b = {k: v[:len(v) // 2] for k, v in b.items()}
        if self.fault == "token_altered":
            t = b["protein_tokens"]
            b["protein_tokens"] = np.where((t >= 4) & (t < 24),
                                           4 + (t - 4 + 1) % 20, t)
        return b, made

    def unit(self, i):
        host, made = self.batch(i)
        b = self.ts.batch_to_device(host, self.device)
        if self.fault == "stale_state":
            keep = {k: v.clone() for k, v in
                    bank_leaves(self.state["params"]).items()}
            mu = {k: v.clone() for k, v in
                  bank_leaves(self.state["opt_state"]["mu"]).items()}
        if self.fault == "wrong_expert":
            self.swap_experts()
        self.state, m = self.step(self.state, b)
        if self.fault == "wrong_expert":
            self.swap_experts()
        loss = float(m["loss"])
        if self.fault == "stale_state":
            for k, v in bank_leaves(self.state["params"]).items():
                v.copy_(keep[k])
            for k, v in bank_leaves(self.state["opt_state"]["mu"]).items():
                v.copy_(mu[k])
        toks = made["protein_tokens"]
        rows = (toks != generator.PAD).sum(1)
        return {"loss": loss, "rows": [int(r) for r in rows],
                "width": int(toks.shape[1]),
                "residues": int((rows - 2).sum())}

    def swap_experts(self):
        """Swaps the task's expert slot with the next one in the banks and
        their moments: a step between two swaps trains the wrong slot."""
        e = self.mix["expert"]
        o = (e + 1) % self.mix["lora"]["experts"]
        for tree in (self.state["params"], self.state["opt_state"]["mu"],
                     self.state["opt_state"]["nu"]):
            for t in bank_leaves(tree).values():
                keep = t[:, e].clone()
                t[:, e].copy_(t[:, o])
                t[:, o].copy_(keep)

    def attempted(self, records):
        bad = sum(int(not np.isfinite(r["loss"])) for r in records)
        return len(records), bad

    def end_to_end(self, records, seconds):
        return {"mlm_residues_per_s": sum(r["residues"] for r in records)
                / seconds}

    def release(self):
        self.state = None
        self.step = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def reference(self, precision, kept=None):
        cfg, mix = self.cell.config, self.mix
        lora = mix["lora"]
        raw = model.raw_weights(cfg, self.seed, self.device, lora=lora)
        banks = {n[len("lora_"):]: raw["layers"].pop(n)
                 for n in list(raw["layers"]) if n.startswith("lora_")}
        batches = []
        for i in range(mix["setup_steps"]):
            b = generator.mlm_batch(mix, self.seed, i)
            batches.append(tuple(torch.from_numpy(b[k]).long().to(
                self.device) for k in ("protein_tokens", "mlm_labels")))
        opt = mix["optimizer"]
        ref.no_tf32()
        return ref.train_steps(
            raw, banks, model.dims(cfg), batches, precision,
            expert=mix["expert"], scaling=lora["alpha"] / lora["rank"],
            optimizer=ref.AdamW(opt["lr"], opt["warmup_steps"],
                                opt["total_steps"], **(kept or {})))

    def compare(self, losses, first_grad, after, truth):
        """[(name, value)] of the numbers compared, the program's readings
        against the reference's, slot by slot. The losses go into `detail`
        only: no control or fault moves their gap past what sound runs
        read."""
        steps = [norms(by_expert(g)) for g in truth["grads"]]
        g_ref, g_got = steps[0], norms(by_expert(first_grad, "lora_"))
        top = {n: max(s[n] for s in steps) for n in g_ref}
        trained = [n for n in sorted(top) if top[n] > 0]
        floor = GRAD_FLOOR * float(np.median([top[n] for n in trained]))
        moved = [n for n in trained if top[n] >= floor]
        grad_gap = leaf_gap(g_got, g_ref,
                            float(np.median([g_ref[n] for n in moved])))
        start = by_expert({k: v.to(self.device)
                           for k, v in self.start.items()}, "lora_")
        ref_banks = by_expert(truth["banks"])
        got_banks = by_expert({k: v.to(self.device)
                               for k, v in after.items()}, "lora_")
        d_ref = {n: float((ref_banks[n] - start[n]).norm()) for n in moved}
        d_got = {n: float((got_banks[n] - start[n]).norm()) for n in moved}
        med = float(np.median(list(d_ref.values())))
        gaps = {n: leaf_gap({n: d_got[n]}, {n: d_ref[n]}, med)
                for n in moved}
        self.detail = {"losses": [list(losses), truth["losses"]],
                       "first_grad": {n: [g_got[n], g_ref[n]]
                                      for n in moved},
                       "change": {n: [d_got[n], d_ref[n]] for n in moved},
                       "change_worst": max(gaps.items(), key=lambda x: x[1])}
        return [("first_grad_norm_gap_max", grad_gap),
                ("change_norm_gap_median", float(np.median(list(
                    gaps.values()))))]

    def judge(self, records):
        losses, first_grad, after = self.setup_losses, self.first_grad, \
            self.after
        self.release()
        truth = self.reference("f32")
        lim = self.cell.limits
        return [(n, v, lim[n]) for n, v in
                self.compare(losses, first_grad, after, truth)]

    def control(self, records):
        """The check's numbers with the reference at CONTROL precision in
        the program's place."""
        self.release()
        low = self.reference(CONTROL)
        names = sorted(low["banks"])
        first = {"lora_" + n: low["grads"][0][n] for n in names}
        after = {"lora_" + n: low["banks"][n] for n in names}
        truth = self.reference("f32")
        return dict(self.compare(low["losses"], first, after, truth))

    def look(self, records):
        """The look behind comparing the change by its median slot: the
        check's numbers; the same numbers of the program, and of the f32
        reference itself, against two witnesses, the reference with its
        moments, and with its moments and banks, kept in bf16 between steps
        as the program keeps them; and for each A slot of the task's expert,
        its step-2 gradient against Adam's eps and the share of its elements
        whose step-2 update lies under half the bf16 spacing at the
        element's value, which a bf16 bank loses, and the program's step-2
        gradient of it (its first moment over 1 - b1) against the
        reference's: the gap of the norms and the norm of the difference,
        each over the reference's norm."""
        losses, first_grad, after = self.setup_losses, self.first_grad, \
            self.after
        a_grad = {k[len("lora_"):]: v / self.b1_kept
                  for k, v in self.a_moment.items()}
        self.release()
        truth = self.reference("f32")
        out = {"values": dict(self.compare(losses, first_grad, after,
                                           truth)),
               "detail": self.detail}
        bf = torch.bfloat16
        for name, kept in (("moments_bf16", {"moments": bf}),
                           ("state_bf16", {"moments": bf, "params": bf})):
            wit = self.reference("f32", kept)
            names = sorted(wit["banks"])
            got = {}
            for side, args in (
                    ("program", (losses, first_grad, after, wit)),
                    ("witness_vs_f32", (
                        wit["losses"],
                        {"lora_" + n: wit["grads"][0][n] for n in names},
                        {"lora_" + n: wit["banks"][n] for n in names},
                        truth))):
                vals = dict(self.compare(*args))
                got[side] = [vals["change_norm_gap_median"],
                             self.detail["change_worst"]]
            out[name] = got
            del wit
        opt, e = self.mix["optimizer"], self.mix["expert"]
        adam = ref.AdamW(opt["lr"], opt["warmup_steps"], opt["total_steps"])
        lr2 = adam.rate(2)
        spots = {}
        for n in sorted(truth["banks"]):
            if not n.endswith("/A"):
                continue
            gs = [g[n][:, e] for g in truth["grads"]]
            mu = nu = 0
            for g in gs:
                mu = adam.b1 * mu + (1 - adam.b1) * g
                nu = adam.b2 * nu + (1 - adam.b2) * g * g
            k = len(gs)
            u = (mu / (1 - adam.b1 ** k)) / (
                torch.sqrt(nu / (1 - adam.b2 ** k)) + adam.eps)
            _, exp = torch.frexp(self.start["lora_" + n][:, e].to(
                self.device))
            half = torch.ldexp(torch.ones_like(u), exp - 9)
            g2 = gs[-1].abs()
            ref_norm = float(gs[-1].norm())
            spots[n] = {"g2_median_over_eps": float(g2.median()) / adam.eps,
                        "g2_norm_gap": abs(float(a_grad[n].norm())
                                           - ref_norm) / ref_norm,
                        "g2_rel_error": float((a_grad[n].to(self.device)
                                               - gs[-1]).norm()) / ref_norm,
                        "share_g2_under_eps": float((g2 < adam.eps).float()
                                                    .mean()),
                        "share_step_lost": float(((lr2 * u.abs()) < half)
                                                 .float().mean())}
        out["a_slots_step2"] = spots
        return out


def leaf_gap(got, ref_norms, med):
    """The worst slot's |got - ref| over the larger of its reference norm
    and med, the median trained slot's."""
    return max(abs(got[n] - r) / max(r, med, 1e-30)
               for n, r in ref_norms.items())
