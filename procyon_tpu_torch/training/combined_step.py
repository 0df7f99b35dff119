"""Combined multi-task step (counterpart of
procyon_tpu/training/combined_step.py): one optimizer update over the summed
task losses, one global step of the reference's interleaved loop as one
callable, and the joint phase of LoRA phase training.
"""

from procyon_tpu_torch.models import unified
from procyon_tpu_torch.training import train_step as ts


def make_combined_step(cfg: unified.UnifiedConfig, optimizer,
                       weights: ts.TaskWeights = ts.TaskWeights(),
                       expert_override=None,
                       frozen_base: bool = False):
    """step(state, batches) with batches a dict of optional qa / caption /
    retrieval / mlm batches.

    expert_override: run every task through this LoRA expert index (the
    reference's joint phase sets group 3 for the all-task step).
    frozen_base: QLoRA state layout, as make_train_step's. The update is
    in place. A sharded state (init_train_state(..., mesh=)) takes each
    task's rows of the global batch, as make_train_step's steps do."""
    n_experts = max(ts.lora_num_experts(cfg), 1)

    def expert(task):
        if expert_override is not None:
            return expert_override % n_experts
        return ts.TASK_LORA_EXPERT.get(task, 0) % n_experts

    def step(state, batches):
        mesh = ts.state_mesh(state)

        def lf(params):
            total = 0.0
            metrics = {}
            for task, fn, w in (("qa", ts.lm_loss_fn, weights.qa),
                                ("caption", ts.lm_loss_fn, weights.caption),
                                ("retrieval", ts.retrieval_loss_fn,
                                 weights.retrieval)):
                if task in batches:
                    l, m = fn(params, cfg, batches[task], w,
                              lora_expert=expert(task), mesh=mesh)
                    total = total + l
                    metrics.update({f"{task}/{k}": v for k, v in m.items()})
            if "mlm" in batches and cfg.esm is not None:
                # on the joint phase's expert, as the reference's joint step
                # sets one group for both towers (the JAX package's passes
                # no expert here: ROADMAP.md, section 3)
                l, m = ts.mlm_loss_fn(params, cfg, batches["mlm"],
                                      weights.mlm, lora_expert=expert("mlm"),
                                      mesh=mesh)
                total = total + l
                metrics.update({f"mlm/{k}": v for k, v in m.items()})
            return total, metrics

        loss, metrics, items, grads = ts.value_and_grad(optimizer, state,
                                                        frozen_base, lf)
        ts._apply_updates(state, optimizer, items, grads)
        metrics["loss"] = loss
        metrics["grad_norm"] = ts.grad_norm(state, items, grads)
        return state, metrics

    return step
