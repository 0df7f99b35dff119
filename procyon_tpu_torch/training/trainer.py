"""Host-side multi-task trainer loop (counterpart of
procyon_tpu/training/trainer.py).

Step-interleaved multi-task training with per-task skip frequencies,
per-task metrics, checkpoint / eval cadence, exact resume (sampler / mixer
state + per-task progress), early stopping and a final save. "One global
step" runs each unskipped task's step once (a separate optimizer update
per task, like the reference's per-loss engine.backward calls); with
`lora_phase_training`, qa / retrieval / mlm run on experts 0 / 1 / 2, then
one joint update over every task on expert 3.

More than one rank (`mesh`): every rank runs the same loop on its rows of
the same global batches (the streams hand each rank its rows), the state
holds each rank's slices (train_step.init_train_state), logging, metrics
and checkpoint writes happen on rank 0 (every rank takes part in the
checkpoint's gather), and the mid-train eval sees whole parameters.

A departure from the reference (ROADMAP.md, section 3): an eval whose
watched metric is NaN (no val query scored) leaves the patience count as
it was and is logged with the count of queries scored, where the
reference counts it as a bad eval.
"""

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np

from procyon_tpu_torch.data.mixing import MixerState, TaskMixer
from procyon_tpu_torch.training import checkpointing
from procyon_tpu_torch.training import train_step as ts
from procyon_tpu_torch.training.logging_utils import MetricsLogger, \
    get_logger
from procyon_tpu_torch.training.prefetch import ready


@dataclasses.dataclass
class TrainLoopConfig:
    max_steps: int = 1000
    log_steps: int = 10
    save_steps: int = 500
    eval_steps: int = 0            # 0 = no mid-train eval
    keep_last_checkpoints: int = 3
    output_dir: str = "runs/default"
    # run task t only when step % skip_frequency[t] == 0
    skip_frequency: Dict[str, int] = dataclasses.field(default_factory=dict)
    early_stopping_patience: int = 0  # 0 = off
    early_stopping_metric: str = "eval/loss"
    # micro-batch gradient accumulation: each task step consumes N stream
    # batches and applies one averaged update
    accumulation_steps: int = 1
    # 4-phase MoLoRA expert cycling: per global step qa on expert 0,
    # retrieval on expert 1, mlm on expert 2 (each its own update), then a
    # joint all-task update on expert 3. Needs a 4-expert LoRA config.
    lora_phase_training: bool = False


class Trainer:
    def __init__(self, *, cfg, params, optimizer, loop: TrainLoopConfig,
                 task_streams: Dict[str, Callable[[], Dict]],
                 weights: ts.TaskWeights = ts.TaskWeights(),
                 eval_fn: Optional[Callable] = None,
                 metrics_logger: Optional[MetricsLogger] = None,
                 mixer: Optional[TaskMixer] = None,
                 stream_states: Optional[Dict[str, dict]] = None,
                 to_device: Optional[Callable] = None,
                 tokenizer_info: Optional[Dict] = None, mesh=None):
        """task_streams: task name -> callable returning the next batch
        for that task (built from a TaskMixer + collators; see
        scripts/run_pretrain.py). to_device turns a stream's batch into
        tensors on the device (identity when the streams prefetch)."""
        self.cfg = cfg
        self.loop = loop
        self.weights = weights
        self.optimizer = optimizer
        self.task_streams = task_streams
        self.eval_fn = eval_fn
        self.mixer = mixer
        self.stream_states = stream_states
        self.to_device = to_device or (lambda b: b)
        self.tokenizer_info = tokenizer_info
        self.is_main = mesh is None or mesh.rank == 0
        self.logger = get_logger(log_dir=loop.output_dir if self.is_main
                                 else None)
        if not self.is_main:
            self.logger.disabled = True
        self.metrics = metrics_logger or MetricsLogger(
            loop.output_dir if self.is_main else None)

        self.state = ts.init_train_state(params, optimizer, mesh=mesh,
                                         cfg=cfg)
        self.joint_step = None
        phase_tasks = set(task_streams)
        if loop.lora_phase_training:
            lora = getattr(cfg.llama, "lora", None)
            if lora is None or lora.num_experts < 4:
                raise ValueError(
                    "lora_phase_training needs a 4-expert LoRA decoder "
                    "(set use_lora + lora_num_experts>=4); got "
                    f"{'no LoRA' if lora is None else lora.num_experts}")
            # phases 1-3 cover qa/retrieval/mlm on their own experts;
            # caption data enters only through the joint expert-3 phase
            phase_tasks = {t for t in task_streams
                           if t in ("qa", "retrieval", "mlm")}
            from procyon_tpu_torch.training.combined_step import \
                make_combined_step
            self.joint_step = make_combined_step(
                cfg, optimizer, weights, expert_override=3)
        self.steps = {
            task: ts.make_train_step(
                cfg, optimizer, task, getattr(weights, task, 1.0),
                accumulation_steps=loop.accumulation_steps)
            for task in phase_tasks
        }
        self.progress = {task: 0 for task in task_streams}
        self.global_step = 0
        self._best = float("inf")
        self._bad_evals = 0

    def _batch(self, batch):
        return ready(self.to_device(batch))

    # -- resume ------------------------------------------------------------
    def maybe_resume(self):
        path = checkpointing.latest_checkpoint(self.loop.output_dir)
        if not path:
            return False
        self.state = checkpointing.restore_checkpoint(path, self.state)
        tstate = checkpointing.load_training_state(path) or {}
        self.global_step = int(tstate.get("global_step", 0))
        self.progress = tstate.get("task_progress", self.progress)
        if self.mixer is not None and "mixer" in tstate:
            self._mixer_state = MixerState.from_dict(tstate["mixer"])
        self.logger.info(f"resumed from {path} at step {self.global_step}")
        return True

    def _save(self):
        tstate = {
            "global_step": self.global_step,
            "task_progress": self.progress,
        }
        if self.stream_states:
            tstate["stream_states"] = dict(self.stream_states)
        if self.mixer is not None and hasattr(self, "_mixer_state"):
            tstate["mixer"] = self._mixer_state.to_dict()
        path = checkpointing.save_checkpoint(
            self.loop.output_dir, self.global_step, self.state,
            cfg=self.cfg, tokenizer_info=self.tokenizer_info,
            training_state=tstate,
            keep_last=self.loop.keep_last_checkpoints)
        self.logger.info(f"saved checkpoint {path}")

    # -- main loop ---------------------------------------------------------
    def train(self):
        loop = self.loop
        t_last = time.perf_counter()
        while self.global_step < loop.max_steps:
            step_metrics = {}
            for task, stream in self.task_streams.items():
                if task not in self.steps:
                    continue
                freq = loop.skip_frequency.get(task, 1)
                if freq > 1 and self.global_step % freq != 0:
                    continue
                if loop.accumulation_steps > 1:
                    batch = self._batch(ts.stack_microbatches(
                        [stream() for _ in range(loop.accumulation_steps)]))
                else:
                    batch = self._batch(stream())
                self.state, m = self.steps[task](self.state, batch)
                self.progress[task] += 1
                for k, v in m.items():
                    step_metrics[f"{task}/{k}"] = v
            if self.joint_step is not None:
                batches = {task: self._batch(stream())
                           for task, stream in self.task_streams.items()}
                self.state, m = self.joint_step(self.state, batches)
                for k, v in m.items():
                    step_metrics[f"joint/{k}"] = v
            self.global_step += 1

            if self.global_step % loop.log_steps == 0:
                dt = (time.perf_counter() - t_last) / loop.log_steps
                t_last = time.perf_counter()
                step_metrics["steps_per_sec"] = 1.0 / max(dt, 1e-9)
                if self.is_main:
                    self.metrics.log(step_metrics, self.global_step)
                brief = {k: round(float(v), 4)
                         for k, v in list(step_metrics.items())[:6]}
                self.logger.info(f"step {self.global_step}: {brief}")

            if loop.eval_steps and self.global_step % loop.eval_steps == 0 \
                    and self.eval_fn is not None:
                eval_metrics = self.eval_fn(
                    checkpointing.whole_state(self.state)["params"])
                if self.is_main:
                    self.metrics.log({f"eval/{k}": v
                                      for k, v in eval_metrics.items()},
                                     self.global_step)
                if self._early_stop(eval_metrics):
                    self.logger.info("early stopping triggered")
                    break

            if loop.save_steps and self.global_step % loop.save_steps == 0:
                self._save()

        self._save()
        return self.state

    def _early_stop(self, eval_metrics) -> bool:
        if not self.loop.early_stopping_patience:
            return False
        key = self.loop.early_stopping_metric.replace("eval/", "")
        val = float(eval_metrics.get(key, np.inf))
        if np.isnan(val):
            # nothing was scored (e.g. no val positive among the capped
            # targets): no evidence either way, so patience is not spent
            scored = eval_metrics.get("retrieval/n_scored")
            self.logger.info(
                f"eval {key} is NaN at step {self.global_step} "
                f"({scored} retrieval queries scored); patience count "
                f"stays {self._bad_evals}")
            return False
        if val < self._best:
            self._best = val
            self._bad_evals = 0
            checkpointing.mark_best(self.loop.output_dir, self.global_step)
        else:
            self._bad_evals += 1
        return self._bad_evals >= self.loop.early_stopping_patience
