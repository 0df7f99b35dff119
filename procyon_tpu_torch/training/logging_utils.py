"""Metrics logging: W&B when available, JSONL always (a copy of
procyon_tpu/training/logging_utils.py).

Equivalent of the reference's WandbLogger (procyon/training/wandb_logger.py)
+ per-rank python logging (train_utils.py:1282-1309) + loss CSV dump
(trainIT.py:934-974). Metrics are keyed by global_step.
"""

import json
import logging
import os
import time
from typing import Dict, Optional


def get_logger(name: str = "procyon_tpu_torch",
               log_dir: Optional[str] = None,
               rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"log_{rank}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, *, use_wandb=False,
                 wandb_project: Optional[str] = None, run_name=None,
                 config: Optional[Dict] = None):
        self.out_dir = out_dir
        self._jsonl = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project,
                                         name=run_name, config=config)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: int):
        rec = {"global_step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(rec, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()
