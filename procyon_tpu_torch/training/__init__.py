"""Training: per-task train steps, the optimizer, checkpoints, the
multi-task trainer and the host-to-device batch pipeline."""
