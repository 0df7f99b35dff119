"""procyon_tpu_torch — the PyTorch + CUDA port of procyon_tpu for NVIDIA
Hopper (H100, sm_90a).

The JAX package `procyon_tpu` stays beside this one as the reference. This
package imports torch and numpy only; it never imports jax or procyon_tpu
(tests/test_torch_imports.py holds it to that).

Layers mirror the JAX package's module paths:
  ops/        plain torch ops + the hand-written CUDA kernels (csrc/) that
              replace the Pallas TPU kernels, each with its plain version
  models/     ESM2 encoder, Llama decoder, LoRA banks, pooling, projectors,
              the InfoNCE head, the unified fusion model
  data/       tokenizers, the task library, collators, stores (numpy)
  inference/  prompts from free text, cosine top-k, the retrieval service
  app/        the retrieval service behind HTTP (stdlib, FastAPI optional)
  evaluate/   the QA readout
  bridge.py   JAX parameter pytrees (as numpy) -> torch tensors
"""

__version__ = "0.1.0"
