"""procyon_tpu_torch must import without JAX: the machine with the card has
none, and importing procyon_tpu imports jax."""

import subprocess
import sys

MODULES = [
    "procyon_tpu_torch",
    "procyon_tpu_torch.bridge",
    "procyon_tpu_torch.ops._build",
    "procyon_tpu_torch.ops.activations",
    "procyon_tpu_torch.ops.attention_rowblock",
    "procyon_tpu_torch.ops.flash_attention",
    "procyon_tpu_torch.ops.fused_mlp",
    "procyon_tpu_torch.ops.norms",
    "procyon_tpu_torch.ops.page_move",
    "procyon_tpu_torch.ops.paged_attention",
    "procyon_tpu_torch.ops.quant",
    "procyon_tpu_torch.ops.rotary",
    "procyon_tpu_torch.models._init",
    "procyon_tpu_torch.models.contrastive",
    "procyon_tpu_torch.models.esm2",
    "procyon_tpu_torch.models.llama",
    "procyon_tpu_torch.models.lora",
    "procyon_tpu_torch.models.pooling",
    "procyon_tpu_torch.models.projectors",
    "procyon_tpu_torch.models.unified",
    "procyon_tpu_torch.data.collators",
    "procyon_tpu_torch.data.datasets",
    "procyon_tpu_torch.data.instruct",
    "procyon_tpu_torch.data.protein_tokenizer",
    "procyon_tpu_torch.data.registry",
    "procyon_tpu_torch.data.text_tokenizer",
    "procyon_tpu_torch.evaluate.caption",
    "procyon_tpu_torch.evaluate.procyon_models",
    "procyon_tpu_torch.evaluate.qa",
    "procyon_tpu_torch.inference.generation",
    "procyon_tpu_torch.inference.kv_pool",
    "procyon_tpu_torch.inference.paged_beam",
    "procyon_tpu_torch.inference.prompts",
    "procyon_tpu_torch.inference.retrieval_service",
    "procyon_tpu_torch.app.main",
    "procyon_tpu_torch.app.server",
    "procyon_tpu_torch.scripts.caption_bulk",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'procyon_tpu') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_import_builds_nothing():
    """Importing the kernel wrappers compiles and loads nothing: the build
    happens at a wrapper's first launch on a CUDA tensor."""
    from procyon_tpu_torch.ops import _build
    from procyon_tpu_torch.ops import (attention_rowblock, flash_attention,
                                       fused_mlp, page_move, paged_attention)
    assert attention_rowblock.launches >= 0 and fused_mlp.launches >= 0 \
        and flash_attention.launches >= 0 and page_move.launches >= 0 \
        and paged_attention.launches >= 0
    assert not _build._libs
