"""procyon_tpu_torch must import without JAX: the machine with the card has
none, and importing procyon_tpu imports jax. Nor may it need
scikit-learn, transformers or safetensors, which that machine lacks too."""

import subprocess
import sys

MODULES = [
    "procyon_tpu_torch",
    "procyon_tpu_torch.bridge",
    "procyon_tpu_torch.config",
    "procyon_tpu_torch.entry",
    "procyon_tpu_torch.native",
    "procyon_tpu_torch.ops._build",
    "procyon_tpu_torch.ops.activations",
    "procyon_tpu_torch.ops.attention_rowblock",
    "procyon_tpu_torch.ops.flash_attention",
    "procyon_tpu_torch.ops.fused_decode",
    "procyon_tpu_torch.ops.fused_mlp",
    "procyon_tpu_torch.ops.int4_matmul",
    "procyon_tpu_torch.ops.norms",
    "procyon_tpu_torch.ops.page_move",
    "procyon_tpu_torch.ops.paged_attention",
    "procyon_tpu_torch.ops.quant",
    "procyon_tpu_torch.ops.rotary",
    "procyon_tpu_torch.models._init",
    "procyon_tpu_torch.models.checkpoint_io",
    "procyon_tpu_torch.models.contrastive",
    "procyon_tpu_torch.models.bert",
    "procyon_tpu_torch.models.esm2",
    "procyon_tpu_torch.models.llama",
    "procyon_tpu_torch.models.lora",
    "procyon_tpu_torch.models.pooling",
    "procyon_tpu_torch.models.synthetic",
    "procyon_tpu_torch.models.projectors",
    "procyon_tpu_torch.models.unified",
    "procyon_tpu_torch.data.collators",
    "procyon_tpu_torch.data.data_config",
    "procyon_tpu_torch.data.context",
    "procyon_tpu_torch.data.dataset_tracker",
    "procyon_tpu_torch.data.datasets",
    "procyon_tpu_torch.data.instruct",
    "procyon_tpu_torch.data.mixing",
    "procyon_tpu_torch.data.protein_tokenizer",
    "procyon_tpu_torch.data.registry",
    "procyon_tpu_torch.data.text_tokenizer",
    "procyon_tpu_torch.data.wordpiece",
    "procyon_tpu_torch.evaluate.baselines",
    "procyon_tpu_torch.evaluate.baselines.protllm",
    "procyon_tpu_torch.evaluate.baselines.simple",
    "procyon_tpu_torch.evaluate.baselines.text_models",
    "procyon_tpu_torch.evaluate.bertscore",
    "procyon_tpu_torch.evaluate.caption",
    "procyon_tpu_torch.evaluate.core",
    "procyon_tpu_torch.evaluate.data_loading",
    "procyon_tpu_torch.evaluate.llm_judge",
    "procyon_tpu_torch.evaluate.metrics",
    "procyon_tpu_torch.evaluate.procyon_models",
    "procyon_tpu_torch.evaluate.qa",
    "procyon_tpu_torch.evaluate.quant_quality",
    "procyon_tpu_torch.evaluate.retrieval",
    "procyon_tpu_torch.evaluate.utils",
    "procyon_tpu_torch.inference.generation",
    "procyon_tpu_torch.inference.kv_pool",
    "procyon_tpu_torch.inference.paged_beam",
    "procyon_tpu_torch.inference.prompts",
    "procyon_tpu_torch.inference.retrieval_service",
    "procyon_tpu_torch.inference.serving",
    "procyon_tpu_torch.inference.speculative",
    "procyon_tpu_torch.parallel",
    "procyon_tpu_torch.parallel.collectives",
    "procyon_tpu_torch.parallel.mesh",
    "procyon_tpu_torch.parallel.multihost",
    "procyon_tpu_torch.parallel.sharding",
    "procyon_tpu_torch.app.main",
    "procyon_tpu_torch.app.server",
    "procyon_tpu_torch.scripts.bench_bind",
    "procyon_tpu_torch.scripts.bench_caption",
    "procyon_tpu_torch.scripts.bench_decode",
    "procyon_tpu_torch.scripts.bench_prefill",
    "procyon_tpu_torch.scripts.bench_retrieval",
    "procyon_tpu_torch.scripts.bench_serving",
    "procyon_tpu_torch.scripts.bench_train",
    "procyon_tpu_torch.scripts.bench_w8a8",
    "procyon_tpu_torch.scripts.caption_bulk",
    "procyon_tpu_torch.scripts.compute_bertscore_baseline",
    "procyon_tpu_torch.scripts.dryrun_multichip",
    "procyon_tpu_torch.scripts.llm_judge_pipeline",
    "procyon_tpu_torch.scripts.probe_fused_decode",
    "procyon_tpu_torch.scripts.probe_fused_mlp_blocks",
    "procyon_tpu_torch.scripts.probe_trace_window",
    "procyon_tpu_torch.scripts.protein_retrieval_disease_pheno",
    "procyon_tpu_torch.scripts.qa_filter_captions",
    "procyon_tpu_torch.scripts.run_eval_framework",
    "procyon_tpu_torch.scripts.run_pretrain",
    "procyon_tpu_torch.training.checkpointing",
    "procyon_tpu_torch.training.combined_step",
    "procyon_tpu_torch.training.evaluation",
    "procyon_tpu_torch.training.logging_utils",
    "procyon_tpu_torch.training.optimizer",
    "procyon_tpu_torch.training.prefetch",
    "procyon_tpu_torch.training.train_step",
    "procyon_tpu_torch.training.trainer",
    "procyon_tpu_torch.utils.baselines",
    "procyon_tpu_torch.utils.profiling",
    "procyon_tpu_torch.utils.timing",
    "procyon_tpu_torch.utils.trace",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'procyon_tpu', 'sklearn', "
        "'transformers', 'safetensors') "
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
                                       fused_decode, fused_mlp, int4_matmul,
                                       page_move, paged_attention)
    assert attention_rowblock.launches >= 0 and fused_mlp.launches >= 0 \
        and flash_attention.launches >= 0 and page_move.launches >= 0 \
        and paged_attention.launches >= 0 and int4_matmul.launches >= 0 \
        and flash_attention.launches_bwd_dq >= 0 \
        and flash_attention.launches_bwd_dkv >= 0 \
        and fused_mlp.launches_ln_quant >= 0 \
        and fused_mlp.launches_prequant >= 0 \
        and page_move.launches_staged >= 0 and fused_decode.launches >= 0 \
        and fused_mlp.launches_swiglu >= 0
    assert not _build._libs
