"""Top-level configuration: ModelArgs / DataArgs / TrainArgs (counterpart
of procyon_tpu/config.py, with torch dtypes).

Equivalent of the reference's args system (procyon/training/
training_args_IT.py: ModelArgs :27, DataArgs :654, TrainArgs :1152 and
procyon/evaluate/framework/args.py EvalArgs), with the same override
pattern: flags parsed into dataclasses, overridable wholesale from YAML
(--from_yaml, run_pretrain.py:120-128).

`build_*` functions translate these user-facing args into the framework's
internal configs (UnifiedConfig, OptimizerConfig, TrainLoopConfig,
CollatorConfig), the analogue of postprocess_args (:1813). The mesh and
multi-process fields lay out the ranks of scripts/run_pretrain.py
(parallel/).
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ModelArgs:
    # text encoder (ModelArgs.text_encoder_fname etc.)
    text_model: str = "llama3-8b"       # llama2-7b | llama3-8b | tiny
    text_encoder_debug: bool = False    # 2-layer shrink (:160-164)
    # protein encoder
    protein_encoder: str = "esm2-3b"    # esm2-{8m,35m,150m,650m,3b} | none
    use_aaseq_embeddings: bool = True   # frozen tables vs live ESM (:189)
    protein_embed_dim: int = 2560
    protein_pooling: str = "mean"
    long_protein_strategy: str = "split"
    max_protein_len: int = 1024
    # projectors (:protein_tokenizer dims; configs/llama3-full.yml)
    num_layers_token_projector: int = 3
    hidden_size_token_projector: int = 2560
    num_layers_shared_projector: int = 1
    num_layers_lm_projector: int = 1
    retrieval_dim: int = 1024
    ret_token_access: str = "last"
    # modalities
    use_drug_embeddings: bool = False
    drug_embed_dim: int = 512
    # LoRA / MoLoRA (:mlora) on the text decoder
    use_lora: bool = False
    # ESM prefix tuning (esm.py:42 ESMPrefix): learned post-rotary K/V rows
    # per encoder layer; base encoder freezes, prefix trains
    esm_prefix_len: int = 0
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_num_experts: int = 1
    # encoder-side (Mo)LoRA (reference freeze_protein_encoder == 'lora' /
    # 'qlora' + protein_task_spc_lora, model_unified.py:226-234; kwargs
    # esm.py:424-492). QLoRA = use_prot_lora + quantize_params on the tree.
    use_prot_lora: bool = False
    prot_lora_parameters: str = "default"   # attn | mlp | default (esm.py:424)
    aaseq_lora_r: int = 8                   # training_args_IT.py:458
    aaseq_lora_alpha: float = 8.0           # training_args_IT.py:452
    prot_lora_num_experts: int = 1          # protein_task_spc_lora_num (:247)
    # bottleneck adapter on the encoder (aaseq_adapter_rank, :464 — the
    # reference flag is disconnected there; ours works). 0 = off
    aaseq_adapter_rank: int = 0
    # freezing (freeze_* flags)
    freeze_protein_encoder: bool = True
    freeze_text_encoder: bool = False
    # numerics
    dtype: str = "bfloat16"
    attention_backend: Optional[str] = None
    tokenizer_path: Optional[str] = None


@dataclasses.dataclass
class DataArgs:
    data_dir: str = ""                  # DATA_DIR env in the reference
    it_data_config_yml: str = ""        # dataset-mix YAML (it_data_config)
    max_text_len: int = 2048
    num_examples: int = 1               # ICL examples per prompt
    use_text_crop_sampling: bool = False
    # augmentation: sample task-def / entity-description rephrasings
    # (reference training_args use_task_def_rephrasings etc.)
    use_task_def_rephrasings: bool = False
    use_entity_rephrasings: bool = False
    entity_rephrase_prob: float = 0.5
    negative_samples_per_positive: int = 1
    qa_batch_size: int = 8
    retrieval_batch_size: int = 8
    caption_batch_size: int = 8
    mlm_batch_size: int = 8
    synthetic: bool = False
    # auxiliary aaseq-type embedding tables (ProCyon-Bind: peptide/domain
    # soft tokens ride their own frozen ESM tables — reference
    # configs/peptide_tune.yml:38-40 peptide/domain_embeddings_path)
    peptide_embeddings_path: str = ""
    domain_embeddings_path: str = ""
    # held-out split for mid-train eval (_run_eval, trainIT.py:1556-1654)
    eval_split: str = "val"
    eval_batches: int = 8
    # cap on the all-protein target sweep during mid-train retrieval eval
    eval_max_target_proteins: int = 4096


@dataclasses.dataclass
class TrainArgs:
    output_dir: str = "runs/pretrain"
    max_steps: int = 100_000
    warmup_steps: int = 1000
    lr: float = 1e-4
    protein_encoder_lr: Optional[float] = None
    text_encoder_lr: Optional[float] = None
    projector_lr: Optional[float] = None
    weight_decay: float = 1e-3
    grad_clip: float = 1.0
    schedule: str = "cosine"
    # per-task loss weights + skip frequencies (:1204-1250, :335-380)
    qa_loss_weight: float = 1.0
    retrieval_loss_weight: float = 1.0
    caption_loss_weight: float = 1.0
    mlm_loss_weight: float = 1.0
    qa_skip_frequency: int = 1
    retrieval_skip_frequency: int = 1
    caption_skip_frequency: int = 1
    mlm_skip_frequency: int = 0         # 0 = task off
    # cadence (:1341-1438)
    log_steps: int = 10
    save_steps: int = 1000
    eval_steps: int = 0
    keep_last_checkpoints: int = 3
    early_stopping_patience: int = 0
    # DeepSpeed gradient_accumulation_steps equivalent
    # (configs/deepspeed/full_train_ds.json): N micro-batches per update
    gradient_accumulation_steps: int = 1
    # 4-phase MoLoRA expert cycling (trainIT.py lora_specific_training);
    # requires a 4-expert LoRA decoder config
    lora_phase_training: bool = False
    # background host->device batch pipeline depth per task stream
    # (torch DataLoader num_workers+pin_memory equivalent,
    # training/prefetch.py); 0 = synchronous
    prefetch_depth: int = 2
    # mesh axes and multi-process scale-out (the reference's torchrun +
    # NCCL surface, run_pretrain.py:117; parallel/): the rank grid and
    # parallel.initialize_multihost's flags
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_model: int = 1
    dist_num_processes: int = 1
    dist_coordinator: Optional[str] = None
    dist_process_id: int = -1            # -1 = auto/env
    seed: int = 0
    resume: bool = False
    use_wandb: bool = False
    wandb_project: Optional[str] = None
    # where the model runs: "cuda" (one card) or "cpu" (tests)
    device: str = "cuda"


_TEXT_MODELS = {
    "llama2-7b": dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                      n_kv_heads=32, intermediate=11008, rope_theta=1e4,
                      max_seq_len=4096),
    "llama3-8b": dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                      n_kv_heads=8, intermediate=14336, rope_theta=5e5,
                      max_seq_len=8192),
    "tiny": dict(vocab_size=4096, dim=128, n_layers=2, n_heads=4,
                 n_kv_heads=2, intermediate=256, max_seq_len=512),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model_config(margs: ModelArgs, dargs: Optional[DataArgs] = None):
    from procyon_tpu_torch.models import esm2, llama, unified

    spec = dict(_TEXT_MODELS[margs.text_model])
    if margs.text_encoder_debug:
        spec["n_layers"] = 2
    if dargs is not None:
        spec["max_seq_len"] = max(spec["max_seq_len"], dargs.max_text_len)
    lora = None
    if margs.use_lora:
        from procyon_tpu_torch.models.lora import LoRAConfig

        lora = LoRAConfig(rank=margs.lora_rank, alpha=margs.lora_alpha,
                          num_experts=margs.lora_num_experts,
                          dtype=_DTYPES[margs.dtype])
    lcfg = llama.LlamaConfig(dtype=_DTYPES[margs.dtype],
                             attn_backend=margs.attention_backend,
                             lora=lora, **spec)
    ecfg = None
    if not margs.use_aaseq_embeddings and margs.protein_encoder != "none":
        from procyon_tpu_torch.models.lora import LoRAConfig

        prot_lora = None
        if margs.use_prot_lora:
            prot_lora = LoRAConfig(rank=margs.aaseq_lora_r,
                                   alpha=margs.aaseq_lora_alpha,
                                   num_experts=margs.prot_lora_num_experts,
                                   dtype=_DTYPES[margs.dtype])
        size = margs.protein_encoder.split("-")[-1]
        ecfg = esm2.esm2_config(size, dtype=_DTYPES[margs.dtype],
                                attn_backend=margs.attention_backend,
                                prefix_len=margs.esm_prefix_len,
                                lora=prot_lora,
                                lora_targets=margs.prot_lora_parameters,
                                adapter_rank=margs.aaseq_adapter_rank)
    return unified.UnifiedConfig(
        llama=lcfg, esm=ecfg,
        protein_embed_dim=margs.protein_embed_dim,
        token_projector_layers=margs.num_layers_token_projector,
        token_projector_hidden=margs.hidden_size_token_projector,
        retrieval_dim=margs.retrieval_dim,
        retrieval_projector_layers=margs.num_layers_lm_projector,
        use_drug_embeddings=margs.use_drug_embeddings,
        drug_embed_dim=margs.drug_embed_dim,
        protein_pooling=margs.protein_pooling,
        dtype=_DTYPES[margs.dtype])


def build_optimizer_config(targs: TrainArgs):
    from procyon_tpu_torch.training.optimizer import OptimizerConfig

    return OptimizerConfig(
        lr=targs.lr, protein_encoder_lr=targs.protein_encoder_lr,
        text_encoder_lr=targs.text_encoder_lr,
        projector_lr=targs.projector_lr, weight_decay=targs.weight_decay,
        grad_clip=targs.grad_clip, warmup_steps=targs.warmup_steps,
        total_steps=targs.max_steps, schedule=targs.schedule)


def build_loop_config(targs: TrainArgs):
    from procyon_tpu_torch.training.trainer import TrainLoopConfig

    skip = {}
    for task in ("qa", "retrieval", "caption", "mlm"):
        f = getattr(targs, f"{task}_skip_frequency")
        if f > 1:  # 0 = task disabled entirely (its stream isn't built)
            skip[task] = f
    return TrainLoopConfig(
        max_steps=targs.max_steps, log_steps=targs.log_steps,
        save_steps=targs.save_steps, eval_steps=targs.eval_steps,
        keep_last_checkpoints=targs.keep_last_checkpoints,
        output_dir=targs.output_dir, skip_frequency=skip,
        early_stopping_patience=targs.early_stopping_patience,
        accumulation_steps=targs.gradient_accumulation_steps,
        lora_phase_training=targs.lora_phase_training)


def build_task_weights(targs: TrainArgs):
    from procyon_tpu_torch.training.train_step import TaskWeights

    return TaskWeights(qa=targs.qa_loss_weight,
                       retrieval=targs.retrieval_loss_weight,
                       caption=targs.caption_loss_weight,
                       mlm=targs.mlm_loss_weight)


def build_collator_config(margs: ModelArgs, dargs: DataArgs,
                          targs: Optional[TrainArgs] = None):
    from procyon_tpu_torch.data.collators import CollatorConfig

    # gradient accumulation stacks batches on a leading axis, so the
    # unique-protein bank must be a fixed size: batch rows can reference at
    # most (num_examples + 2) proteins each (ICL + query + target)
    max_unique = 0
    if targs is not None and targs.gradient_accumulation_steps > 1:
        max_bs = max(dargs.qa_batch_size, dargs.retrieval_batch_size,
                     dargs.caption_batch_size)
        max_unique = max_bs * (dargs.num_examples + 2)
    return CollatorConfig(
        max_text_len=dargs.max_text_len,
        max_protein_len=margs.max_protein_len,
        num_examples=dargs.num_examples,
        use_protein_tokens=not margs.use_aaseq_embeddings,
        protein_embed_dim=margs.protein_embed_dim,
        long_protein_strategy=margs.long_protein_strategy,
        max_unique_proteins=max_unique,
        crop_texts=dargs.use_text_crop_sampling,
        use_task_def_rephrasings=dargs.use_task_def_rephrasings,
        use_entity_rephrasings=dargs.use_entity_rephrasings,
        entity_rephrase_prob=dargs.entity_rephrase_prob)


def freeze_fn(margs: ModelArgs):
    """Parameter freeze predicate (freeze_* args) over a path of keys.
    With LoRA enabled, the decoder's base weights freeze but the LoRA banks
    stay trainable (peft semantics)."""
    def frozen(path):
        parts = [str(getattr(p, "key", p)) for p in path]
        top = parts[0] if parts else ""
        if top == "esm":
            is_prefix = "prefix" in parts
            is_lora = any(p.startswith("lora_") for p in parts)
            is_adapter = "adapter" in parts
            if margs.esm_prefix_len and is_prefix:
                return False
            if margs.use_prot_lora and is_lora:
                return False  # peft semantics: banks train, base freezes
            if margs.aaseq_adapter_rank and is_adapter:
                return False
            if (margs.esm_prefix_len or margs.use_prot_lora
                    or margs.aaseq_adapter_rank):
                return True   # a PEFT mode is active: base encoder freezes
            if margs.freeze_protein_encoder:
                return True
        if top == "llama":
            is_lora = any(p.startswith("lora_") for p in parts)
            if margs.use_lora and not is_lora:
                return True
            if margs.freeze_text_encoder and not (margs.use_lora and
                                                  is_lora):
                return True
        return False

    return frozen


def load_yaml_into(args_obj, path: str):
    import yaml

    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    for k, v in overrides.items():
        if hasattr(args_obj, k):
            setattr(args_obj, k, v)
    return args_obj


_BOOL_VALUES = {"1": True, "true": True, "yes": True,
                "0": False, "false": False, "no": False}


def _parse_bool(s: str) -> bool:
    try:
        return _BOOL_VALUES[s.lower()]
    except KeyError:
        raise ValueError(f"expected a boolean value, got {s!r}")


def _coerce(v, current):
    """CLI string -> the field's runtime type. For Optional fields (default
    None) infer numerics from the string itself."""
    if not isinstance(v, str):
        return v
    if current is not None and not isinstance(current, bool):
        try:
            return type(current)(v)
        except (TypeError, ValueError):
            return v
    if isinstance(current, bool):
        return v
    # default is None: try int, then float, else keep the string
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parse_all(argv=None):
    """HfArgumentParser-style parse of (TrainArgs, DataArgs, ModelArgs) with
    --from_yaml override (run_pretrain.py:120-128)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--from_yaml", type=str, default=None)
    for cls in (TrainArgs, DataArgs, ModelArgs):
        for f in dataclasses.fields(cls):
            flag = f"--{f.name}"
            if any(a.dest == f.name for a in p._actions):
                continue
            # identity check: `0 in (True, False)` is True (int/bool
            # equality), which silently turned integer flags with 0/1
            # defaults into booleans
            if f.type is bool or f.default is True or f.default is False:
                # strict value set: a stray following token (e.g. a
                # launcher-appended positional) errors loudly instead of
                # being consumed as a falsy value
                p.add_argument(flag, nargs="?", const="true",
                               type=_parse_bool, default=None)
            else:
                p.add_argument(flag, default=None)
    ns, _ = p.parse_known_args(argv)
    targs, dargs, margs = TrainArgs(), DataArgs(), ModelArgs()
    if ns.from_yaml:
        for obj in (targs, dargs, margs):
            load_yaml_into(obj, ns.from_yaml)
    for obj in (targs, dargs, margs):
        for f in dataclasses.fields(obj):
            v = getattr(ns, f.name, None)
            if v is None:
                continue
            setattr(obj, f.name, _coerce(v, getattr(obj, f.name)))
    return targs, dargs, margs
