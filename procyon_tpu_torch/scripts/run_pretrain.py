"""Instruction pretraining CLI (counterpart of scripts/run_pretrain.py), on
one card or several.

Parses (TrainArgs, DataArgs, ModelArgs) with the --from_yaml override,
builds the dataset mix, collators and model, and runs the multi-task
trainer; prints one JSON line {"final_step", "output_dir"} at the end.
Each `checkpoint-{step}/` under --output_dir is also a model directory:
`models/checkpoint_io.load_model` reads it.

Synthetic smoke run (no DATA_DIR needed; the tiny model, bf16 on the card,
f32 with --device cpu):
  python -m procyon_tpu_torch.scripts.run_pretrain --synthetic true \\
      --max_steps 20 --output_dir /tmp/run1 [--device cpu]
Recipe run (needs the ProCyon-Instruct data):
  python -m procyon_tpu_torch.scripts.run_pretrain \\
      --from_yaml configs/llama3-full.yml

--eval_steps N evaluates every N steps on the --eval_split streams
(training/evaluation.build_midtrain_eval: QA / caption val losses, and
retrieval AUROC / AUPRC against the first --eval_max_target_proteins
proteins, --eval_batches batches a task); the trainer logs them to
metrics.jsonl as eval/*.

The live-encoder recipes (the reference's freeze_protein_encoder "lora" /
"qlora"): --use_aaseq_embeddings false with --protein_encoder esm2-<size>
trains through the ESM2 encoder, with --use_prot_lora true (banks of
--aaseq_lora_r, --prot_lora_num_experts experts on
--prot_lora_parameters), --esm_prefix_len P or --aaseq_adapter_rank r, and
--mlm_skip_frequency N > 0 adds the masked-LM task (--mlm_batch_size
proteins of at most --max_protein_len residues), e.g.
  python -m procyon_tpu_torch.scripts.run_pretrain --synthetic true \\
      --use_aaseq_embeddings false --protein_encoder esm2-8m \\
      --use_prot_lora true --prot_lora_num_experts 4 --use_lora true \\
      --lora_num_experts 4 --lora_phase_training true \\
      --mlm_skip_frequency 1 --max_steps 4 --output_dir /tmp/run2

Several ranks (parallel/): under torchrun, e.g.
  python -m torch.distributed.run --nproc_per_node N \
      -m procyon_tpu_torch.scripts.run_pretrain --mesh_fsdp -1 ...
(NCCL, a card a rank), or one process a rank with --dist_coordinator
host:port --dist_num_processes N --dist_process_id r (gloo with --device
cpu). --mesh_data / --mesh_fsdp / --mesh_model lay the ranks out (-1: the
rest); every rank builds the same global stream from the same seed and
keeps its rows (parallel.shard_batch), the state is sharded by the rule
table, and rank 0 logs and writes the checkpoints, which have the
one-process layout.
"""

import dataclasses
import json
import sys

import torch


def _check_same_run(targs, device):
    """Every rank was given the same seed and mesh (their streams and
    parameters must agree): a collective over the default group, whose
    size and backend rank 0 reports on stderr."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    mine = torch.tensor([targs.seed, targs.mesh_data, targs.mesh_fsdp,
                         targs.mesh_model], dtype=torch.int64,
                        device=device)
    first = mine.clone()
    dist.broadcast(first, 0)
    if not torch.equal(first, mine):
        raise ValueError(f"rank {dist.get_rank()} has seed / mesh "
                         f"{mine.tolist()}, rank 0 {first.tolist()}")
    if dist.get_rank() == 0:
        print(f"run_pretrain: {dist.get_world_size()} ranks over "
              f"{dist.get_backend()}", file=sys.stderr)


def setup(argv=None):
    """Parse the arguments and build everything the run needs. Returns a
    dict: targs, dargs, margs, ucfg, params, optimizer, loop, weights,
    streams, stream_states, device, tokenizer_info and eval_fn (None
    unless --eval_steps > 0) and mesh (None on one rank, or with every
    axis at 1)."""
    from procyon_tpu_torch import config as cfg_mod
    from procyon_tpu_torch import parallel
    from procyon_tpu_torch.data import data_config
    from procyon_tpu_torch.data.datasets import ProCyonDataStore, \
        SyntheticStore
    from procyon_tpu_torch.data.text_tokenizer import load_tokenizer
    from procyon_tpu_torch.models import unified
    from procyon_tpu_torch.training import checkpointing
    from procyon_tpu_torch.training.evaluation import build_midtrain_eval
    from procyon_tpu_torch.training.optimizer import (
        build_frozen_mask_optimizer, build_optimizer)

    targs, dargs, margs = cfg_mod.parse_all(argv)
    parallel.initialize_multihost(
        targs.dist_coordinator, targs.dist_num_processes,
        targs.dist_process_id, device=targs.device)
    device = torch.device(targs.device)
    _check_same_run(targs, device)
    mesh = parallel.create_mesh(parallel.MeshConfig(
        targs.mesh_data, targs.mesh_fsdp, targs.mesh_model))

    if dargs.synthetic:
        # shrink the model for the integration path
        margs.text_model = "tiny"
        margs.protein_embed_dim = 64
        margs.hidden_size_token_projector = 64
        margs.retrieval_dim = 32
        # the flash kernels take bf16; the CPU runs the plain versions in f32
        margs.dtype = "float32" if device.type == "cpu" else "bfloat16"
        dargs.max_text_len = min(dargs.max_text_len, 256)
        store = SyntheticStore(n_proteins=128, n_texts=128, embed_dim=64)
        tokenizer_info = {"path": None, "vocab_size": 4096}
        tokenizer = load_tokenizer(vocab_size=4096)
        mix = data_config.MultiDatasetConfig.load_from_yaml(
            dargs.it_data_config_yml) if dargs.it_data_config_yml \
            else data_config.MultiDatasetConfig(entries=[
                data_config.DatasetEntry(text_type="go",
                                         relations=["process"]),
            ])
    else:
        store = ProCyonDataStore(dargs.data_dir or None)
        tokenizer_info = {"path": margs.tokenizer_path}
        tokenizer = load_tokenizer(margs.tokenizer_path)
        mix = data_config.MultiDatasetConfig.load_from_yaml(
            dargs.it_data_config_yml) if dargs.it_data_config_yml \
            else data_config.DEFAULT_FULL_MIX

    ucfg = cfg_mod.build_model_config(margs, dargs)
    ocfg = cfg_mod.build_optimizer_config(targs)
    loop = cfg_mod.build_loop_config(targs)
    weights = cfg_mod.build_task_weights(targs)
    ccfg = cfg_mod.build_collator_config(margs, dargs, targs)

    # exact resume: rebuild streams at the checkpointed position
    resume_states = None
    if targs.resume:
        tstate = checkpointing.peek_resume_state(targs.output_dir)
        if tstate:
            resume_states = tstate.get("stream_states")

    aaseq_embeds = {k: v for k, v in
                    (("peptide", dargs.peptide_embeddings_path),
                     ("domain", dargs.domain_embeddings_path)) if v}
    batch_sizes = {"qa": dargs.qa_batch_size,
                   "retrieval": dargs.retrieval_batch_size,
                   "caption": dargs.caption_batch_size}
    streams, mixers, stream_states = data_config.build_task_streams(
        mix, store=store, tokenizer=tokenizer, collator_cfg=ccfg,
        batch_sizes=batch_sizes,
        data_dir=dargs.data_dir, synthetic=dargs.synthetic,
        seed=targs.seed, resume_states=resume_states,
        aaseq_embedding_files=aaseq_embeds)
    # drop disabled tasks (skip_frequency == 0)
    for task in list(streams):
        if getattr(targs, f"{task}_skip_frequency") == 0:
            del streams[task]
    if targs.mlm_skip_frequency > 0 and ucfg.esm is not None:
        streams["mlm"] = data_config.build_mlm_stream(
            store, batch_size=dargs.mlm_batch_size,
            n_proteins=getattr(store, "n_proteins", 1024),
            max_protein_len=margs.max_protein_len, seed=targs.seed,
            state_holder=stream_states,
            resume_state=(resume_states or {}).get("mlm"))
    if mesh.size("batch") > 1:
        # every rank draws the same global batch and keeps its rows
        streams = {t: (lambda s=s: parallel.shard_batch(s(), mesh))
                   for t, s in streams.items()}

    # eval_on_the_fly (trainIT.py:725-748 + _run_eval :1556-1654): VAL-split
    # streams, all-protein retrieval AUROC/AUPRC, QA/caption val losses
    eval_fn = None
    if targs.eval_steps:
        val_mix = data_config.MultiDatasetConfig(entries=[
            dataclasses.replace(e, splits=[dargs.eval_split])
            for e in mix.entries])
        val_streams, _, _ = data_config.build_task_streams(
            val_mix, store=store, tokenizer=tokenizer, collator_cfg=ccfg,
            batch_sizes=batch_sizes,
            data_dir=dargs.data_dir, synthetic=dargs.synthetic,
            seed=targs.seed + 1, aaseq_embedding_files=aaseq_embeds)
        val_streams = {t: s for t, s in val_streams.items() if t in streams}
        if dargs.synthetic:
            all_ids = list(range(getattr(store, "n_proteins", 128)))
        else:
            # the full protein set (ALL_PROTEINS_FILE semantics,
            # model_utils.py:44-60), capped for eval cost
            all_ids = sorted({
                r.aaseq_idx
                for t, m in mixers.items()
                for ds in m.datasets.values()
                for r in getattr(ds, "relations", [])})
        all_ids = all_ids[:dargs.eval_max_target_proteins]
        eval_fn = build_midtrain_eval(
            ucfg, val_streams=val_streams, store=store,
            all_protein_ids=all_ids, n_batches=dargs.eval_batches,
            device=device)

    params = unified.init_params(targs.seed, ucfg, device=device)
    if margs.freeze_protein_encoder or margs.freeze_text_encoder:
        optimizer = build_frozen_mask_optimizer(
            ocfg, cfg_mod.freeze_fn(margs))
    else:
        optimizer = build_optimizer(ocfg)
    return dict(targs=targs, dargs=dargs, margs=margs, ucfg=ucfg,
                params=params, optimizer=optimizer, loop=loop,
                weights=weights, streams=streams,
                stream_states=stream_states, device=device,
                tokenizer_info=tokenizer_info, eval_fn=eval_fn,
                mesh=None if mesh.trivial else mesh)


def main(argv=None):
    from procyon_tpu_torch.training.logging_utils import MetricsLogger
    from procyon_tpu_torch.training.prefetch import DeviceCopier, \
        wrap_streams
    from procyon_tpu_torch.training.trainer import Trainer

    run = setup(argv)
    targs = run["targs"]
    to_device = DeviceCopier(run["device"])
    main_rank = run["mesh"] is None or run["mesh"].rank == 0
    metrics_logger = MetricsLogger(
        targs.output_dir if main_rank else None,
        use_wandb=targs.use_wandb and main_rank,
        wandb_project=targs.wandb_project)

    # background host->device pipeline: batches arrive on the device, and
    # the trainer-visible stream states reflect only consumed batches
    # (exact-resume contract, training/prefetch.py)
    run_streams, run_states, run_to_device = (
        run["streams"], run["stream_states"], to_device)
    close_prefetch = None
    if targs.prefetch_depth > 0:
        run_streams, run_states, close_prefetch = wrap_streams(
            run["streams"], to_device=to_device,
            source_states=run["stream_states"], depth=targs.prefetch_depth)
        run_to_device = None
    try:
        trainer = Trainer(cfg=run["ucfg"], params=run["params"],
                          optimizer=run["optimizer"], loop=run["loop"],
                          task_streams=run_streams, weights=run["weights"],
                          metrics_logger=metrics_logger,
                          stream_states=run_states, to_device=run_to_device,
                          eval_fn=run["eval_fn"],
                          tokenizer_info=run["tokenizer_info"],
                          mesh=run["mesh"])
        if targs.resume:
            trainer.maybe_resume()
        trainer.train()
    finally:
        if close_prefetch is not None:
            close_prefetch()
        metrics_logger.close()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if main_rank:
        print(json.dumps({"final_step": trainer.global_step,
                          "output_dir": targs.output_dir}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
