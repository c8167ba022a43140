"""Training CLI of the PyTorch port — the JAX package's flag surface, with
``--device`` in place of ``--platform``.

Hermetic example (CPU, plain PyTorch versions of the kernels):
    python -m icl_speech_text_llm_tpu_torch.cli.train \\
        --dataset_type voxceleb --model_type salmonn-tiny --synthetic \\
        --num_epochs 1 --batch_size 2 --max_samples 4 --seq_len 768 \\
        --text_len 384 --device cpu --output_dir /tmp/ckpt

LoRA (and SALMONN's Q-Former) train as f32 master weights; the frozen
encoders and LLM keep the preset's compute dtype (bf16 at salmonn-7b and
qwen2-audio-7b). The Qwen2-Audio model types train their LoRA alone through
``qwen_audio_train_loss`` (6 clips of 5 s need ``--seq_len 2048``).

``--auto_batch`` picks the largest batch size (up to ``--auto_batch_max``)
whose step fits 0.9 × the card's memory: the step's forward and backward
run once at each size of JAX's doubling-then-bisect search (no optimizer
update, so the state is left as it was; an out-of-memory probe counts as
"does not fit"), and the state is rebuilt at the pick.

``--mesh dp,fsdp,tp[,pp]`` trains over dp × fsdp × tp × pp processes, one a
card:

    torchrun --nproc_per_node=N -m icl_speech_text_llm_tpu_torch.cli.train \
        --mesh dp,fsdp,tp[,pp] --model_type salmonn-7b ...

dp replicates the model, fsdp shards the big matrices' other dim (gathered
a layer at a time), tp the heads, MLP columns and vocabulary by the rule
table (``parallel/sharding.py``); quantized leaves stay replicated. pp > 1
cuts the decoder's layers (and the LoRA) into stages run as a GPipe
pipeline over ``--pp_microbatches`` microbatches of each rank's rows
(default 2, as JAX's; read only where pp > 1): stage 0 runs the encoders
and the Q-Former, the last stage the loss (``parallel/pipeline.py``).
``--batch_size`` stays the global batch (each (dp, fsdp) coordinate steps
``batch_size / (dp · fsdp)`` of its rows, the tp ranks of one coordinate
the same rows; the loss is the global token mean, ``training/step.py``),
and only rank 0 logs and writes checkpoints (gathered leaves, the
one-process format). ``--mesh 1`` runs the same reductions in a group of
one. Ranks sharing one card need gloo (``initialize_distributed(...,
backend="gloo")``): NCCL refuses a card twice in a group. With
``--auto_batch`` each rank probes its own rows, every size's verdict is
agreed over the ranks, and the pick is a rank's rows × dp · fsdp (under a
pipeline each size is a count of microbatches). Qwen2-Audio has no
pipeline (JAX's ``qwen_audio_train_loss`` takes none), so pp > 1 with a
Qwen model type is refused; ``--compile_cache`` (an XLA compilation cache)
has no counterpart and is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import random
import re

import numpy as np
import torch
import torch.distributed as dist

from ..data.collate import collate_icl_batch
from ..data.factory import create_dataset
from ..models.factory import create_model
from ..parallel import (
    initialize_distributed,
    is_main_process,
    make_mesh,
    parse_mesh,
    shutdown_distributed,
)
from ..parallel.sharding import batch_shard, is_sharded, shard_params, stage_params
from ..registry import DatasetSplit, parse_dataset_types
from ..training.loop import TrainSettings, batch_arrays, train
from ..training.schedulers import get_schedule
from ..training.step import (
    AdamW,
    OptimizerSettings,
    init_train_state,
    make_train_probe,
    make_train_step,
)
from ..utils.memory import BatchSizeOptimizer, tile_batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LoRA (+ Q-Former) fine-tuning (PyTorch/CUDA port)")
    p.add_argument("--dataset_type", type=str, default="voxceleb")
    p.add_argument("--input_mode", type=str, default="speech_only",
                   choices=["speech_only", "speech_and_text", "text_only"])
    p.add_argument("--fewshot_mode", type=str, default="text",
                   choices=["text", "speech", "none"])
    p.add_argument("--num_examples", type=int, default=5)
    p.add_argument("--model_type", type=str, default="salmonn-tiny")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_epochs", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--scheduler", type=str, default="linear",
                   choices=["linear", "cosine", "cosine_with_restarts", "polynomial",
                            "constant", "constant_with_warmup", "inverse_sqrt",
                            "per_epoch_warmup_restart"])
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--gradient_checkpointing_policy", type=str, default="full",
                   help="'full' recomputes whole layers; 'dots' saves the weight-"
                        "matmul outputs and recomputes attention and elementwise "
                        "ops; '1inK' (e.g. 1in4) checkpoints K-1 of every K layers")
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--val_split", type=str, default="validation",
                   choices=["train", "validation", "test"])
    p.add_argument("--val_max_samples", type=int, default=200)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--debug_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--balance_datasets", action="store_true", default=True)
    p.add_argument("--no_balance_datasets", dest="balance_datasets", action="store_false")
    p.add_argument("--interleave", action="store_true", default=True)
    p.add_argument("--no_interleave", dest="interleave", action="store_false")
    p.add_argument("--randomize_swap", action="store_true")
    p.add_argument("--mesh", type=str, default=None,
                   help="process mesh 'dp,fsdp,tp[,pp]' (sizes multiply to the world "
                        "size), e.g. 4,2,1 or 2,1,1,2; pp > 1 GPipe-schedules the decoder")
    p.add_argument("--pp_microbatches", type=int, default=2,
                   help="microbatches of each rank's rows per pipeline pass (pp > 1); "
                        "the rows must be divisible by it")
    p.add_argument("--seq_len", type=int, default=2048)
    p.add_argument("--text_len", type=int, default=1024)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=16)
    p.add_argument("--compile_cache", type=str, default=None)
    p.add_argument("--auto_batch", action="store_true",
                   help="pick the largest batch size whose step fits 0.9 × the card's "
                        "memory (measured: one forward and backward at each size)")
    p.add_argument("--auto_batch_max", type=int, default=64,
                   help="--auto_batch search ceiling")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    return p


def _check_ported(args) -> None:
    if args.compile_cache:
        raise SystemExit("--compile_cache is the JAX package's XLA compilation cache "
                         "(TPU only); the PyTorch port has no counterpart")
    if args.mesh and parse_mesh(args.mesh)[3] > 1 and args.model_type.lower().startswith("qwen"):
        raise SystemExit("--mesh with pp > 1: Qwen2-Audio's train loss has no pipeline (the "
                         "JAX package's qwen_audio_train_loss takes no pipeline= either)")


def _remat(args):
    if not args.gradient_checkpointing:
        return False
    pol = args.gradient_checkpointing_policy
    if pol not in ("full", "dots") and not re.fullmatch(r"1in\d+", pol):
        raise SystemExit(f"--gradient_checkpointing_policy: invalid value {pol!r} "
                         "(expected 'full', 'dots', or '1inK' e.g. '1in4')")
    return True if pol == "full" else pol


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    _check_ported(args)
    mesh, owns_group = None, False
    if args.mesh:
        # before the model is built: a process on a card selects its own
        owns_group = not dist.is_initialized()
        initialize_distributed(device=args.device)
        dp, fsdp, tp, pp = parse_mesh(args.mesh)
        mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, pp=pp, device=args.device)
        if not is_main_process():
            logging.getLogger().setLevel(logging.WARNING)
    try:
        return _train(args, mesh)
    finally:
        if owns_group:
            shutdown_distributed()


def _train(args, mesh):
    random.seed(args.seed)
    np.random.seed(args.seed)
    dataset_types = parse_dataset_types(args.dataset_type)
    max_samples = args.max_samples or args.debug_samples

    is_qwen = args.model_type.lower().startswith("qwen")
    model = create_model(args.model_type, tokenizer=args.tokenizer, seed=args.seed,
                         device=args.device, trainable_dtype=torch.float32)
    if is_sharded(mesh):  # every rank drew the same weights: keep its blocks and stage
        model.params = model.engine.params = stage_params(shard_params(model.params, mesh),
                                                          mesh)
    pp = parse_mesh(args.mesh)[3] if args.mesh else 1
    pipeline = (mesh, args.pp_microbatches) if pp > 1 else None
    n_slots = args.num_examples + 1 if args.fewshot_mode == "speech" else 1
    pack_cfg = dataclasses.replace(model.pack_cfg, seq_len=args.seq_len,
                                   text_len=args.text_len, max_slots=n_slots)
    common = dict(input_mode=args.input_mode, fewshot_mode=args.fewshot_mode,
                  num_examples=0 if args.fewshot_mode == "none" else args.num_examples,
                  randomize_swap=args.randomize_swap, max_samples=max_samples,
                  synthetic=args.synthetic, synthetic_size=args.synthetic_size,
                  seed=args.seed, prompt_style="qwen" if is_qwen else "salmonn")
    ds_arg = dataset_types if len(dataset_types) > 1 else dataset_types[0]
    train_ds = create_dataset(ds_arg, split=DatasetSplit.TRAIN, is_training=True,
                              balance_datasets=args.balance_datasets,
                              interleave=args.interleave, **common)
    val_ds = create_dataset(ds_arg, split=DatasetSplit(args.val_split), is_training=False,
                            **common)

    def _build(batch_size):
        steps_per_epoch = max(1, len(train_ds) // batch_size)
        schedule = get_schedule(args.scheduler, args.learning_rate, args.warmup_steps,
                                steps_per_epoch * args.num_epochs, steps_per_epoch)
        optimizer = AdamW(OptimizerSettings(
            learning_rate=args.learning_rate, weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            grad_accum_steps=args.gradient_accumulation_steps, schedule=schedule))
        state, frozen = init_train_state(model.params, optimizer)
        step_fn = make_train_step(model.cfg, optimizer, loss_fn=model.loss_fn,
                                  remat=_remat(args), mesh=mesh, pipeline=pipeline)
        return state, frozen, step_fn

    state, frozen, step_fn = _build(args.batch_size)
    if args.auto_batch:
        probe = batch_arrays(collate_icl_batch([train_ds[0]], model.tokenizer, pack_cfg))
        device = model.engine.device
        # the search runs over a rank's rows, in microbatches under a pipeline
        micro = args.pp_microbatches if pipeline else 1
        shards = batch_shard(mesh)[1] * micro
        sizer = BatchSizeOptimizer(
            make_train_probe(model.cfg, model.loss_fn, _remat(args), mesh=mesh,
                             pipeline=pipeline),
            lambda bs: (state, frozen, {k: torch.as_tensor(v, device=device)
                                        for k, v in tile_batch(probe, bs * micro).items()}),
            max_batch=args.auto_batch_max, device=device)
        picked = sizer.find_optimal_batch_size(start=1) * shards
        if picked and picked != args.batch_size:
            logging.info("--auto_batch: batch_size %d → %d (largest whose step fits "
                         "the card's memory)", args.batch_size, picked)
            args.batch_size = picked
            state, frozen, step_fn = _build(picked)

    settings = TrainSettings(num_epochs=args.num_epochs, batch_size=args.batch_size,
                             save_every=args.save_every, output_dir=args.output_dir,
                             val_max_samples=args.val_max_samples,
                             resume_from=args.resume_from_checkpoint,
                             val_batch_size=args.batch_size)
    metadata = {"dataset_type": args.dataset_type, "model_type": args.model_type,
                "input_mode": args.input_mode, "fewshot_mode": args.fewshot_mode,
                "num_examples": args.num_examples}
    result = train(model, state, frozen, step_fn, train_ds, pack_cfg, settings,
                   val_dataset=val_ds, dataset_types=dataset_types, metadata=metadata,
                   mesh=mesh)
    perf = result.perf
    if is_main_process():
        print(f"done: {result.state.step} steps, {result.skipped_batches} skipped batches; "
              f"{perf['examples_per_sec']:.4f} examples/s, p50 step "
              f"{perf['p50_step_seconds']:.4f} s")
    return result


if __name__ == "__main__":
    main()
