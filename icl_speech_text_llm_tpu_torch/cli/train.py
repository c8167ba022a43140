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
``qwen_audio_train_loss`` (6 clips of 5 s need ``--seq_len 2048``). Flags
for what is not ported yet (``--mesh``, ``--pp_microbatches`` > 1,
``--auto_batch``) raise ``NotImplementedError``; ``--compile_cache`` (an
XLA compilation cache) has no counterpart and is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import random
import re

import numpy as np
import torch

from ..data.factory import create_dataset
from ..models.factory import create_model
from ..registry import DatasetSplit, parse_dataset_types
from ..training.loop import TrainSettings, train
from ..training.schedulers import get_schedule
from ..training.step import AdamW, OptimizerSettings, init_train_state, make_train_step


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
    p.add_argument("--mesh", type=str, default=None)
    p.add_argument("--pp_microbatches", type=int, default=1)
    p.add_argument("--seq_len", type=int, default=2048)
    p.add_argument("--text_len", type=int, default=1024)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=16)
    p.add_argument("--compile_cache", type=str, default=None)
    p.add_argument("--auto_batch", action="store_true")
    p.add_argument("--auto_batch_max", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    return p


def _check_ported(args) -> None:
    if args.compile_cache:
        raise SystemExit("--compile_cache is the JAX package's XLA compilation cache "
                         "(TPU only); the PyTorch port has no counterpart")
    unported = {"--mesh": args.mesh, "--pp_microbatches > 1": args.pp_microbatches > 1,
                "--auto_batch": args.auto_batch}
    asked = [flag for flag, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)} (see ROADMAP.md)")


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
    random.seed(args.seed)
    np.random.seed(args.seed)
    dataset_types = parse_dataset_types(args.dataset_type)
    max_samples = args.max_samples or args.debug_samples

    is_qwen = args.model_type.lower().startswith("qwen")
    model = create_model(args.model_type, tokenizer=args.tokenizer, seed=args.seed,
                         device=args.device, trainable_dtype=torch.float32)
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

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    schedule = get_schedule(args.scheduler, args.learning_rate, args.warmup_steps,
                            steps_per_epoch * args.num_epochs, steps_per_epoch)
    optimizer = AdamW(OptimizerSettings(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm, grad_accum_steps=args.gradient_accumulation_steps,
        schedule=schedule))
    state, frozen = init_train_state(model.params, optimizer)
    step_fn = make_train_step(model.cfg, optimizer, loss_fn=model.loss_fn, remat=_remat(args))

    settings = TrainSettings(num_epochs=args.num_epochs, batch_size=args.batch_size,
                             save_every=args.save_every, output_dir=args.output_dir,
                             val_max_samples=args.val_max_samples,
                             resume_from=args.resume_from_checkpoint,
                             val_batch_size=args.batch_size)
    metadata = {"dataset_type": args.dataset_type, "model_type": args.model_type,
                "input_mode": args.input_mode, "fewshot_mode": args.fewshot_mode,
                "num_examples": args.num_examples}
    result = train(model, state, frozen, step_fn, train_ds, pack_cfg, settings,
                   val_dataset=val_ds, dataset_types=dataset_types, metadata=metadata)
    perf = result.perf
    print(f"done: {result.state.step} steps, {result.skipped_batches} skipped batches; "
          f"{perf['examples_per_sec']:.4f} examples/s, p50 step "
          f"{perf['p50_step_seconds']:.4f} s")
    return result


if __name__ == "__main__":
    main()
