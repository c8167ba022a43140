"""Inference CLI of the PyTorch port — the JAX package's flag surface, with
``--device`` in place of ``--platform``.

Hermetic example (no SLUE data needed):
    python -m icl_speech_text_llm_tpu_torch.cli.inference \\
        --dataset_type voxceleb --input_mode speech_only --fewshot_mode speech \\
        --num_examples 2 --model_type salmonn-tiny --synthetic \\
        --max_samples 8 --batch_size 4 --results_dir /tmp/out --device cpu

``--quantize_int8`` / ``--quantize_int4`` quantize the created model's LLM
(``ops/quant.py:quantize_decoder``) and ``--kv_int8`` keeps its KV cache in
int8. The generation flags are the JAX CLI's: ``--do_sample`` with
``--temperature`` / ``--top_p``, ``--num_beams`` (beam search, stochastic
with ``--do_sample``), ``--repetition_penalty``, ``--length_penalty`` and
``--min_new_tokens``. ``--llm_params_dir`` / ``--adapter_params_dir`` load
``cli/convert.py``'s converted dirs in place of the random LLM / adapter (a
dir quantized at another width than ``--quantize_int*`` asks is an error; one
at that width is used as it is), and ``--peft_model_path`` a trainable-only
checkpoint (``state.npy``) over them. ``--auto_batch`` (alias
``--optimize_batch_size``) sets ``--batch_size`` to the largest size (up to
``--auto_batch_max``) whose generation fits 0.9 × the card's memory: one
request tiled to each size of JAX's doubling-then-bisect search is
generated once and the peak allocation read (an out-of-memory probe counts
as "does not fit"). ``--compile_cache`` (the XLA compilation cache) has no
counterpart and is gone. The Qwen2-Audio
model types (``qwen2-audio-7b``, ``qwen2-audio-tiny``, ...) build their
prompts in Qwen's chat format and splice each clip's
``audio_output_length`` positions out of a 750-position slot: 6 clips of
5 s need ``--seq_len 2048``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from ..data.collate import collate_icl_batch
from ..data.factory import create_dataset
from ..inference.engine import GenerationConfig, generate_batch
from ..inference.runner import InferenceSettings, run_inference, save_final_results
from ..models.factory import create_model, get_model_from_checkpoint
from ..ops.quant import quantize_decoder
from ..registry import DatasetSplit, parse_dataset_types
from ..utils.memory import BatchSizeOptimizer, tile_batch
from ..utils.tokenization import get_tokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batched ICL inference (PyTorch/CUDA port)")
    p.add_argument("--dataset_type", type=str, default="voxceleb",
                   help="dataset name(s), '-' or ',' separated")
    p.add_argument("--input_mode", type=str, default="speech_only",
                   choices=["speech_only", "speech_and_text", "text_only"])
    p.add_argument("--fewshot_mode", type=str, default="text",
                   choices=["text", "speech", "none"])
    p.add_argument("--num_examples", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--debug_samples", type=int, default=None,
                   help="alias of --max_samples (reference smoke flag)")
    p.add_argument("--split", type=str, default="test",
                   choices=["train", "validation", "test"])
    p.add_argument("--model_type", type=str, default="salmonn-tiny")
    p.add_argument("--peft_model_path", type=str, default=None)
    p.add_argument("--llm_params_dir", type=str, default=None)
    p.add_argument("--adapter_params_dir", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--run_name", type=str, default="run")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--max_new_tokens", type=int, default=10)
    p.add_argument("--do_sample", action="store_true")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--repetition_penalty", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--min_new_tokens", "--min_length", type=int, default=0)
    p.add_argument("--kv_int8", action="store_true")
    quant = p.add_mutually_exclusive_group()
    quant.add_argument("--quantize_int8", action="store_true")
    quant.add_argument("--quantize_int4", action="store_true")
    p.add_argument("--randomize_swap", action="store_true")
    p.add_argument("--seq_len", type=int, default=2048)
    p.add_argument("--text_len", type=int, default=1024)
    p.add_argument("--synthetic", action="store_true",
                   help="fabricated schema-correct data instead of disk datasets")
    p.add_argument("--synthetic_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--auto_batch", "--optimize_batch_size", action="store_true",
                   help="pick the largest batch size whose generation fits 0.9 × the "
                        "card's memory (measured: one generation at each size)")
    p.add_argument("--auto_batch_max", type=int, default=64,
                   help="--auto_batch search ceiling")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model: 'cuda' (kernels) or 'cpu' "
                        "(plain PyTorch versions)")
    return p


def _quantize(model, bits: int) -> None:
    """Quantize the model's LLM to ``bits`` in place (the engine holds the
    same tree), unless it arrived pre-quantized from ``--llm_params_dir``:
    then it must be at that width already."""
    llm = model.params["llm"]
    wq = llm["layers"]["attn"]["wq"]
    if isinstance(wq, dict):
        # int4 stores packed nibbles under "q4", int8 bytes under "q"
        # (ops/quant.py): a width mismatch silently running the other layout
        # (int8 13B needs twice the weight memory) is a hard error
        have = 4 if "q4" in wq else 8
        if have != bits:
            raise SystemExit(
                f"--quantize_int{bits} requested but llm_params_dir is already "
                f"int{have}-quantized; re-convert the checkpoint (cli/convert.py) "
                f"or drop the flag")
        logging.info("LLM weights arrived pre-quantized at the requested int%d width; "
                     "skipping runtime quantization", bits)
    else:
        quantize_decoder(llm, bits=bits)


def generation_probe(model, sample, pack_cfg):
    """``--auto_batch``'s probe: (fn, make_args) with ``fn(*make_args(bs))``
    generating ``sample`` tiled to ``bs`` rows on the model's device."""
    engine = model.engine
    pb = collate_icl_batch([sample], engine.tokenizer, pack_cfg)
    probe = {"text_tokens": pb.text_tokens, "gather_idx": pb.gather_idx,
             "seq_lengths": pb.seq_lengths, **pb.audio}

    def generate(params, batch):
        return generate_batch(engine.cfg, engine.gen, params, batch, engine.sequence_fn)

    def make_args(bs):
        return (model.params, {k: torch.as_tensor(v, device=engine.device)
                               for k, v in tile_batch(probe, bs).items()})

    return generate, make_args


def _auto_batch(model, dataset, pack_cfg, args) -> int:
    """The largest batch size whose generation of ``dataset[0]`` tiled to it
    fits the card's memory; ``args.batch_size`` where none fits."""
    sizer = BatchSizeOptimizer(*generation_probe(model, dataset[0], pack_cfg),
                               max_batch=args.auto_batch_max, device=model.engine.device)
    picked = sizer.find_optimal_batch_size(start=1)
    if picked and picked != args.batch_size:
        logging.info("--auto_batch: batch_size %d → %d (largest whose generation fits "
                     "the card's memory)", args.batch_size, picked)
        return picked
    return args.batch_size


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    dataset_types = parse_dataset_types(args.dataset_type)
    max_samples = args.max_samples or args.debug_samples

    tok = get_tokenizer(args.tokenizer)
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens, do_sample=args.do_sample,
        temperature=args.temperature, top_p=args.top_p,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
        num_beams=args.num_beams, repetition_penalty=args.repetition_penalty,
        length_penalty=args.length_penalty, min_new_tokens=args.min_new_tokens,
        kv_int8=args.kv_int8,
    )
    n_slots = {"speech": args.num_examples + 1, "text": 1, "none": 1}[args.fewshot_mode]
    if any(dt.value == "sqa" for dt in dataset_types):
        n_slots = 2 * (args.num_examples if args.fewshot_mode == "speech" else 0) + 2

    model_kw = dict(tokenizer=args.tokenizer, seed=args.seed, generation=gen,
                    device=args.device, llm_params_dir=args.llm_params_dir,
                    adapter_params_dir=args.adapter_params_dir)
    if args.peft_model_path:
        model = get_model_from_checkpoint(args.peft_model_path, args.model_type, **model_kw)
    else:
        model = create_model(args.model_type, **model_kw)
    if args.quantize_int8 or args.quantize_int4:
        _quantize(model, 4 if args.quantize_int4 else 8)
    # the model's own pack config carries its family's splice counts
    pack_cfg = dataclasses.replace(model.pack_cfg, seq_len=args.seq_len, text_len=args.text_len,
                                   max_slots=n_slots)
    dataset = create_dataset(
        dataset_types if len(dataset_types) > 1 else dataset_types[0],
        split=DatasetSplit(args.split),
        input_mode=args.input_mode,
        fewshot_mode=args.fewshot_mode,
        num_examples=0 if args.fewshot_mode == "none" else args.num_examples,
        randomize_swap=args.randomize_swap,
        is_training=False,
        max_samples=max_samples,
        synthetic=args.synthetic,
        synthetic_size=args.synthetic_size,
        seed=args.seed,
        prompt_style="qwen" if args.model_type.lower().startswith("qwen") else "salmonn",
    )
    if args.auto_batch:
        args.batch_size = _auto_batch(model, dataset, pack_cfg, args)
    settings = InferenceSettings(
        batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
        results_dir=args.results_dir, run_name=args.run_name,
        input_mode=args.input_mode, fewshot_mode=args.fewshot_mode,
        num_examples=args.num_examples, max_samples=max_samples,
    )
    payload = run_inference(model.engine, dataset, pack_cfg, settings)
    paths = save_final_results(payload, dataset_types, settings)
    print(paths["metrics"])
    return paths


if __name__ == "__main__":
    main()
