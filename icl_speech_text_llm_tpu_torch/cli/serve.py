"""Continuous-batching serving CLI of the PyTorch port — the JAX package's
flag surface, with ``--device`` in place of ``--platform``.

Streams dataset samples as individual requests through the slot-pool
engine (``inference/serving.py``): each wave of ``--admit_batch`` samples
is collated and encoded together (``salmonn_prompt_embeddings``, or
``qwen_prompt_embeddings`` for the Qwen2-Audio model types, whose pack
config splices each clip's ``audio_output_length``), its requests
submitted, and one engine step taken; ``run`` then drains the pool.
Hermetic example:

    python -m icl_speech_text_llm_tpu_torch.cli.serve \\
        --model_type salmonn-tiny --dataset_type voxceleb --synthetic \\
        --max_samples 8 --num_slots 4 --device cpu

The engine runs in the model's compute dtype (JAX's CLI leaves its engine
at f32; on the card the port's K1 and K4 take bf16). ``--shared_prefix``
registers the first sample's exemplar header once and submits only each
request's query suffix; ``--lora_bank`` stacks checkpoints' LoRAs into a
bank and cycles requests over it. ``--mesh dp,fsdp,tp`` serves from
dp × fsdp × tp processes (tp must divide the KV heads):

    torchrun --nproc_per_node=N -m icl_speech_text_llm_tpu_torch.cli.serve \
        --mesh dp,fsdp,tp --model_type salmonn-13b ...

each rank holds its blocks of the weights (quantized ones whole) and its
KV heads of the pool, every rank runs the same schedule, and only rank 0
prints; ``pool_bytes`` are a rank's. Ranks sharing one card need gloo.
Under a sharded mesh a ``--lora_bank`` stays whole on every rank (only the
model's weights are cut), as under JAX; ``--compile_cache`` (the XLA
compilation cache) has no counterpart and is refused. Qwen2-Audio splices up to 750
positions a clip: 6 clips take ``--seq_len 2048 --prompt_buckets 2048``.
The last line printed
is a JSON summary: throughput and the engine's counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import numpy as np
import torch

from ..data.collate import ICLSample, collate_icl_batch
from ..data.factory import create_dataset
from ..data.prompts import split_prompt_plan
from ..inference.serving import (
    ContinuousBatchingEngine,
    ServingConfig,
    qwen_prompt_embeddings,
    salmonn_prompt_embeddings,
)
from ..models.factory import create_model
from ..parallel import initialize_distributed, is_main_process, make_mesh, shutdown_distributed
from ..parallel.sharding import context_of, is_sharded, shard_context, shard_params
from ..registry import DatasetSplit, parse_dataset_types
from ..utils.tokenization import get_tokenizer
from .inference import _quantize


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Slot-pool continuous-batching serving "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--model_type", type=str, default="salmonn-tiny")
    p.add_argument("--dataset_type", type=str, default="voxceleb")
    p.add_argument("--split", type=str, default="test",
                   choices=["train", "validation", "test"])
    p.add_argument("--input_mode", type=str, default="speech_only")
    p.add_argument("--fewshot_mode", type=str, default="text")
    p.add_argument("--num_examples", type=int, default=1)
    p.add_argument("--max_samples", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=10)
    p.add_argument("--num_slots", type=int, default=4)
    p.add_argument("--sync_every", type=int, default=4,
                   help="decode steps a decode block runs")
    p.add_argument("--prompt_buckets", type=str, default="256,512",
                   help="comma-separated prompt-length buckets")
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--text_len", type=int, default=384)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="per-request sampling temperature (0 = greedy)")
    p.add_argument("--num_beams", type=int, default=1,
                   help="per-request beam width; > 1 routes requests through the "
                        "engine's beam lane")
    p.add_argument("--admit_batch", type=int, default=4,
                   help="requests encoded and admitted together per wave")
    p.add_argument("--warmup", type=int, default=0,
                   help="requests to run untimed first")
    quant = p.add_mutually_exclusive_group()
    quant.add_argument("--quantize_int8", action="store_true")
    quant.add_argument("--quantize_int4", action="store_true")
    p.add_argument("--kv_int8", action="store_true", help="int8 KV pool")
    p.add_argument("--llm_params_dir", type=str, default=None)
    p.add_argument("--adapter_params_dir", type=str, default=None)
    p.add_argument("--lora_bank", type=str, default=None,
                   help="comma-separated trainable-checkpoint dirs: their 'lora' "
                        "subtrees stack into a bank and requests cycle adapter_id "
                        "over them")
    p.add_argument("--mesh", type=str, default=None,
                   help="serving mesh 'dp,fsdp,tp' (sizes multiply to the world size)")
    p.add_argument("--chunk_len", type=int, default=0,
                   help="chunked admission (divides every prompt bucket; 0 = off)")
    p.add_argument("--shared_prefix", action="store_true",
                   help="register the first sample's exemplar header once and "
                        "prefill only each request's query suffix")
    p.add_argument("--prefix_buckets", type=str, default="512",
                   help="comma-separated prefix-length buckets (with --shared_prefix)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compile_cache", type=str, default=None,
                   help="the JAX package's XLA cache; refused here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    return p


def _check_ported(args) -> None:
    if args.compile_cache:
        raise SystemExit("--compile_cache is the JAX package's XLA compilation cache "
                         "(TPU only); the PyTorch port has no counterpart")
    if args.shared_prefix and args.num_beams > 1:
        raise SystemExit("--shared_prefix is slot-pool only (the beam lane prefills its "
                         "full prompt); drop --num_beams")
    if args.shared_prefix and args.lora_bank:
        raise SystemExit("--shared_prefix + --lora_bank: the demo registers one prefix "
                         "(prefix KV is per-adapter); register per-adapter prefixes via "
                         "the engine API instead")


def _mesh_sizes(args, model):
    sizes = [int(x) for x in args.mesh.split(",")]
    if len(sizes) != 3:
        raise SystemExit(f"--mesh wants exactly 'dp,fsdp,tp' (got {args.mesh!r})")
    if model.cfg.llm.n_kv_heads % sizes[2]:
        raise SystemExit(f"tp={sizes[2]} must divide n_kv_heads={model.cfg.llm.n_kv_heads} "
                         "for the KV-head-sharded pool (the JAX engine refuses such a mesh "
                         "too; cli.train and static generation take it)")
    return sizes


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    _check_ported(args)
    owns_group = bool(args.mesh) and not torch.distributed.is_initialized()
    if args.mesh:  # before the model is built: a process on a card selects its own
        initialize_distributed(device=args.device)
        if not is_main_process():
            logging.getLogger().setLevel(logging.WARNING)
    try:
        return _serve(args)
    finally:
        if owns_group:
            shutdown_distributed()


def _serve(args):
    is_qwen = args.model_type.lower().startswith("qwen")

    tok = get_tokenizer(None)
    model = create_model(args.model_type, seed=args.seed, device=args.device,
                         llm_params_dir=args.llm_params_dir,
                         adapter_params_dir=args.adapter_params_dir)
    dev = torch.device(args.device)
    dataset_types = parse_dataset_types(args.dataset_type)
    dataset = create_dataset(
        dataset_types[0], split=DatasetSplit(args.split), input_mode=args.input_mode,
        fewshot_mode=args.fewshot_mode, num_examples=args.num_examples, is_training=False,
        max_samples=args.max_samples, synthetic=args.synthetic,
        synthetic_size=args.synthetic_size, seed=args.seed,
        prompt_style="qwen" if is_qwen else "salmonn")
    buckets = tuple(int(b) for b in args.prompt_buckets.split(","))

    def pack(max_slots):
        return dataclasses.replace(model.pack_cfg, seq_len=args.seq_len,
                                   text_len=args.text_len, max_slots=max_slots)

    pack_cfg = pack(args.num_examples + 1 if args.fewshot_mode == "speech" else 1)
    scfg = ServingConfig(
        num_slots=args.num_slots, max_new_tokens=args.max_new_tokens, prompt_buckets=buckets,
        sync_every=args.sync_every, admit_batch=args.admit_batch,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, kv_int8=args.kv_int8,
        prefix_buckets=tuple(int(b) for b in args.prefix_buckets.split(","))
        if args.shared_prefix else (),
        chunk_len=args.chunk_len)
    if args.quantize_int8 or args.quantize_int4:
        _quantize(model, 4 if args.quantize_int4 else 8)
    mesh = None
    if args.mesh:
        dp, fsdp, tp = _mesh_sizes(args, model)
        mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, device=args.device)
        if is_sharded(mesh):  # quantized leaves match no rule: they stay whole
            model.params = model.engine.params = shard_params(model.params, mesh)
    shard = context_of(mesh) if is_sharded(mesh) else None
    lora = model.params.get("lora")
    n_adapters = 0
    if args.lora_bank:
        from ..bridge import params_from_numpy
        from ..training.checkpoint import load_lora_bank

        dirs = args.lora_bank.split(",")
        bank = load_lora_bank(dirs)
        dtype = next(iter(lora.values()))["a"].dtype if lora else model.cfg.compute_dtype
        lora = params_from_numpy(bank, dev, dtype)
        n_adapters = len(dirs)
        logging.info("multi-LoRA bank: %d adapters from %s", n_adapters, dirs)
    engine = ContinuousBatchingEngine(
        model.cfg.llm, model.params["llm"], scfg, lora=lora,
        lora_scaling=model.cfg.lora.scaling if model.cfg.lora is not None else 1.0,
        dtype=model.cfg.compute_dtype, device=dev, mesh=mesh)
    prompt_embeddings = qwen_prompt_embeddings if is_qwen else salmonn_prompt_embeddings

    def embed(samples, cfg_pack):
        packed = collate_icl_batch(samples, tok, cfg_pack)
        arrays = {"text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
                  "seq_lengths": packed.seq_lengths, **packed.audio}
        batch = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in arrays.items()}
        with torch.no_grad(), shard_context(shard):
            seq, _ = prompt_embeddings(model.cfg, model.params, batch)
        # lengths from the host-side batch: reading the device's would sync
        return seq, np.asarray(packed.seq_lengths)

    prefix_id, prefix_len = None, 0
    if args.shared_prefix:
        s0 = dataset[0]
        pre_plan, _ = split_prompt_plan(s0.plan)
        pre_sample = ICLSample(
            plan=pre_plan, completion="",
            slot_audio={k: v for k, v in s0.slot_audio.items() if k in pre_plan.slots},
            extras=s0.extras)
        pre_seq, pre_lengths = embed([pre_sample], pack(max(1, len(pre_plan.slots))))
        prefix_len = int(pre_lengths[0])
        prefix_id = engine.register_prefix(pre_seq[0, :prefix_len], prefix_len)
        logging.info("registered shared prefix: %d positions (%d exemplar audio slots)",
                     prefix_len, len(pre_plan.slots))

    def suffix(s):
        _, suf = split_prompt_plan(s.plan)
        return ICLSample(plan=suf, completion=s.completion,
                         slot_audio={k: v for k, v in s.slot_audio.items() if k in suf.slots},
                         extras=s.extras)

    def submit_group(samples):
        """One collate + encode for a wave, padded to --admit_batch by
        repeating the last sample (the padding rows are not submitted)."""
        wave = list(samples)
        real = len(wave)
        wave += [wave[-1]] * (args.admit_batch - real)
        cfg_pack = pack_cfg
        if prefix_id is not None:
            wave = [suffix(s) for s in wave]
            cfg_pack = pack(1)
        seq, lengths = embed(wave, cfg_pack)
        rids = []
        for r in range(real):
            length = int(lengths[r])
            rids.append(engine.submit(
                seq[r, :length], length, temperature=args.temperature,
                num_beams=args.num_beams, prefix_id=prefix_id,
                adapter_id=(engine._next_id % n_adapters) if n_adapters else 0))
        return rids

    n = min(len(dataset), args.max_samples)
    if args.warmup:
        k = min(args.warmup, len(dataset))
        for start in range(0, k, args.admit_batch):
            submit_group([dataset[(start + w) % len(dataset)] for w in range(args.admit_batch)])
        engine.run()

    t0 = time.perf_counter()
    rid_to_sample = {}
    for start in range(0, n, args.admit_batch):
        group = [dataset[i] for i in range(start, min(start + args.admit_batch, n))]
        for rid, sample in zip(submit_group(group), group):
            rid_to_sample[rid] = sample
        engine.step()
    results = engine.run()
    elapsed = time.perf_counter() - t0

    if not is_main_process():
        return results
    for rid in sorted(results):
        text = tok.decode(results[rid], skip_special_tokens=True)
        print(f"[req {rid}] label={rid_to_sample[rid].completion!r} -> {text!r}")
    stats = engine.stats
    print(json.dumps({
        "requests": n, "elapsed_s": round(elapsed, 3),
        "throughput_req_s": round(n / elapsed, 3),
        "slots": args.num_slots, "buckets": list(buckets),
        "decode_blocks": stats["decode_blocks"],
        "prefill_waves": sum(stats["prefill_waves"].values()),
        "flushes": stats["flushes"], "beam_waves": stats.get("beam_waves", 0),
        "chunk_dispatches": stats.get("chunk_dispatches", 0), "prefix_len": prefix_len,
        "pool_bytes": sum(t.numel() * t.element_size() for t in engine._cache.values()),
    }))
    return results


if __name__ == "__main__":
    main()
