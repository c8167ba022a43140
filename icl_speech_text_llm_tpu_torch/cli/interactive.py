"""Interactive single-query inference REPL of the PyTorch port
(ref: inference/interactive_inference.py:23-288).

Loads a model once on ``--device`` (default ``cuda``), then loops over
standard input: a wav path (``.wav``/``.npy``, or 'synth' for a 2 s 300 Hz
tone), generate, print the raw and cleaned prediction; an empty line ends
it. The JAX package's flags, with ``--device`` in place of ``--platform``;
``--compile_cache`` (the XLA compilation cache) has no counterpart and is
refused. Example (CPU):
    printf 'synth\n' | python -m icl_speech_text_llm_tpu_torch.cli.interactive \
        --model_type salmonn-tiny --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from ..data.collate import ICLSample
from ..data.packing import PackConfig
from ..data.prompts import build_default_prompt
from ..evaluation import clean_prediction
from ..inference.engine import GenerationConfig
from ..models.factory import create_model, get_model_from_checkpoint
from ..registry import DatasetType, get_dataset_config


def _load_wav(path: str) -> np.ndarray:
    if path == "synth":
        t = np.arange(16000 * 2) / 16000.0
        return (0.1 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import wave

    with wave.open(path, "rb") as w:
        frames = w.readframes(w.getnframes())
        data = np.frombuffer(frames, dtype=np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
        if w.getframerate() != 16000:
            from ..utils.native import resample

            data = resample(data, w.getframerate(), 16000)
        return data


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Interactive ICL inference (PyTorch/CUDA port)")
    p.add_argument("--model_type", type=str, default="salmonn-tiny")
    p.add_argument("--peft_model_path", type=str, default=None)
    p.add_argument("--dataset_type", type=str, default="voxceleb")
    p.add_argument("--max_new_tokens", type=int, default=10)
    p.add_argument("--compile_cache", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.compile_cache:
        raise SystemExit("--compile_cache is the JAX package's XLA compilation cache "
                         "(TPU only); the PyTorch port has no counterpart")

    if args.peft_model_path:
        model = get_model_from_checkpoint(args.peft_model_path, args.model_type,
                                          device=args.device)
    else:
        model = create_model(args.model_type, device=args.device)
    model.engine.gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        eos_token_id=model.tokenizer.eos_token_id,
        pad_token_id=model.tokenizer.pad_token_id,
    )
    pack_cfg = PackConfig(seq_len=768, text_len=512, max_slots=1,
                          audio_tokens_per_slot=model.cfg.audio_tokens_per_slot)
    dt = DatasetType(args.dataset_type)
    task = get_dataset_config(dt)
    print("Interactive inference. Enter a wav path (or 'synth'), empty line to quit.")
    for line in sys.stdin:
        path = line.strip()
        if not path:
            break
        try:
            wav = _load_wav(path)
        except Exception as e:
            print(f"could not load {path}: {e}")
            continue
        plan = build_default_prompt(task.prompt_template, "", [],
                                    input_mode="speech_only", fewshot_mode="text")
        sample = ICLSample(plan=plan, completion="", slot_audio={("main", 0): wav},
                           extras={"dataset_type": dt.value})
        batch_pred = model.generate_output([sample])[0]
        print(f"raw:     {batch_pred!r}")
        print(f"cleaned: {clean_prediction(batch_pred, dt)!r}")
    print("bye")


if __name__ == "__main__":
    main()
