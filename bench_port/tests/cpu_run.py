"""Runs one cell of a test checkout on the CPU in a fresh process, with a
fault planted under the timed path first:

    python3 cpu_run.py ROOT FAULT --workload ... --seed ... --seconds ... --trace ...

FAULT: ``none``; ``token`` (every generated token altered where it is
sampled); ``unchanged`` (the optimizer update leaves the state as it
was); ``half_batch`` (the loss over the first half of the rows only);
``jax`` (a module named ``jax`` loaded)."""

import sys
import types

import checkout  # noqa: F401  (puts the benchmark and the port on sys.path)
import torch


def plant(fault: str) -> None:
    if fault == "token":
        from icl_speech_text_llm_tpu_torch.inference import engine

        plain = engine._sample_token

        def altered(logits, generator, gen):
            return (plain(logits, generator, gen) + 1) % logits.shape[-1]

        engine._sample_token = altered
    elif fault == "unchanged":
        from icl_speech_text_llm_tpu_torch.training.step import AdamW

        AdamW.apply = lambda self, grads, state, params, norm: None
    elif fault == "half_batch":
        from icl_speech_text_llm_tpu_torch.models import qwen_audio

        plain = qwen_audio.qwen_audio_train_loss

        def half(cfg, params, batch, remat=False):
            rows = batch["text_tokens"].shape[0] // 2
            return plain(cfg, params, {k: v[:rows] for k, v in batch.items()}, remat)

        qwen_audio.qwen_audio_train_loss = half
    elif fault == "jax":
        sys.modules["jax"] = types.ModuleType("jax")
    elif fault != "none":
        raise ValueError(fault)


if __name__ == "__main__":
    torch.set_num_threads(2)
    root, fault, *argv = sys.argv[1:]
    plant(fault)
    import run

    sys.exit(run.main(argv, device="cpu", root=root))
