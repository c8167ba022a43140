"""Symbol-adapter orchestrated training CLI of the PyTorch port
(ref: models/symbolAdapter/orchestrator_training.py) — the JAX package's
flags, with ``--device`` in place of ``--platform``.

Hermetic example (CPU, plain PyTorch versions of the kernels):
    python -m icl_speech_text_llm_tpu_torch.cli.symbol_train \\
        --training_mode bypass_mlp_sym --dataset_type voxceleb \\
        --model_type salmonn-tiny --synthetic --total_cycles 1 \\
        --lora_epochs 1 --batch_size 2 --max_samples 4 --val_max_samples 2 \\
        --output_dir /tmp/symbol_run --device cpu
"""

from __future__ import annotations

import logging

from ..symbol_adapter import TrainingConfig, build_training_world, parse_training_args


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_training_args(argv)
    config = TrainingConfig.from_args(args)
    orchestrator = build_training_world(config, device=args.device)
    result = orchestrator.run_complete_training()
    print(f"completed {len(result['summaries'])} schedule steps")
    return result


if __name__ == "__main__":
    main()
