"""Symbol-adapter inference CLI of the PyTorch port
(ref: models/symbolAdapter/orchestrator_inference.py, models/unified_inference.py).

Loads a symbol-training checkpoint (embedded config + symbol mappings;
written by either package), runs the 3-mode comprehensive validation in
inference mode and writes detailed JSON. The JAX package's flags, with
``--device`` in place of ``--platform``; ``--compile_cache`` (the XLA
compilation cache) has no counterpart and is refused.
"""

from __future__ import annotations

import argparse
import logging

from ..symbol_adapter import InferenceOrchestrator, TrainingConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Symbol-adapter inference (PyTorch/CUDA port)")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset_type", type=str, default=None)
    p.add_argument("--val_dataset_type", type=str, default=None)
    p.add_argument("--model_type", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="results/symbol_inference")
    p.add_argument("--run_name", type=str, default="symbol_inference")
    p.add_argument("--max_samples", type=int, default=10)
    p.add_argument("--val_max_samples", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--synthetic", action="store_true")
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

    config = TrainingConfig()
    config.output_dir = args.output_dir
    config.run_name = args.run_name
    config.data_config.max_samples = args.max_samples
    config.data_config.val_max_samples = args.val_max_samples
    config.data_config.batch_size = args.batch_size
    config.data_config.val_batch_size = args.batch_size
    config.data_config.synthetic = args.synthetic
    if args.model_type:
        config.model_type = args.model_type
    if args.dataset_type:
        config.data_config.dataset_type = args.dataset_type
    if args.val_dataset_type:
        config.data_config.val_dataset_type = args.val_dataset_type

    orchestrator = InferenceOrchestrator(args.checkpoint, config=config, device=args.device)
    results = orchestrator.run()
    for mode, res in results.items():
        print(f"{mode}: {res['composite']}")
    return results


if __name__ == "__main__":
    main()
