"""Offline re-scoring of a saved results JSON (ref: reprocess_metrics.py:7-117).

    python -m icl_speech_text_llm_tpu_torch.cli.reprocess \\
        --results results/run_voxceleb_..._results.json --dataset_type voxceleb \\
        [--out rescored_metrics.json]

Prints the metrics' scalars as JSON, as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..evaluation import reprocess_results, save_evaluation_results
from ..registry import DatasetType


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Re-evaluate saved results JSON")
    p.add_argument("--results", type=str, required=True)
    p.add_argument("--dataset_type", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    dt = DatasetType(args.dataset_type)
    metrics = reprocess_results(args.results, dt)
    if args.out:
        save_evaluation_results(metrics, os.path.dirname(args.out) or ".",
                                os.path.basename(args.out))
    print(json.dumps({k: v for k, v in metrics.items()
                      if not isinstance(v, (list, dict))}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
