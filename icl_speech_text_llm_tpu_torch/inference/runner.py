"""Inference runner: dataset → batched generation → cleaning → metrics JSON.

Counterpart of ``icl_speech_text_llm_tpu/inference/runner.py``: fixed-size
batches (the last one padded, its padding rows dropped), per-dataset
``clean_prediction`` + ``evaluate_predictions``, and the reference's file
names ``{run_name}_{datasets}_{input_mode}_{fewshot_mode}_{k}shots_{results,
metrics}.json``. Each result also carries its generated token ids.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from icl_speech_text_llm_tpu.registry import DatasetType

from ..data.collate import ICLSample, collate_icl_batch
from ..data.packing import PackConfig
from ..evaluation import clean_prediction, evaluate_predictions, to_json_compatible
from .engine import SalmonnEngine

logger = logging.getLogger(__name__)


@dataclass
class InferenceSettings:
    batch_size: int = 4
    max_new_tokens: int = 10
    results_dir: str = "results"
    run_name: str = "run"
    input_mode: str = "speech_only"
    fewshot_mode: str = "text"
    num_examples: int = 5
    max_samples: Optional[int] = None


class ThroughputTracker:
    """Wall-clock time per batch, host clock around a call that ends with the
    generated tokens on the host (so the device work is finished)."""

    def __init__(self):
        self.batch_seconds: List[float] = []
        self.examples = 0
        self.tokens = 0

    def update(self, seconds: float, examples: int, tokens: int) -> None:
        self.batch_seconds.append(seconds)
        self.examples += examples
        self.tokens += tokens

    def summary(self) -> Dict[str, Any]:
        total = sum(self.batch_seconds)
        return {
            "batches": len(self.batch_seconds),
            "examples": self.examples,
            "total_seconds": total,
            "examples_per_sec": self.examples / total if total else 0.0,
            "tokens_per_sec": self.tokens / total if total else 0.0,
            "p50_batch_seconds": (statistics.median(self.batch_seconds)
                                  if self.batch_seconds else 0.0),
            "batch_seconds": list(self.batch_seconds),
        }


def run_inference(engine: SalmonnEngine, dataset, pack_cfg: PackConfig,
                  settings: InferenceSettings) -> Dict[str, Any]:
    """Generate predictions over ``dataset`` and clean them per task."""
    tracker = ThroughputTracker()
    results: List[Dict[str, Any]] = []
    n = len(dataset)
    if settings.max_samples:
        n = min(n, settings.max_samples)
    bs = settings.batch_size
    for start in range(0, n, bs):
        samples: List[ICLSample] = [dataset[i] for i in range(start, min(start + bs, n))]
        real = len(samples)
        while len(samples) < bs:  # pad the tail batch to the fixed batch shape
            samples.append(samples[-1])
        t0 = time.perf_counter()
        batch = collate_icl_batch(samples, engine.tokenizer, pack_cfg)
        toks = engine.generate_tokens(batch, batch.audio)[:real]
        preds = engine.decode_rows(toks)
        tracker.update(time.perf_counter() - t0, real, real * settings.max_new_tokens)
        for sample, pred, row in zip(samples[:real], preds, toks):
            dt = sample.extras.get("dataset_type", "")
            results.append({
                "text": sample.extras.get("text", ""),
                "true_label": sample.completion,
                "predicted_label": pred,
                "cleaned_prediction": clean_prediction(pred, DatasetType(dt) if dt else None),
                "dataset_type": dt,
                "tokens": [int(t) for t in row],
            })
    summary = tracker.summary()
    logger.info(f"Inference done: {len(results)} samples, "
                f"{summary['examples_per_sec']:.2f} utt/s")
    return {"results": results, "perf": summary}


def save_final_results(payload: Dict[str, Any], dataset_types: Sequence[DatasetType],
                       settings: InferenceSettings) -> Dict[str, str]:
    """Write results + per-dataset metrics JSON (reference filename schema)."""
    os.makedirs(settings.results_dir, exist_ok=True)
    ds_names = "_".join(dt.value for dt in dataset_types)
    stem = (f"{settings.run_name}_{ds_names}_{settings.input_mode}_"
            f"{settings.fewshot_mode}_{settings.num_examples}shots")
    results_path = os.path.join(settings.results_dir, f"{stem}_results.json")
    with open(results_path, "w") as f:
        json.dump(to_json_compatible(payload), f, indent=2)
    metrics: Dict[str, Any] = {}
    for dt in dataset_types:
        subset = [r for r in payload["results"] if r["dataset_type"] == dt.value]
        if subset:
            metrics[dt.value] = evaluate_predictions(subset, dt)
    metrics["perf"] = payload.get("perf", {})
    metrics_path = os.path.join(settings.results_dir, f"{stem}_metrics.json")
    with open(metrics_path, "w") as f:
        json.dump(to_json_compatible(metrics), f, indent=2)
    logger.info(f"Saved results to {results_path} and metrics to {metrics_path}")
    return {"results": results_path, "metrics": metrics_path}
