"""Training loop: epochs over packed batches, validation, checkpoints.

Counterpart of ``icl_speech_text_llm_tpu/training/loop.py``: batches are
reshuffled per epoch (``shard_indices``), prefetched on a host thread, moved
to the model's device and stepped; each epoch ends with generation-based
validation on the current trainable weights and a trainable-only checkpoint
``epoch_{n}_loss_{x:.4f}``. A batch whose step raises is skipped, as in the
JAX package, and counted: ``train`` returns the count with the state.
``StepTimer`` records per-step seconds on the host's clock, examples/s and
each step's kernel launches, and on CUDA with no mesh each step's device
interval from its phase events, read after the loop; nothing in it
synchronises.

With a ``mesh`` (data parallelism over its ``dp`` group) every rank draws
the same per-epoch permutation and collates only its contiguous
``batch_size / (dp · fsdp)`` rows of each global batch (the ranks of one
tp group collate the same rows), so ``batch_size`` stays the global batch;
validation shards the samples the same way (``shard_indices`` without
shuffle), generates under the mesh's shard context, gathers the
predictions on every rank and drops the duplicates the wrap-around padding
and the tp and pp ranks made; only rank 0 logs steps and writes
checkpoints. A sharded mesh's checkpoint holds the gathered leaves (every
rank takes part in the gather, rank 0 writes), in the one-process format,
and a resume cuts the loaded leaves to the rank's blocks. Under a pipeline
(pp > 1) validation generates with the layers gathered over pp (every
stage holds the whole decoder while it generates, as JAX keeps it).
"""

from __future__ import annotations

import logging
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import kernels
from ..data.collate import collate_icl_batch
from ..data.packing import PackConfig
from ..data.pipeline import PrefetchIterator
from ..evaluation import evaluate_predictions
from ..models.qwen_audio import host_tower_frames
from ..parallel.multihost import gather_predictions, process_index, shard_indices
from ..parallel.sharding import (
    batch_shard,
    context_of,
    gather_params,
    gather_stages,
    is_sharded,
    shard_params,
    stage_params,
)
from ..registry import DatasetType
from .checkpoint import copy_into, load_checkpoint, save_checkpoint
from .step import TrainState, merge_params

logger = logging.getLogger(__name__)


@dataclass
class TrainSettings:
    num_epochs: int = 3
    batch_size: int = 2
    save_every: int = 1
    output_dir: str = "checkpoints"
    val_max_samples: int = 200
    resume_from: Optional[str] = None
    val_batch_size: int = 4
    seed: int = 42  # data-order seed (per-epoch reshuffle)


def local_rows(rows, rank: int = 0, world: int = 1):
    """This rank's contiguous ``len(rows) / world`` rows of a global batch."""
    if len(rows) % world:
        raise ValueError(f"a global batch of {len(rows)} does not split over {world} ranks")
    n = len(rows) // world
    return rows[rank * n:(rank + 1) * n]


def batch_arrays(batch) -> Dict[str, np.ndarray]:
    """A collated train batch → the step's inputs, as numpy arrays."""
    arrays = {"text_tokens": batch.text_tokens, "gather_idx": batch.gather_idx,
              "seq_mask": batch.seq_mask, "shifted_labels": batch.labels_shifted,
              **batch.audio}
    return {k: np.asarray(v) for k, v in arrays.items()}


def _device_batch(batch, device) -> Dict[str, Any]:
    out = {k: torch.as_tensor(v, device=device) for k, v in batch_arrays(batch).items()}
    if "audio_lengths" in batch.audio:  # Qwen2-Audio's tower frames, from the host copy
        out["tower_frames"] = host_tower_frames(batch.audio["audio_lengths"])
    return out


def iter_batches(dataset, batch_size: int, tokenizer, pack_cfg: PackConfig, order,
                 rank: int = 0, world: int = 1):
    """Fixed-size global batches in ``order``, the tail batch padded by
    repeating its last sample; each yields this rank's ``local_rows``."""
    order = list(order)
    for start in range(0, len(order), batch_size):
        # every rank reads the whole global batch: a dataset may draw on each
        # access (SQA's exemplars), and the draws must follow one process's
        samples = [dataset[int(i)] for i in order[start:start + batch_size]]
        while len(samples) < batch_size:
            samples.append(samples[-1])
        yield collate_icl_batch(local_rows(samples, rank, world), tokenizer, pack_cfg)


def validate(engine, val_dataset, pack_cfg: PackConfig, dataset_types: List[DatasetType],
             settings: TrainSettings, rank: int = 0, world: int = 1) -> Dict[str, Any]:
    """Generation-based validation with per-dataset metrics; over ``world``
    ranks each generates its shard and the predictions are gathered."""
    results = []
    n = min(len(val_dataset), settings.val_max_samples)
    order = list(shard_indices(n, shuffle=False, process_id=rank, num_processes=world))
    bs = settings.val_batch_size
    for start in range(0, len(order), bs):
        samples = [val_dataset[int(i)] for i in order[start:start + bs]]
        real = len(samples)
        while len(samples) < bs:
            samples.append(samples[-1])
        batch = collate_icl_batch(samples, engine.tokenizer, pack_cfg)
        preds = engine.generate(batch, batch.audio)[:real]
        for s, p, gi in zip(samples[:real], preds, order[start:start + bs]):
            # the global index: shard_indices pads by wrapping, so a sample
            # can be generated on two ranks — deduplicated below
            results.append({"text": s.extras.get("text", ""), "true_label": s.completion,
                            "predicted_label": p,
                            "dataset_type": s.extras.get("dataset_type", ""),
                            "_index": int(gi)})
    if world > 1:
        results = gather_predictions(results)
    seen, deduped = set(), []
    for r in results:
        gi = r.pop("_index")
        if gi not in seen:
            seen.add(gi)
            deduped.append(r)
    results = deduped
    metrics = {}
    for dt in dataset_types:
        subset = [r for r in results if r["dataset_type"] == dt.value]
        if subset:
            metrics[dt.value] = evaluate_predictions(subset, dt)
    return metrics


class StepTimer:
    """Per-step seconds on the host's clock, examples/s, and each step's
    launches of every kernel wrapper, with no synchronisation: the step's
    own ``.item()`` reads hold the host to the device's pace.
    ``summary()`` adds ``device_step_seconds``, each timed step's device
    interval from forward through update (``step_fn.timings()``), where the
    step marks one (CUDA, no mesh)."""

    def __init__(self, step_fn: Callable):
        self._timings = getattr(step_fn, "timings", None)
        self._first = len(self._timings()) if self._timings is not None else 0
        self.step_seconds: List[float] = []
        self.launches: List[Dict[str, int]] = []
        self.examples = 0

    def start(self):
        self._counts = kernels.launch_counts()
        self._t0 = time.perf_counter()

    def stop(self, examples: int):
        self.step_seconds.append(time.perf_counter() - self._t0)
        now = kernels.launch_counts()
        self.launches.append({k: now[k] - self._counts[k] for k in now})
        self.examples += examples

    def summary(self) -> Dict[str, Any]:
        total = sum(self.step_seconds)
        out = {"steps": len(self.step_seconds), "examples": self.examples,
               "total_seconds": total,
               "examples_per_sec": self.examples / total if total else 0.0,
               "p50_step_seconds": (statistics.median(self.step_seconds)
                                    if self.step_seconds else 0.0),
               "step_seconds": list(self.step_seconds),
               "launches_per_step": list(self.launches)}
        device = self._timings()[self._first:] if self._timings is not None else []
        if device:
            out["device_step_seconds"] = [sum(ms) / 1e3 for ms in device]
        return out


@dataclass
class TrainResult:
    state: TrainState
    model: Any = None  # the model trained (its params merged with the state's)
    skipped_batches: int = 0
    losses: List[float] = field(default_factory=list)
    checkpoints: List[str] = field(default_factory=list)
    perf: Dict[str, Any] = field(default_factory=dict)


def _blocks(tree, mesh):
    """A loaded numpy tree cut to this rank's blocks under a sharded mesh."""
    if not is_sharded(mesh):
        return tree
    return stage_params(shard_params(_tensors(tree), mesh), mesh)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _resume(state: TrainState, path: str, mesh=None) -> int:
    ck = load_checkpoint(path)
    copy_into(state.trainable, _blocks(ck["trainable"], mesh))
    state.step = int(ck.get("step", 0))
    saved = ck.get("opt_state")
    if saved is not None:
        try:
            for key in ("mu", "nu", "acc"):
                if key in state.opt_state:
                    copy_into(state.opt_state[key], _blocks(saved[key], mesh))
            state.opt_state["count"] = int(saved["count"])
            state.opt_state["mini_step"] = int(saved["mini_step"])
        except (KeyError, RuntimeError) as e:
            logger.warning(f"optimizer state restore skipped: {e}")
    epoch = int(ck.get("meta", {}).get("epoch", 0))
    logger.info(f"Resumed from {path} at epoch {epoch}")
    return epoch


def train(model, state: TrainState, frozen: Dict[str, Any], step_fn: Callable,
          train_dataset, pack_cfg: PackConfig, settings: TrainSettings, val_dataset=None,
          dataset_types: Optional[List[DatasetType]] = None,
          metadata: Optional[Dict[str, Any]] = None, mesh=None) -> TrainResult:
    """Run the training schedule on the model's device; with a ``mesh`` this
    rank's share of it (module docstring; ``step_fn`` built on the same
    mesh)."""
    device = model.engine.device
    rank, world = batch_shard(mesh)
    main = process_index() == 0
    sharded = is_sharded(mesh)
    if sharded:
        model.engine.shard = context_of(mesh)
    timer = StepTimer(step_fn)
    result = TrainResult(state, model)
    start_epoch = _resume(state, settings.resume_from, mesh) if settings.resume_from else 0
    last_loss = float("nan")
    for epoch in range(start_epoch, settings.num_epochs):
        # the same permutation on every rank: each steps its rows of a batch
        order = shard_indices(len(train_dataset), epoch, seed=settings.seed,
                              process_id=0, num_processes=1)
        batches = PrefetchIterator(
            lambda order=order: iter_batches(train_dataset, settings.batch_size,
                                             model.tokenizer, pack_cfg, order, rank, world),
            depth=2)
        try:
            for batch in batches:
                timer.start()
                try:
                    state, metrics = step_fn(state, frozen, _device_batch(batch, device))
                except KeyboardInterrupt:
                    raise
                except Exception as e:
                    result.skipped_batches += 1
                    logger.warning(f"skipping batch after error: {e!r}")
                    continue
                timer.stop(settings.batch_size)
                last_loss = metrics["loss"]
                result.losses.append(last_loss)
                if metrics["skipped_nonfinite"]:
                    logger.warning("non-finite loss — batch became a no-op update")
                if main:
                    logger.info(f"step {metrics['step']}: loss {last_loss:.4f} grad_norm "
                                f"{metrics['grad_norm']:.4f} {timer.step_seconds[-1]:.3f} s")
        except KeyboardInterrupt:
            logger.info("KeyboardInterrupt — stopping training early")
            break
        if hasattr(train_dataset, "on_epoch_end"):
            train_dataset.on_epoch_end()

        if val_dataset is not None and dataset_types:
            # validation generates with the CURRENT trainable weights
            model.params = merge_params(frozen, state.trainable)
            model.engine.params = gather_stages(model.params, mesh)
            val_metrics = validate(model.engine, val_dataset, pack_cfg, dataset_types, settings,
                                   rank, world)
            model.engine.params = model.params
            if main:
                logger.info(f"epoch {epoch} validation: " + ", ".join(
                    f"{k}={_headline(v):.4f}" for k, v in val_metrics.items()))

        if settings.save_every and (epoch + 1) % settings.save_every == 0:
            trainable, opt_state = state.trainable, state.opt_state
            if sharded:  # every rank gathers; rank 0 writes
                trainable = gather_params(trainable, mesh)
                opt_state = {k: gather_params(v, mesh) if isinstance(v, dict) else v
                             for k, v in opt_state.items()}
            if main:
                path = os.path.join(settings.output_dir,
                                    f"epoch_{epoch}_loss_{last_loss:.4f}")
                result.checkpoints.append(save_checkpoint(
                    path, trainable, opt_state=opt_state, step=state.step, epoch=epoch + 1,
                    loss=last_loss, metadata=metadata))
    result.state = state
    result.perf = timer.summary()
    if result.skipped_batches:
        logger.warning(f"{result.skipped_batches} batches skipped after errors")
    return result


def _headline(metrics: Dict[str, Any]) -> float:
    """Headline metric per task."""
    for key in ("macro_f1_with_invalid", "macro_f1", "f1_score", "accuracy"):
        if key in metrics:
            return float(metrics[key])
    return 0.0
