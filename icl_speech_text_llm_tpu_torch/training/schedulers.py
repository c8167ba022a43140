"""Learning-rate schedules: functions of the optimizer-update count.

Counterpart of ``icl_speech_text_llm_tpu/training/schedulers.py``: the HF
``get_scheduler`` names the reference's ``--scheduler`` flag takes, plus the
symbol trainer's per-epoch warmup-restart cosine. The JAX schedules evaluate
in f32; these do the same arithmetic in numpy f32, in the same order, and
return a Python float.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f = np.float32


def _clip01(x):
    return np.clip(x, _f(0.0), _f(1.0))


def linear_schedule_with_warmup(base_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """HF "linear": ramp 0→lr over warmup, then linear decay to 0."""

    def fn(step):
        step = _f(step)
        warm = step / _f(max(1.0, warmup_steps))
        decay = (_f(total_steps) - step) / _f(max(1.0, total_steps - warmup_steps))
        return float(_f(base_lr) * _clip01(warm if step < warmup_steps else decay))

    return fn


def cosine_schedule_with_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                                num_cycles: float = 0.5) -> Schedule:
    """HF "cosine": ramp then cosine decay to 0."""

    def fn(step):
        step = _f(step)
        warm = step / _f(max(1.0, warmup_steps))
        progress = (step - _f(warmup_steps)) / _f(max(1.0, total_steps - warmup_steps))
        cos = _f(0.5) * (_f(1.0) + np.cos(_f(np.pi * 2.0 * num_cycles) * progress))
        val = _clip01(warm) if step < warmup_steps else np.maximum(cos, _f(0.0))
        return float(_f(base_lr) * val)

    return fn


def per_epoch_warmup_restart_cosine(base_lr: float, steps_per_epoch: int,
                                    warmup_ratio: float = 0.1,
                                    min_lr_ratio: float = 0.01) -> Schedule:
    """The symbol trainer's schedule: every epoch restarts with a fresh
    warmup, then cosine-decays within the epoch."""
    warmup_steps = max(1, int(steps_per_epoch * warmup_ratio))

    def fn(step):
        step_in_epoch = np.mod(_f(step), _f(steps_per_epoch))
        warm = step_in_epoch / _f(warmup_steps)
        progress = (step_in_epoch - _f(warmup_steps)) / _f(max(1.0, steps_per_epoch - warmup_steps))
        cos = _f(min_lr_ratio) + _f((1 - min_lr_ratio) * 0.5) * (
            _f(1.0) + np.cos(_f(np.pi) * progress))
        val = _clip01(warm) if step_in_epoch < warmup_steps else cos
        return float(_f(base_lr) * val)

    return fn


def cosine_hard_restarts_schedule_with_warmup(base_lr: float, warmup_steps: int,
                                              total_steps: int, num_cycles: int = 1) -> Schedule:
    """HF "cosine_with_restarts": ramp, then num_cycles hard cosine restarts
    (0 past total_steps)."""

    def fn(step):
        step = _f(step)
        warm = step / _f(max(1.0, warmup_steps))
        progress = (step - _f(warmup_steps)) / _f(max(1.0, total_steps - warmup_steps))
        cyc = np.mod(_f(num_cycles) * progress, _f(1.0))
        cos = _f(0.0) if progress >= 1.0 else _f(0.5) * (_f(1.0) + np.cos(_f(np.pi) * cyc))
        val = _clip01(warm) if step < warmup_steps else np.maximum(cos, _f(0.0))
        return float(_f(base_lr) * val)

    return fn


def constant_schedule_with_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    """HF "constant_with_warmup": ramp 0→lr over warmup, then hold."""

    def fn(step):
        return float(_f(base_lr) * _clip01(_f(step) / _f(max(1.0, warmup_steps))))

    return fn


def polynomial_schedule_with_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                                    lr_end: float = 1e-7, power: float = 1.0) -> Schedule:
    """HF "polynomial": ramp, then (lr − lr_end)·(1 − progress)^power + lr_end,
    held at lr_end past total_steps."""

    def fn(step):
        step = _f(step)
        if step < warmup_steps:
            return float(_f(base_lr) * _clip01(step / _f(max(1.0, warmup_steps))))
        remaining = _clip01((_f(total_steps) - step) / _f(max(1.0, total_steps - warmup_steps)))
        return float(_f(base_lr - lr_end) * remaining ** _f(power) + _f(lr_end))

    return fn


def inverse_sqrt_schedule_with_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    """HF "inverse_sqrt": ramp, then lr · sqrt(warmup / step)."""

    def fn(step):
        step = _f(step)
        if step < warmup_steps:
            val = _clip01(step / _f(max(1.0, warmup_steps)))
        else:
            val = np.sqrt(_f(max(1.0, warmup_steps)) / np.maximum(step, _f(1.0)))
        return float(_f(base_lr) * val)

    return fn


def get_schedule(name: str, base_lr: float, warmup_steps: int, total_steps: int,
                 steps_per_epoch: int = 0, num_cycles: float = 0.5,
                 power: float = 1.0) -> Schedule:
    """Resolve by the reference's ``--scheduler`` flag values."""
    if name == "linear":
        return linear_schedule_with_warmup(base_lr, warmup_steps, total_steps)
    if name == "cosine":
        return cosine_schedule_with_warmup(base_lr, warmup_steps, total_steps)
    if name == "cosine_with_restarts":
        return cosine_hard_restarts_schedule_with_warmup(
            base_lr, warmup_steps, total_steps, num_cycles=max(int(num_cycles), 1))
    if name == "constant":
        return lambda step: base_lr
    if name == "constant_with_warmup":
        return constant_schedule_with_warmup(base_lr, warmup_steps)
    if name == "polynomial":
        return polynomial_schedule_with_warmup(base_lr, warmup_steps, total_steps, power=power)
    if name == "inverse_sqrt":
        return inverse_sqrt_schedule_with_warmup(base_lr, warmup_steps)
    if name == "per_epoch_warmup_restart":
        if steps_per_epoch <= 0:
            raise ValueError("per_epoch_warmup_restart needs steps_per_epoch")
        return per_epoch_warmup_restart_cosine(base_lr, steps_per_epoch)
    raise ValueError(f"Unknown scheduler: {name}")
