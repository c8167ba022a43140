"""Multi-phase training schedules for the symbol adapter.

A copy of ``icl_speech_text_llm_tpu/symbol_adapter/schedulers.py``. Parity
with the reference TrainingScheduler / TrainingStep
(ref: models/symbolAdapter/training/schedulers.py:11-465): six modes, phase →
freeze-flag derivation in __post_init__, JSON persistence.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .configs import TrainingConfig, TrainingMode

logger = logging.getLogger(__name__)


@dataclass
class TrainingStep:
    phase: str  # "lora" | "mlp" | "joint" | ...
    epochs: int
    cycle: int
    step_id: int
    description: str
    learning_rate: Optional[float] = None
    gradient_accumulation_steps: Optional[int] = None
    max_grad_norm: Optional[float] = None
    freeze_mlp: bool = True
    freeze_lora: bool = True
    use_symbols: bool = True
    dynamic_symbols: bool = False
    bypass_mlp: bool = False

    def __post_init__(self):
        """Phase → freeze flags (ref :32-48)."""
        if self.phase == "mlp":
            self.freeze_mlp = False
            self.freeze_lora = True
        elif self.phase == "lora":
            self.freeze_mlp = True
            self.freeze_lora = False
        elif self.phase == "joint":
            self.freeze_mlp = False
            self.freeze_lora = False
            self.dynamic_symbols = True
        else:
            self.freeze_mlp = True
            self.freeze_lora = True
            self.use_symbols = False
            self.dynamic_symbols = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "phase": self.phase, "epochs": self.epochs, "cycle": self.cycle,
            "step_id": self.step_id, "description": self.description,
            "learning_rate": self.learning_rate,
            "gradient_accumulation_steps": self.gradient_accumulation_steps,
            "max_grad_norm": self.max_grad_norm,
            "freeze_mlp": self.freeze_mlp, "freeze_lora": self.freeze_lora,
            "use_symbols": self.use_symbols, "dynamic_symbols": self.dynamic_symbols,
            "bypass_mlp": self.bypass_mlp,
        }


class TrainingScheduler:
    def __init__(self, config: TrainingConfig):
        self.config = config
        self.schedule: List[TrainingStep] = []

    def generate_schedule(self) -> List[TrainingStep]:
        gen = {
            TrainingMode.LORA_FIRST: self._lora_first,
            TrainingMode.MLP_FIRST: self._mlp_first,
            TrainingMode.JOINT_TRAINING: self._joint,
            TrainingMode.BYPASS_MLP_SYM: self._bypass_sym,
            TrainingMode.BYPASS_MLP_ORG: self._bypass_org,
            TrainingMode.LORA_MLP_JOINT: self._lora_mlp_joint,
        }.get(self.config.mode)
        if gen is None:
            raise ValueError(f"Unknown training mode: {self.config.mode}")
        self.schedule = gen()
        for step in self.schedule:
            logger.info(
                f"schedule[{step.step_id}] {step.phase} x{step.epochs}ep "
                f"(cycle {step.cycle}): {step.description}"
            )
        return self.schedule

    def _lora_step(self, step_id, cycle, epochs, description, **kw) -> TrainingStep:
        lc = self.config.lora_config
        return TrainingStep(
            phase="lora", epochs=epochs, cycle=cycle, step_id=step_id,
            description=description, learning_rate=lc.learning_rate,
            gradient_accumulation_steps=lc.gradient_accumulation_steps,
            max_grad_norm=lc.max_grad_norm, **kw,
        )

    def _mlp_step(self, step_id, cycle, epochs, description, **kw) -> TrainingStep:
        mc = self.config.mlp_config
        return TrainingStep(
            phase="mlp", epochs=epochs, cycle=cycle, step_id=step_id,
            description=description, learning_rate=mc.learning_rate,
            gradient_accumulation_steps=mc.gradient_accumulation_steps,
            max_grad_norm=mc.max_grad_norm, **kw,
        )

    def _lora_first(self) -> List[TrainingStep]:
        """Initial LoRA → [MLP, LoRA] cycles → Final LoRA (ref :101-160)."""
        c = self.config
        out = [self._lora_step(0, 0, c.lora_config.initial_epochs,
                               "Initial LoRA training - task learning")]
        sid = 1
        for cycle in range(c.total_cycles):
            out.append(self._mlp_step(sid, cycle, c.mlp_config.epochs,
                                      f"Cycle {cycle+1} MLP training - learn symbols"))
            sid += 1
            out.append(self._lora_step(sid, cycle, c.lora_config.epochs,
                                       f"Cycle {cycle+1} LoRA training - task adaptation"))
            sid += 1
        out.append(self._lora_step(sid, c.total_cycles, c.lora_config.final_epochs,
                                   "Final LoRA training - task optimization"))
        return out

    def _mlp_first(self) -> List[TrainingStep]:
        """Initial MLP → [LoRA, MLP] cycles → Final LoRA (ref :162-222)."""
        c = self.config
        out = [self._mlp_step(0, 0, c.mlp_config.initial_epochs,
                              "Initial MLP training - learn symbol representations")]
        sid = 1
        for cycle in range(c.total_cycles):
            out.append(self._lora_step(sid, cycle, c.lora_config.epochs,
                                       f"Cycle {cycle+1} LoRA training - task adaptation"))
            sid += 1
            out.append(self._mlp_step(sid, cycle, c.mlp_config.epochs,
                                      f"Cycle {cycle+1} MLP training - refine symbols"))
            sid += 1
        out.append(self._lora_step(sid, c.total_cycles, c.lora_config.final_epochs,
                                   "Final LoRA training - task optimization"))
        return out

    def _joint(self) -> List[TrainingStep]:
        """(ref :224-246)"""
        c = self.config
        out = []
        for cycle in range(c.total_cycles):
            out.append(TrainingStep(
                phase="joint",
                epochs=max(c.mlp_config.epochs, c.lora_config.epochs),
                cycle=cycle, step_id=cycle,
                description=f"Cycle {cycle+1} Joint MLP+LoRA training",
                learning_rate=None,
                gradient_accumulation_steps=c.lora_config.gradient_accumulation_steps,
                max_grad_norm=c.lora_config.max_grad_norm,
            ))
        return out

    def _bypass_sym(self) -> List[TrainingStep]:
        """Pure LoRA with dynamic symbols (ref :248-275)."""
        c = self.config
        out = []
        for cycle in range(c.total_cycles):
            step = self._lora_step(cycle, cycle, c.lora_config.epochs,
                                   f"Cycle {cycle+1} LoRA training - dynamic symbols",
                                   bypass_mlp=True)
            step.use_symbols = True
            step.dynamic_symbols = True
            out.append(step)
        return out

    def _bypass_org(self) -> List[TrainingStep]:
        """Pure LoRA, original labels (ref :277-304)."""
        c = self.config
        out = []
        for cycle in range(c.total_cycles):
            step = self._lora_step(cycle, cycle, c.lora_config.epochs,
                                   f"Cycle {cycle+1} LoRA training - dynamic symbols",
                                   bypass_mlp=True)
            step.use_symbols = False
            step.dynamic_symbols = False
            out.append(step)
        return out

    def _lora_mlp_joint(self) -> List[TrainingStep]:
        """LoRA only → MLP only → Joint (ref :306-355)."""
        c = self.config
        lora = self._lora_step(0, 0, c.lora_config.epochs,
                               "Initial LoRA training - bypass MLP completely",
                               bypass_mlp=True)
        mlp = self._mlp_step(1, 0, c.mlp_config.epochs,
                             "MLP training - LoRA frozen, build on stable foundation")
        joint = TrainingStep(
            phase="joint", epochs=c.lora_config.final_epochs, cycle=0, step_id=2,
            description="Joint training - fine-tune both LoRA and MLP together",
            learning_rate=min(c.lora_config.learning_rate, c.mlp_config.learning_rate) / 2,
            gradient_accumulation_steps=c.lora_config.gradient_accumulation_steps,
            max_grad_norm=c.lora_config.max_grad_norm,
        )
        return [lora, mlp, joint]

    # -- persistence (ref :425-465) -------------------------------------
    def save_schedule(self, filepath: str):
        with open(filepath, "w") as f:
            json.dump([s.to_dict() for s in self.schedule], f, indent=2)

    @staticmethod
    def load_schedule(filepath: str) -> List[TrainingStep]:
        with open(filepath) as f:
            raw = json.load(f)
        steps = []
        for d in raw:
            step = TrainingStep(
                phase=d["phase"], epochs=d["epochs"], cycle=d["cycle"],
                step_id=d["step_id"], description=d["description"],
                learning_rate=d.get("learning_rate"),
                gradient_accumulation_steps=d.get("gradient_accumulation_steps"),
                max_grad_norm=d.get("max_grad_norm"),
            )
            # restore explicit flags over the phase-derived defaults
            step.freeze_mlp = d["freeze_mlp"]
            step.freeze_lora = d["freeze_lora"]
            step.use_symbols = d["use_symbols"]
            step.dynamic_symbols = d["dynamic_symbols"]
            step.bypass_mlp = d.get("bypass_mlp", False)
            steps.append(step)
        return steps
