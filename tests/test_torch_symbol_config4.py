"""BASELINE.md config 4 through the port: MELD emotion + SQA symbol
training (``bypass_mlp_sym``) on salmonn-tiny on the CPU, with the settings
of the JAX package's ``tests/test_driver_configs.py:74``, plus the
orchestrator's checkpoint of the run."""

import glob
import os

import numpy as np
import torch

from icl_speech_text_llm_tpu_torch.symbol_adapter import (
    TrainingConfig,
    TrainingMode,
    build_training_world,
)
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt

torch.set_num_threads(1)


def test_baseline_config4_meld_emotion_sqa_symbol_training(tmp_path):
    """BASELINE.md config #4 on the port: symbol-adapter unified training
    over MELD_EMOTION + SQA (ref orchestrator_training.py:43-110)."""
    cfg = TrainingConfig(mode=TrainingMode.BYPASS_MLP_SYM, total_cycles=1,
                         model_type="salmonn-tiny")
    cfg.output_dir = str(tmp_path / "config4")
    d = cfg.data_config
    d.dataset_type, d.val_dataset_type = "meld_emotion-sqa", "meld_emotion"
    d.batch_size, d.max_samples, d.val_max_samples, d.val_batch_size = 2, 4, 2, 2
    d.num_examples, d.fewshot_mode, d.synthetic = 1, "text", True
    cfg.lora_config.epochs = cfg.lora_config.final_epochs = 1

    orch = build_training_world(cfg, seed=0, device="cpu")
    labels = set(orch.trainer.symbol_manager.original_labels)
    assert {"anger", "joy", "sadness"} <= labels  # MELD emotion's; SQA carries none
    assert orch.trainer.pack_cfg.max_slots == 2  # SQA: question + document audio
    out = orch.run_complete_training()
    assert len(out["summaries"]) == 1
    assert all(np.isfinite(s["final_loss"]) for s in out["summaries"])
    val = out["summaries"][0]["epochs"][0]["val"]
    assert all(c.startswith("meld_emotion:") for c in val.values()) and len(val) == 3
    (ck,) = glob.glob(os.path.join(cfg.output_dir, "lora_step0_cycle0"))
    assert set(tckpt.load_checkpoint(ck)["trainable"]) == {"lora", "mlp_adapter"}
