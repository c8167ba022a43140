"""The port's CLIs on the tasks scored by the multi-label, span and QA
metrics, on the CPU with salmonn-tiny and synthetic data: inference writes
its metrics file for each task, and training on HVB validates and then saves
its epoch checkpoint (validation runs before the save)."""

import glob
import json
import os

import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("dataset_type", ["hvb", "voxpopuli", "voxpopuli_nel", "sqa"])
def test_inference_cli_writes_metrics(dataset_type, tmp_path):
    from icl_speech_text_llm_tpu_torch.cli import inference

    paths = inference.main([
        "--model_type", "salmonn-tiny", "--dataset_type", dataset_type, "--synthetic",
        "--synthetic_size", "8", "--fewshot_mode", "speech", "--num_examples", "1",
        "--batch_size", "2", "--max_samples", "2", "--seq_len", "512", "--text_len", "256",
        "--max_new_tokens", "4", "--device", "cpu", "--results_dir", str(tmp_path)])
    metrics = json.load(open(paths["metrics"]))
    scored = metrics[dataset_type]
    assert "error" not in scored, scored
    total = scored.get("total_samples")
    assert total == 2, scored


def test_train_cli_validates_hvb_and_saves_the_epoch(tmp_path, caplog):
    from icl_speech_text_llm_tpu_torch.cli import train

    out = tmp_path / "ckpt"
    with caplog.at_level("INFO"):
        result = train.main([
            "--model_type", "salmonn-tiny", "--dataset_type", "hvb", "--synthetic",
            "--num_epochs", "1", "--batch_size", "2", "--max_samples", "4", "--seq_len", "768",
            "--text_len", "384", "--val_max_samples", "2", "--device", "cpu",
            "--output_dir", str(out)])
    assert result.skipped_batches == 0
    assert any("epoch 0 validation: hvb=" in r.getMessage() for r in caplog.records)
    ckpts = glob.glob(os.path.join(out, "epoch_0_loss_*"))
    assert len(ckpts) == 1 and os.path.exists(os.path.join(ckpts[0], "state.npy"))
