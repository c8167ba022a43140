"""The port's slice as a whole against the JAX package: data → packed batch →
salmonn-tiny generation → cleaning → metrics.

Greedy tokens must be identical: the same JAX-initialized parameters
(bridged name for name) and the same packed batch go through the JAX
package's jitted ``salmonn_generate`` and the port's, in f32 on the CPU.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.data import collate as jcollate
from icl_speech_text_llm_tpu.data import factory as jfactory
from icl_speech_text_llm_tpu.data.packing import PackConfig as JPackConfig
from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.models.salmonn import init_salmonn, salmonn_tiny
from icl_speech_text_llm_tpu import registry as jregistry
from icl_speech_text_llm_tpu.utils.tokenization import get_tokenizer as jax_tokenizer
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data import collate as tcollate
from icl_speech_text_llm_tpu_torch.data import factory as tfactory
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.evaluation import clean_prediction, evaluate_predictions
from icl_speech_text_llm_tpu_torch import registry as tregistry
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.registry import DatasetType
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
K = 2  # speech exemplars per request


def _dataset(factory, registry):
    """The same synthetic requests through either package, each with its own
    registry's enums."""
    return factory.create_dataset(
        registry.DatasetType.VOXCELEB, split=registry.DatasetSplit.TEST,
        input_mode="speech_only",
        fewshot_mode="speech", num_examples=K, max_samples=4, synthetic=True,
        synthetic_size=8, seed=3)


def _pack_cfg(cls):
    return cls(seq_len=768, text_len=384, max_slots=K + 1,
               audio_tokens_per_slot=tsalmonn.salmonn_tiny().audio_tokens_per_slot)


@pytest.fixture(scope="module")
def packed():
    tok = get_tokenizer()
    samples = [_dataset(tfactory, tregistry)[i] for i in range(2)]
    return tcollate.collate_icl_batch(samples, tok, _pack_cfg(PackConfig))


def test_data_pipeline_packs_the_same_batch_as_jax(packed):
    ref = jcollate.collate_icl_batch([_dataset(jfactory, jregistry)[i] for i in range(2)],
                                     jax_tokenizer(),
                                     _pack_cfg(JPackConfig))
    for name in ("text_tokens", "gather_idx", "seq_mask", "seq_lengths", "labels",
                 "labels_shifted", "num_slots_used"):
        np.testing.assert_array_equal(getattr(packed, name), getattr(ref, name), err_msg=name)
    assert packed.prompts == ref.prompts and packed.completions == ref.completions
    np.testing.assert_array_equal(packed.audio["wavs"], ref.audio["wavs"])


@pytest.fixture(scope="module")
def tiny_world(packed):
    jparams = init_salmonn(jax.random.PRNGKey(0), salmonn_tiny())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    batch = {"text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
             "seq_lengths": packed.seq_lengths, "wavs": packed.audio["wavs"]}
    return jparams, tparams, batch


def _generate_both(world, eos=2, **kw):
    jparams, tparams, batch = world
    gen_kw = dict(max_new_tokens=10, eos_token_id=eos, pad_token_id=0, **kw)
    want = np.asarray(jax.jit(functools.partial(
        jengine.salmonn_generate, salmonn_tiny(), jengine.GenerationConfig(**gen_kw)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tengine.salmonn_generate(
        tsalmonn.salmonn_tiny(), tengine.GenerationConfig(**gen_kw), tparams,
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}).numpy()
    return got, want


@pytest.fixture(scope="module")
def default_tokens(tiny_world):
    return _generate_both(tiny_world, eos=2)


def test_salmonn_tiny_greedy_tokens_identical_to_jax(default_tokens):
    got, want = default_tokens
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)


def test_tokens_after_eos_are_pad_as_in_jax(tiny_world, default_tokens):
    """EOS set to a token the first sample emits at step 3: both engines stop
    that sample there (pad after it) and keep decoding the other."""
    eos = int(default_tokens[0][0, 3])
    got, want = _generate_both(tiny_world, eos=eos)
    np.testing.assert_array_equal(got, want)
    stop = int(np.argmax(got[0] == eos))
    assert stop <= 3 and np.all(got[0, stop + 1:] == 0)


def test_generation_config_refuses_unported_options(tiny_world):
    """Every generation option of the JAX package is ported: JAX's
    scanned-layer decode (``use_flash_decode=False``) is accepted and
    decodes, as do the other options; only a value JAX has no meaning for
    is refused."""
    with pytest.raises(ValueError):
        tengine.GenerationConfig(use_flash_decode="pallas")
    for kw in ({"do_sample": True}, {"num_beams": 2}, {"repetition_penalty": 1.2},
               {"min_new_tokens": 1}, {"kv_int8": True}, {"use_flash_decode": True},
               {"use_flash_decode": False}):
        tengine.GenerationConfig(**kw)
    got, want = _generate_both(tiny_world, use_flash_decode=False)
    np.testing.assert_array_equal(got, want)


def test_cli_runs_the_slice_on_cpu(tmp_path):
    from icl_speech_text_llm_tpu_torch.cli import inference

    paths = inference.main([
        "--model_type", "salmonn-tiny", "--dataset_type", "voxceleb", "--synthetic",
        "--synthetic_size", "8", "--fewshot_mode", "speech", "--num_examples", "1",
        "--batch_size", "2", "--max_samples", "3", "--seq_len", "512", "--text_len", "256",
        "--max_new_tokens", "4", "--device", "cpu", "--results_dir", str(tmp_path)])
    results = json.load(open(paths["results"]))
    metrics = json.load(open(paths["metrics"]))
    assert len(results["results"]) == 3
    assert all(len(r["tokens"]) == 4 for r in results["results"])
    assert results["perf"]["batches"] == 2 and "voxceleb" in metrics
    # --auto_batch measures the card's allocator: on the CPU there is none to read
    with pytest.raises(ValueError, match="CUDA"):
        inference.main(["--auto_batch", "--model_type", "salmonn-tiny", "--synthetic", "--synthetic_size", "4",
         "--max_samples", "2", "--fewshot_mode", "none", "--seq_len", "512", "--text_len", "256",
         "--device", "cpu", "--results_dir", str(tmp_path)])
    # --peft_model_path is ported (tests/test_torch_load.py): a dir without a
    # checkpoint is an error of the load, not of the flag
    with pytest.raises(FileNotFoundError):
        inference.main(["--peft_model_path", str(tmp_path), "--device", "cpu",
                        "--results_dir", str(tmp_path)])


def test_clean_prediction_matches_golden():
    with open(os.path.join(GOLDEN, "clean_prediction.json")) as f:
        fixtures = json.load(f)
    for fx in fixtures:
        assert clean_prediction(fx["raw"], DatasetType(fx["dataset_type"])) == fx["cleaned"], fx


def _preds(pairs):
    return [{"text": f"t{i}", "true_label": g, "predicted_label": p}
            for i, (g, p) in enumerate(pairs)]


def _approx_equal(a, b, path=""):
    if isinstance(a, float) or isinstance(b, float):
        af, bf = float(a), float(b)
        if np.isnan(af) and np.isnan(bf):
            return
        assert af == pytest.approx(bf, rel=1e-9, abs=1e-12), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _approx_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _approx_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("dataset_type,pairs", [
    (DatasetType.VOXCELEB, [
        ("positive", "positive"), ("negative", "Positive"), ("neutral", "garbage out"),
        ("positive", "I think positive"), ("negative", "negative"), ("neutral", "neutral"),
        ("positive", "negative"), ("invalid_gt", "positive"), ("neutral", ""),
        ("negative", "neg")]),
    (DatasetType.MELD_EMOTION, [
        ("joy", "joy"), ("anger", "angry"), ("neutral", "neutral"),
        ("surprise", "surprise!"), ("fear", "I sense fear here"), ("disgust", "joy"),
        ("sadness", "sad")]),
])
def test_single_label_metrics_match_golden(dataset_type, pairs):
    with open(os.path.join(GOLDEN, "metrics.json")) as f:
        golden = json.load(f)
    _approx_equal(golden[dataset_type.value], evaluate_predictions(_preds(pairs), dataset_type))


def test_other_task_metrics_are_not_ported():
    """Every task is scored now: an HVB batch gets the multi-label dict of
    the golden case (tests/test_torch_metrics.py holds every task to JAX)."""
    with open(os.path.join(GOLDEN, "metrics.json")) as f:
        golden = json.load(f)
    pairs = [("acknowledge, answer_agree", "acknowledge"), ("thanks", "thanks, other"),
             ("backchannel", "backchannel"), ("statement_open, thanks", "statement_open, thanks"),
             ("question_check", "nonsense"), ("other", ""),
             ("acknowledge", "acknowledge, acknowledge"), ("disfluency, self", "self")]
    _approx_equal(golden["hvb"], evaluate_predictions(_preds(pairs), DatasetType.HVB))
