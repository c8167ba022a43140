"""SALMONN's published pre-Q-Former norms in the port: ``ln_speech`` over
Whisper's columns and ``ln_audio`` over BEATs' (``QFormerConfig.
norm_widths``), BERT's embeddings LayerNorm folded into the query tokens
at conversion, and the encode stages' profiler ranges. The JAX package
normalises jointly; its parity tests run the joint norm (``tiny-test``,
``salmonn_tiny``) and are not touched here."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from icl_speech_text_llm_tpu_torch import registry as tregistry
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data import factory as tdata
from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import convert as tconvert
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.models import qformer as tqformer
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.models import synth_ckpt as tsynth
from icl_speech_text_llm_tpu_torch.utils import perf

torch.set_num_threads(1)

W1, W2 = 48, 32  # the Whisper and BEATs columns of a tiny Q-Former
SPLIT = tqformer.QFormerConfig(encoder_width=W1 + W2, dim=32, n_heads=4, n_layers=2,
                               llm_dim=64, norm_widths=(W1, W2), ln_eps=1e-12)
JOINT = dataclasses.replace(SPLIT, norm_widths=())


def _params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = tqformer.init_qformer(cfg, gen, "cpu", torch.float32)
    ln = params["ln_input"]
    ln["w"] = 1.0 + 0.3 * torch.randn(ln["w"].shape, generator=gen)
    ln["b"] = 0.1 * torch.randn(ln["b"].shape, generator=gen)
    return params


def _features(seed=1, batch=2):
    """Encoder outputs whose blocks differ in offset and scale, as Whisper's
    and BEATs' do."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 1500, W1 + W2, generator=gen)
    x[..., :W1] = 0.5 + 0.7 * x[..., :W1]
    x[..., W1:] = -1.0 + 3.0 * x[..., W1:]
    return x


def _two_norms(x, ln):
    return torch.cat([F.layer_norm(x[..., :W1], (W1,), ln["w"][:W1], ln["b"][:W1]),
                      F.layer_norm(x[..., W1:], (W2,), ln["w"][W1:], ln["b"][W1:])], dim=-1)


def test_the_split_norm_is_one_layer_norm_per_block():
    ln = _params(SPLIT)["ln_input"]
    x = _features()
    torch.testing.assert_close(tqformer.input_norm(SPLIT, ln, x), _two_norms(x, ln),
                               rtol=1e-5, atol=1e-5)
    joint = F.layer_norm(x, (W1 + W2,), ln["w"], ln["b"])
    torch.testing.assert_close(tqformer.input_norm(JOINT, ln, x), joint, rtol=1e-5, atol=1e-5)


def test_qformer_windows_normalises_whisper_and_beats_apart(monkeypatch):
    params, x = _params(SPLIT), _features()
    got = tqformer.qformer_windows(SPLIT, params, x)
    monkeypatch.setattr(tqformer, "input_norm", lambda cfg, ln, feats: _two_norms(feats, ln))
    want = tqformer.qformer_windows(SPLIT, params, x)
    assert got.shape == (2, SPLIT.n_windows, SPLIT.llm_dim)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_joint_norm_is_another_function():
    params, x = _params(SPLIT), _features()
    split = tqformer.qformer_windows(SPLIT, params, x)
    joint = tqformer.qformer_windows(JOINT, params, x)
    assert (split - joint).abs().max() > 0.1 * split.abs().max()


def test_norm_widths_must_cover_the_features():
    with pytest.raises(ValueError, match="do not add up"):
        dataclasses.replace(SPLIT, norm_widths=(W1, W2 - 1))


def test_the_salmonn_presets_take_the_published_norms_and_tiny_keeps_the_joint_one():
    for make in (tsalmonn.salmonn_13b, tsalmonn.salmonn_7b):
        cfg = make()
        assert cfg.qformer.norm_widths == (cfg.whisper.dim, cfg.beats.dim) == (1280, 768)
        assert cfg.qformer.ln_eps == 1e-12
    for cfg in (tsalmonn.salmonn_tiny().qformer, tqformer.QFORMER_CONFIGS["tiny-test"]):
        assert cfg.norm_widths == () and cfg.ln_eps == 1e-5


def _checkpoint(embeddings_norm: bool):
    llm = tsalmonn.salmonn_tiny().llm
    sd = tsynth.salmonn_v1_state_dict(SPLIT, llm, whisper_dim=W1, beats_dim=W2, rank=4, seed=5)
    if embeddings_norm:
        gen = torch.Generator().manual_seed(6)
        sd["speech_Qformer.bert.embeddings.LayerNorm.weight"] = (
            1.0 + 0.2 * torch.randn(SPLIT.dim, generator=gen)).numpy()
        sd["speech_Qformer.bert.embeddings.LayerNorm.bias"] = (
            0.1 * torch.randn(SPLIT.dim, generator=gen)).numpy()
    return sd, llm


def _tree(sd, llm):
    return params_from_numpy(tconvert.convert_salmonn_checkpoint(sd, SPLIT, llm)["qformer"],
                             "cpu")


def test_folding_the_embeddings_norm_equals_applying_it():
    sd, llm = _checkpoint(embeddings_norm=True)
    folded = _tree(sd, llm)
    raw = _tree({k: v for k, v in sd.items() if ".embeddings." not in k}, llm)
    w = torch.from_numpy(sd["speech_Qformer.bert.embeddings.LayerNorm.weight"])
    b = torch.from_numpy(sd["speech_Qformer.bert.embeddings.LayerNorm.bias"])
    normed = F.layer_norm(raw["query_tokens"], (SPLIT.dim,), w, b, eps=SPLIT.ln_eps)
    torch.testing.assert_close(folded["query_tokens"], normed, rtol=1e-5, atol=1e-6)
    x = _features()
    want = tqformer.qformer_windows(SPLIT, dict(raw, query_tokens=normed), x)
    torch.testing.assert_close(tqformer.qformer_windows(SPLIT, folded, x), want,
                               rtol=1e-5, atol=1e-5)
    assert not torch.equal(folded["query_tokens"], raw["query_tokens"])


def test_a_checkpoint_without_the_embeddings_norm_keeps_its_queries():
    sd, llm = _checkpoint(embeddings_norm=False)
    tree = _tree(sd, llm)
    torch.testing.assert_close(tree["query_tokens"],
                               torch.from_numpy(sd["speech_query_tokens"].reshape(1, -1)))


def test_the_encode_stages_are_ranges_inside_encode():
    gen = tengine.GenerationConfig(max_new_tokens=2, eos_token_id=-1, pad_token_id=0)
    model = tfactory.create_model("salmonn-tiny", seed=0, device="cpu", generation=gen)
    pack = PackConfig(seq_len=512, text_len=384, max_slots=2, audio_tokens_per_slot=88)
    ds = tdata.create_dataset(
        tregistry.DatasetType.VOXCELEB, split=tregistry.DatasetSplit.TEST,
        input_mode="speech_only", fewshot_mode="speech", num_examples=1, max_samples=1,
        synthetic=True, synthetic_size=2, seed=3)
    packed = collate_icl_batch([ds[0]], model.tokenizer, pack)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.engine.generate_tokens(packed, packed.audio)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(perf.SPAN_PREFIX + "encode"))
    names = [n for _, _, n in ranges]
    assert names == ["port/encode", "port/encode.whisper", "port/encode.beats",
                     "port/encode.qformer"]
    (e0, e1, _), *stages = ranges
    for s, t, n in stages:
        assert e0 <= s <= t <= e1, n
    for (_, t, n), (s, _, m) in zip(stages, stages[1:]):
        assert t <= s, (n, m)
