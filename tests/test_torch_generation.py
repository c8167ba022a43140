"""The generation surface of the static engine against the JAX package, on
the CPU in f32: beam search (``inference/beam.py``), greedy decoding with
the repetition penalty and the ``min_new_tokens`` EOS ban, sampling, the
decode-attention flag, and the inference CLI with those flags.

Beam and greedy tokens must be identical to JAX's on the same decoder and
prompts. Sampling cannot match JAX's PRNG, so its tests check properties:
the top-p mask equals JAX's on the same logits, a vanishing temperature or
top_p gives the greedy tokens, one seed gives one sequence, every sampled
token lies in the nucleus, and stochastic beams return valid rows.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.inference import beam as jbeam
from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models.salmonn import init_salmonn, salmonn_tiny
from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import inference as tcli
from icl_speech_text_llm_tpu_torch.data import collate as tcollate
from icl_speech_text_llm_tpu_torch.data import factory as tfactory
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.inference import beam as tbeam
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)
B, L, T = 2, 128, 6
LENGTHS = np.array([128, 77], np.int32)


@pytest.fixture
def jax_flash_prefill(monkeypatch):
    """JAX's TPU prefill on the CPU (Pallas in interpret mode): with an int8
    cache it attends the unquantized current k/v, as the port does."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jfa, "flash_attention_usable",
                        lambda seq_len, head_dim, block=128: seq_len % block == 0)


@pytest.fixture(scope="module")
def decoder():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    params = jax.tree_util.tree_map(np.asarray, jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    seq = (np.random.RandomState(1).randn(B, L, cfg.dim) * 0.5).astype(np.float32)
    tp = params_from_numpy(params, device="cpu")
    # EOS ids that the greedy decode and a 2-beam search emit at step 2 of
    # sample 0 when nothing stops them, so that EOS padding and finished
    # beam hypotheses happen
    args = (tllama.DECODER_CONFIGS["tiny"], tp, torch.from_numpy(seq), torch.from_numpy(LENGTHS))
    greedy = tengine.decode_from_sequence(
        *args, tengine.GenerationConfig(max_new_tokens=T, eos_token_id=-1))
    beams = tbeam.beam_decode_from_sequence(
        *args, tengine.GenerationConfig(max_new_tokens=T, eos_token_id=-1, num_beams=2))
    return cfg, params, tp, seq, {"greedy": int(greedy[0, 2]), "beam": int(beams[0, 2])}


def _jax_tokens(decode, decoder, **gen_kw):
    cfg, params, _, seq, _ = decoder
    return np.asarray(decode(cfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(seq),
                             jnp.asarray(LENGTHS), jengine.GenerationConfig(**gen_kw)))


def _port_tokens(decode, decoder, **gen_kw):
    _, _, tp, seq, _ = decoder
    return decode(tllama.DECODER_CONFIGS["tiny"], tp, torch.from_numpy(seq),
                  torch.from_numpy(LENGTHS), tengine.GenerationConfig(**gen_kw)).numpy()


BEAM_CASES = {
    "K2": dict(num_beams=2),
    "K3 repetition 1.3": dict(num_beams=3, repetition_penalty=1.3),
    "K2 repetition 0.5": dict(num_beams=2, repetition_penalty=0.5),
    "K2 length_penalty 0.5 min_new 3": dict(num_beams=2, length_penalty=0.5, min_new_tokens=3),
    "K3 int8 KV": dict(num_beams=3, kv_int8=True),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_search_tokens_identical_to_jax(jax_flash_prefill, decoder, case):
    eos = decoder[4]["beam"]
    kw = dict(max_new_tokens=T, eos_token_id=eos, pad_token_id=0, **BEAM_CASES[case])
    want = _jax_tokens(jbeam.beam_decode_from_sequence, decoder, **kw)
    got = _port_tokens(tbeam.beam_decode_from_sequence, decoder, **kw)
    assert got.shape == (B, T) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


GREEDY_CASES = {
    "repetition 1.3": dict(repetition_penalty=1.3),
    "min_new 3": dict(min_new_tokens=3),
    "repetition 0.7 min_new 2 int8 KV": dict(repetition_penalty=0.7, min_new_tokens=2,
                                            kv_int8=True),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_with_processors_identical_to_jax(jax_flash_prefill, decoder, case):
    eos = decoder[4]["greedy"]
    kw = dict(max_new_tokens=T, eos_token_id=eos, pad_token_id=0, **GREEDY_CASES[case])
    want = _jax_tokens(jengine.decode_from_sequence, decoder, **kw)
    got = _port_tokens(tengine.decode_from_sequence, decoder, **kw)
    np.testing.assert_array_equal(got, want)
    if "min_new_tokens" in kw:  # the ban held: no EOS among the first tokens
        assert not np.any(got[:, :kw["min_new_tokens"]] == eos)


def test_repetition_penalty_and_length_norm_match_jax():
    rng = np.random.RandomState(3)
    scores = rng.randn(4, 50).astype(np.float32)
    history = rng.randint(0, 50, (4, 7)).astype(np.int32)
    for hist_len, penalty in ((0, 1.3), (3, 1.3), (7, 0.6)):
        want = jbeam.apply_repetition_penalty(jnp.asarray(scores), jnp.asarray(history),
                                              hist_len, penalty)
        got = tengine.apply_repetition_penalty(torch.from_numpy(scores),
                                               torch.from_numpy(history), hist_len, penalty)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cum = rng.randn(3, 4).astype(np.float32)
    for length in (0, 1, 5):
        np.testing.assert_allclose(tbeam._norm(torch.from_numpy(cum), length, 0.5).numpy(),
                                   np.asarray(jbeam._norm(jnp.asarray(cum), length, 0.5)),
                                   rtol=1e-6)


def test_top_p_mask_equals_jax(monkeypatch):
    """JAX's ``_sample_token`` on the same logits hands its masked logits to
    ``jax.random.categorical``; they equal the port's ``top_p_mask``."""
    logits = (np.random.RandomState(4).randn(3, 400) * 3).astype(np.float32)
    seen = []
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, masked, axis=-1: seen.append(np.asarray(masked))
                        or jnp.argmax(masked, axis=axis))
    for temperature, top_p in ((0.8, 0.9), (1.0, 0.5), (2.0, 0.99), (0.8, 1.5)):
        gen = jengine.GenerationConfig(do_sample=True, temperature=temperature, top_p=top_p)
        jengine._sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), gen)
        got = tengine.top_p_mask(torch.from_numpy(logits) / temperature, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(seen[-1]))
        np.testing.assert_allclose(got[np.isfinite(got)], seen[-1][np.isfinite(got)], rtol=1e-6)


def test_sampling_limits_give_greedy_and_a_seed_gives_one_sequence(decoder):
    kw = dict(max_new_tokens=T, eos_token_id=decoder[4]["greedy"], pad_token_id=0)
    greedy = _port_tokens(tengine.decode_from_sequence, decoder, **kw)
    for sample_kw in (dict(temperature=1e-6, top_p=0.9), dict(temperature=0.8, top_p=0.0)):
        got = _port_tokens(tengine.decode_from_sequence, decoder, do_sample=True, **sample_kw,
                           **kw)
        np.testing.assert_array_equal(got, greedy)
    hot = dict(do_sample=True, temperature=1.5, top_p=1.0, **kw)
    a = _port_tokens(tengine.decode_from_sequence, decoder, seed=7, **hot)
    b = _port_tokens(tengine.decode_from_sequence, decoder, seed=7, **hot)
    c = _port_tokens(tengine.decode_from_sequence, decoder, seed=8, **hot)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_every_sampled_token_lies_in_the_nucleus():
    logits = torch.from_numpy((np.random.RandomState(5).randn(4, 300) * 2).astype(np.float32))
    gen = tengine.GenerationConfig(do_sample=True, temperature=0.7, top_p=0.6)
    nucleus = torch.isfinite(tengine.top_p_mask(logits / 0.7, 0.6))
    assert nucleus.sum(-1).min() >= 1 and nucleus.sum(-1).max() < 300
    g = torch.Generator().manual_seed(0)
    drawn = torch.stack([tengine._sample_token(logits, g, gen) for _ in range(300)], 1)
    assert bool(torch.gather(nucleus, 1, drawn).all())
    assert len(set(drawn[0].tolist())) > 1  # it samples, not argmax


def test_stochastic_beams_return_valid_eos_filled_rows(decoder):
    eos = decoder[4]["beam"]
    kw = dict(max_new_tokens=T, eos_token_id=eos, pad_token_id=0, num_beams=3, do_sample=True,
              temperature=1.0, top_p=1.0)
    a = _port_tokens(tbeam.beam_decode_from_sequence, decoder, seed=1, **kw)
    b = _port_tokens(tbeam.beam_decode_from_sequence, decoder, seed=1, **kw)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, T) and a.min() >= 0 and a.max() < decoder[0].vocab_size
    for row in a:
        ends = np.flatnonzero(row == eos)
        if ends.size:
            assert np.all(row[ends[0]:] == eos)


@pytest.fixture(scope="module")
def tiny_world():
    tok = get_tokenizer()
    ds = tfactory.create_dataset(
        DatasetType.VOXCELEB, split=DatasetSplit.TEST, input_mode="speech_only",
        fewshot_mode="speech", num_examples=1, max_samples=4, synthetic=True,
        synthetic_size=8, seed=3)
    pack = PackConfig(seq_len=512, text_len=256, max_slots=2,
                      audio_tokens_per_slot=tsalmonn.salmonn_tiny().audio_tokens_per_slot)
    packed = tcollate.collate_icl_batch([ds[i] for i in range(2)], tok, pack)
    batch = {"text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
             "seq_lengths": packed.seq_lengths, "wavs": packed.audio["wavs"]}
    params = jax.tree_util.tree_map(np.asarray, init_salmonn(jax.random.PRNGKey(0),
                                                             salmonn_tiny()))
    return params, batch


def test_salmonn_tiny_beams_identical_to_jax(tiny_world):
    """``salmonn_generate`` with ``num_beams=2`` dispatches to beam search in
    both packages; with ``use_flash_decode=True`` the port's tokens stay the
    same (the K7 plain version on the CPU)."""
    params, batch = tiny_world
    kw = dict(max_new_tokens=5, eos_token_id=2, pad_token_id=0, num_beams=2,
              repetition_penalty=1.2)
    want = np.asarray(jax.jit(functools.partial(
        jengine.salmonn_generate, salmonn_tiny(), jengine.GenerationConfig(**kw)))(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}))
    tparams = params_from_numpy(params, device="cpu")
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for flag in ("xla", True):
        gen = tengine.GenerationConfig(use_flash_decode=flag, **kw)
        got = tengine.salmonn_generate(tsalmonn.salmonn_tiny(), gen, tparams, tbatch).numpy()
        np.testing.assert_array_equal(got, want)


def test_decode_flag_is_an_enum():
    D = tllama.DecodeAttention
    assert tengine.GenerationConfig().use_flash_decode is D.XLA
    assert tengine.GenerationConfig(use_flash_decode=True).use_flash_decode is D.FLASH
    assert tengine.GenerationConfig(use_flash_decode=False).use_flash_decode is D.GENERIC
    with pytest.raises(ValueError):
        tengine.GenerationConfig(use_flash_decode="pallas")
    # GENERIC decodes: one step's hidden state as the XLA route's, and the
    # same rows appended (written per layer before the attention there)
    cfg = tllama.DECODER_CONFIGS["tiny"]
    params = tllama.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 1, cfg.dim).astype(np.float32))
    pos = torch.tensor([5, 9], dtype=torch.int32)
    start = tllama.init_kv_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for leaf in start.values():
        leaf.copy_(torch.from_numpy(rng.randn(*leaf.shape).astype(np.float32)))
    out = {route: tllama.decode_step(cfg, params, x, {k: v.clone() for k, v in start.items()},
                                     pos, attention=route)
           for route in (D.XLA, D.GENERIC)}
    (hx, cx), (hg, cg) = out[D.XLA], out[D.GENERIC]
    np.testing.assert_allclose(hg.numpy(), hx.numpy(), rtol=1e-5, atol=1e-5)
    for name in cx:
        np.testing.assert_allclose(cg[name].numpy(), cx[name].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32 cache", "int8 cache"])
def test_generic_decode_tokens_identical_to_jax(jax_flash_prefill, decoder, kv_int8):
    """``use_flash_decode=False`` in one process: JAX's scanned-layer decode
    (each layer's row written first, the cache then attended under the
    decode mask; under int8 the current token quantized) and the port's
    GENERIC route give the same tokens."""
    kw = dict(max_new_tokens=T, eos_token_id=-1, pad_token_id=0, use_flash_decode=False,
              kv_int8=kv_int8)
    want = _jax_tokens(jengine.decode_from_sequence, decoder, **kw)
    got = _port_tokens(tengine.decode_from_sequence, decoder, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags", [
    ["--num_beams", "2", "--repetition_penalty", "1.2", "--min_new_tokens", "1"],
    ["--do_sample", "--temperature", "0.9", "--top_p", "0.8"]])
def test_cli_generation_flags_on_cpu(tmp_path, flags):
    paths = tcli.main([
        "--model_type", "salmonn-tiny", "--dataset_type", "voxceleb", "--synthetic",
        "--synthetic_size", "8", "--fewshot_mode", "speech", "--num_examples", "1",
        "--batch_size", "2", "--max_samples", "3", "--seq_len", "512", "--text_len", "256",
        "--max_new_tokens", "4", "--device", "cpu", "--results_dir", str(tmp_path), *flags])
    results = json.load(open(paths["results"]))["results"]
    metrics = json.load(open(paths["metrics"]))
    assert len(results) == 3 and all(len(r["tokens"]) == 4 for r in results)
    assert metrics["voxceleb"]["total_samples"] == 3
