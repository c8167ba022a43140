"""The weight-quantized slice against the JAX package: int8 / int4 decoder
weights and the int8 KV cache through the decoder, the static engine and
the inference CLI, in f32 on the CPU.

The JAX prefill runs its Pallas flash kernel in interpret mode, the path it
takes on its own target: there an int8 cache is written but attention runs
over the unquantized current k/v, which is what the port does (JAX's XLA
fallback off the TPU attends the dequantized cache instead). Decode is the
JAX package's default ``"xla"`` zero-copy step.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models.salmonn import init_salmonn, salmonn_tiny
from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu.ops import quant as jquant
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask, make_prefill_mask
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import inference as tcli
from icl_speech_text_llm_tpu_torch.data import collate as tcollate
from icl_speech_text_llm_tpu_torch.data import factory as tfactory
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.models.factory import create_model
from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)


@pytest.fixture
def jax_flash_prefill(monkeypatch):
    """JAX's TPU prefill on the CPU: Pallas in interpret mode, and the engine's
    flash gate open for 128-multiple prompts."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jfa, "flash_attention_usable",
                        lambda seq_len, head_dim, block=128: seq_len % block == 0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _quantized(params, bits):
    if bits is None:
        return params
    return _np(jquant.quantize_decoder(jax.tree_util.tree_map(jnp.asarray, params), bits=bits))


@pytest.fixture(scope="module")
def decoder():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    lcfg = jllama.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    lora = _np(jllama.init_lora(jax.random.PRNGKey(1), cfg, lcfg))
    rng = np.random.RandomState(7)
    for name in lora:  # a non-zero B so the LoRA delta is exercised
        lora[name]["b"] = (rng.randn(*lora[name]["b"].shape) * 0.05).astype(np.float32)
    return cfg, params, lora, lcfg.scaling


def _close_bytes(got, want, tol=1):
    """int8 cache bytes within ±1 (rounding ties), and the same almost everywhere."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= tol and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_prefill_and_decode_step_with_int8_cache_match_jax(jax_flash_prefill, decoder, bits):
    cfg, params, lora, scaling = decoder
    jp = jax.tree_util.tree_map(jnp.asarray, _quantized(params, bits))
    jlora = jax.tree_util.tree_map(jnp.asarray, lora)
    tcfg = tllama.DECODER_CONFIGS["tiny"]
    tp = params_from_numpy(_quantized(params, bits), device="cpu")
    tlora = params_from_numpy(lora, device="cpu")
    B, L, S = 2, 128, 256
    lengths = np.array([128, 77], np.int32)
    seq = (np.random.RandomState(8).randn(B, L, cfg.dim) * 0.5).astype(np.float32)

    jcache = jllama.init_kv_cache(cfg, B, S, quant=True)
    mask = jnp.concatenate([make_prefill_mask(jnp.asarray(lengths), L),
                            jnp.zeros((B, 1, L, S - L), bool)], axis=-1)
    positions = jnp.broadcast_to(jnp.arange(L), (B, L))
    jh, jcache = jllama.decoder_forward(cfg, jp, jnp.asarray(seq), mask, positions, cache=jcache,
                                        lora=jlora, lora_scaling=scaling,
                                        flash_lengths=jnp.asarray(lengths))
    tcache = tllama.init_kv_cache(tcfg, B, S, quant=True, device="cpu")
    th, tcache = tllama.decoder_forward(tcfg, tp, torch.from_numpy(seq), torch.from_numpy(lengths),
                                        cache=tcache, lora=tlora, lora_scaling=scaling)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(th[b, :n].numpy(), np.asarray(jh)[b, :n], rtol=1e-4, atol=1e-4)

    def check_cache():
        for name in ("k", "v"):
            assert tcache[name].dtype == torch.int8
            _close_bytes(tcache[name], jcache[name])
            np.testing.assert_allclose(tcache[name + "_s"].numpy(), np.asarray(jcache[name + "_s"]),
                                       rtol=0, atol=1e-6)

    check_cache()
    # two cached decode steps: the self column unquantized, the new rows
    # quantized and appended, their scales written per sample. Each step
    # starts from JAX's cache, so that a byte one rounding tie apart (which
    # moves later attention by ~1e-4) does not carry into the next step.
    cur = lengths.copy()
    for step in range(2):
        tcache = params_from_numpy(_np(jcache), device="cpu")
        x = (np.random.RandomState(9 + step).randn(B, 1, cfg.dim) * 0.5).astype(np.float32)
        jx, jcache = jllama.decoder_forward(
            cfg, jp, jnp.asarray(x), make_decode_mask(jnp.asarray(cur) + 1, S),
            jnp.asarray(cur)[:, None], cache=jcache, cache_positions=jnp.asarray(cur),
            lora=jlora, lora_scaling=scaling, use_flash_decode="xla")
        tx, tcache = tllama.decode_step(tcfg, tp, torch.from_numpy(x), tcache,
                                        torch.from_numpy(cur), tlora, scaling)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
        check_cache()
        for b in range(B):  # the appended row's scales landed at its position
            assert torch.all(tcache["k_s"][:, b, :, cur[b]] > 0)
        cur = cur + 1


K = 2  # speech exemplars per request


@pytest.fixture(scope="module")
def tiny_world():
    tok = get_tokenizer()
    ds = tfactory.create_dataset(
        DatasetType.VOXCELEB, split=DatasetSplit.TEST, input_mode="speech_only",
        fewshot_mode="speech", num_examples=K, max_samples=4, synthetic=True,
        synthetic_size=8, seed=3)
    pack = PackConfig(seq_len=768, text_len=384, max_slots=K + 1,
                      audio_tokens_per_slot=tsalmonn.salmonn_tiny().audio_tokens_per_slot)
    packed = tcollate.collate_icl_batch([ds[i] for i in range(2)], tok, pack)
    batch = {"text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
             "seq_lengths": packed.seq_lengths, "wavs": packed.audio["wavs"]}
    return _np(init_salmonn(jax.random.PRNGKey(0), salmonn_tiny())), batch


@pytest.mark.parametrize("bits,kv_int8", [(8, False), (4, False), (4, True)])
def test_salmonn_tiny_greedy_tokens_identical_to_jax(jax_flash_prefill, tiny_world, bits,
                                                     kv_int8):
    params, batch = tiny_world
    params = {**params, "llm": _quantized(params["llm"], bits)}
    gen_kw = dict(max_new_tokens=10, eos_token_id=2, pad_token_id=0, kv_int8=kv_int8)
    want = np.asarray(jax.jit(functools.partial(
        jengine.salmonn_generate, salmonn_tiny(), jengine.GenerationConfig(**gen_kw)))(
        jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tengine.salmonn_generate(
        tsalmonn.salmonn_tiny(), tengine.GenerationConfig(**gen_kw),
        params_from_numpy(params, device="cpu"),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)


def test_cli_quantize_int8_quantizes_the_engines_llm_in_place(tmp_path, monkeypatch):
    models = []
    monkeypatch.setattr(tcli, "create_model",
                        lambda *a, **kw: models.append(create_model(*a, **kw)) or models[-1])
    paths = tcli.main([
        "--model_type", "salmonn-tiny", "--dataset_type", "voxceleb", "--synthetic",
        "--synthetic_size", "8", "--fewshot_mode", "speech", "--num_examples", "1",
        "--batch_size", "2", "--max_samples", "2", "--seq_len", "512", "--text_len", "256",
        "--max_new_tokens", "3", "--quantize_int8", "--device", "cpu",
        "--results_dir", str(tmp_path)])
    (model,) = models
    llm = model.params["llm"]
    assert model.engine.params["llm"] is llm
    for w in (llm["layers"]["attn"]["wq"], llm["layers"]["mlp"]["w_down"], llm["lm_head"]):
        assert set(w) == {"q", "s"} and w["q"].dtype == torch.int8
    results = json.load(open(paths["results"]))["results"]
    assert len(results) == 2 and all(len(r["tokens"]) == 3 for r in results)


def test_cli_quantize_int4_kv_int8_on_cpu(tmp_path):
    paths = tcli.main([
        "--model_type", "salmonn-tiny", "--dataset_type", "voxceleb", "--synthetic",
        "--synthetic_size", "8", "--fewshot_mode", "speech", "--num_examples", "1",
        "--batch_size", "2", "--max_samples", "3", "--seq_len", "512", "--text_len", "256",
        "--max_new_tokens", "4", "--quantize_int4", "--kv_int8", "--device", "cpu",
        "--results_dir", str(tmp_path)])
    results = json.load(open(paths["results"]))
    metrics = json.load(open(paths["metrics"]))
    assert len(results["results"]) == 3
    assert all(len(r["tokens"]) == 4 for r in results["results"])
    assert metrics["voxceleb"]["total_samples"] == 3
    # --auto_batch measures the card's allocator: on the CPU there is none to read
    with pytest.raises(ValueError, match="CUDA"):
        tcli.main(["--auto_batch", "--model_type", "salmonn-tiny", "--synthetic", "--synthetic_size", "4",
         "--max_samples", "2", "--fewshot_mode", "none", "--seq_len", "512", "--text_len", "256",
         "--device", "cpu", "--results_dir", str(tmp_path)])
