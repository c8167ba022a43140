"""Each module of the PyTorch port against its JAX-package counterpart.

Parameters come from the JAX package's own init (one seed) and are bridged
name for name; inputs are seeded numpy arrays fed to both. f32 on the CPU;
the bound is 1e-4 on valid rows (padded rows are garbage in both).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.models import beats as jbeats
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qformer as jqformer
from icl_speech_text_llm_tpu.models import whisper as jwhisper
from icl_speech_text_llm_tpu.ops import mel as jmel
from icl_speech_text_llm_tpu.ops import attention as jattn
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask, make_prefill_mask
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.models import beats as tbeats
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.models import qformer as tqformer
from icl_speech_text_llm_tpu_torch.models import whisper as twhisper
from icl_speech_text_llm_tpu_torch.models.common import gelu
from icl_speech_text_llm_tpu_torch.ops import attention as tattn
from icl_speech_text_llm_tpu_torch.ops import mel as tmel

torch.set_num_threads(1)
TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "whisper_mel.npz")


def _bridge(jax_tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_tree))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.abs(got.astype(np.float64) - np.asarray(want).astype(np.float64)).max()
    assert err <= tol, err


def _wavs(n, seconds, seed=0):
    return (np.random.RandomState(seed).randn(n, int(16000 * seconds)) * 0.1).astype(np.float32)


def test_log_mel_matches_jax_and_golden():
    wavs = _wavs(2, 3.5)
    _close(tmel.log_mel_spectrogram(torch.from_numpy(wavs)),
           jmel.log_mel_spectrogram(jnp.asarray(wavs)))
    g = np.load(GOLDEN)
    mine = tmel.log_mel_spectrogram(torch.from_numpy(g["wav1"])).numpy()
    assert np.abs(mine[:, :300] - g["mel1"]).max() < 1e-3
    assert np.abs(mine[:, -8:] - g["mel1_tail"]).max() < 1e-3
    mine2 = tmel.log_mel_spectrogram(torch.from_numpy(g["wav2"])).numpy()
    assert np.abs(mine2[:, :300] - g["mel2"]).max() < 1e-3


def test_wav_helpers_match_jax():
    ints = (np.random.RandomState(1).randn(2, 3, 500) * 3000).astype(np.int16)
    _close(tmel.wavs_to_float(torch.from_numpy(ints)), jmel.wavs_to_float(jnp.asarray(ints)), 0)
    x = _wavs(2, 0.1)
    for n in (800, 1600, 3000):
        _close(tmel.pad_or_trim(torch.from_numpy(x), n), jmel.pad_or_trim(jnp.asarray(x), n), 0)


def test_attention_ops_and_masks_match_jax():
    lengths = np.array([7, 3], np.int32)
    jl, tl = jnp.asarray(lengths), torch.from_numpy(lengths)
    _close(tattn.make_prefill_mask(tl, 9), jattn.make_prefill_mask(jl, 9), 0)
    _close(tattn.make_decode_mask(tl, 12), jattn.make_decode_mask(jl, 12), 0)
    _close(tattn.causal_mask(4, 6, offset=2), jattn.causal_mask(4, 6, offset=2), 0)
    q, k, v = (np.random.RandomState(i).randn(2, 4, 9, 16).astype(np.float32) for i in range(3))
    kv = np.random.RandomState(3).randn(2, 2, 9, 16).astype(np.float32)
    _close(tattn.repeat_kv(torch.from_numpy(kv), 2), jattn.repeat_kv(jnp.asarray(kv), 2), 0)
    mask = jattn.make_prefill_mask(jl, 9)
    _close(tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                       tattn.make_prefill_mask(tl, 9)),
           jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), mask), 1e-5)


def test_kaldi_fbank_matches_jax():
    wav = _wavs(2, 2.0, seed=2) * 2 ** 15
    _close(tbeats.kaldi_fbank(torch.from_numpy(wav)), jbeats.kaldi_fbank(jnp.asarray(wav)), 2e-4)


def test_gelu_is_dtype_gated():
    x = torch.linspace(-6, 6, 101)
    _close(gelu(x), jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False), 1e-6)
    got = gelu(x.to(torch.bfloat16)).float()
    want = jax.nn.gelu(jnp.asarray(x.numpy()).astype(jnp.bfloat16), approximate=True)
    _close(got, np.asarray(want.astype(jnp.float32)), 0.0625)


def test_whisper_encode_matches_jax():
    cfg = jwhisper.WHISPER_CONFIGS["tiny-test"]
    jp = jwhisper.init_whisper_encoder(jax.random.PRNGKey(0), cfg)
    mel = (np.random.RandomState(3).randn(2, 80, 3000) * 0.3).astype(np.float32)
    want = jwhisper.whisper_encode(cfg, jp, jnp.asarray(mel))
    tcfg = twhisper.WHISPER_CONFIGS["tiny-test"]
    got = twhisper.whisper_encode(tcfg, _bridge(jp), torch.from_numpy(mel))
    assert got.shape == (2, 1500, 64)
    _close(got, want)


def test_beats_encode_matches_jax_gated_bias_kernel(monkeypatch):
    """BEATs with the gated relative-position bias. The JAX side runs its
    Pallas gated-bias kernel in interpret mode (which reads the bias table as
    bf16, as the port's kernel and plain version do)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    cfg = jbeats.BeatsConfig(dim=128, embed_dim=32, n_heads=2, n_layers=2, conv_pos=16,
                             conv_pos_groups=4, rel_pos_buckets=32, rel_pos_max_distance=16)
    jp = jbeats.init_beats(jax.random.PRNGKey(0), cfg)
    wav = _wavs(2, 2.0, seed=4) * 0.5
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jbeats.beats_encode(dataclasses.replace(cfg, use_flash=True), jp, jnp.asarray(wav))
    tcfg = tbeats.BeatsConfig(dim=128, embed_dim=32, n_heads=2, n_layers=2, conv_pos=16,
                              conv_pos_groups=4, rel_pos_buckets=32, rel_pos_max_distance=16)
    got = tbeats.beats_encode(tcfg, _bridge(jp), torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 96, 128)
    _close(got, want)


def test_beats_bias_table_and_gate_match_jax():
    cfg = jbeats.BEATS_CONFIGS["tiny-test"]
    jp = jbeats.init_beats(jax.random.PRNGKey(1), cfg)
    tp = _bridge(jp)
    tcfg = tbeats.BEATS_CONFIGS["tiny-test"]
    _close(tbeats.beats_bias_table(tcfg, tp, 40), jbeats.beats_bias_table(cfg, jp, 40), 0)
    x = (np.random.RandomState(5).randn(2, 40, cfg.dim)).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tlayer = jax.tree_util.tree_map(lambda a: a[0], tp["layers"])
    _close(tbeats._gate_scale_rows(tcfg, tlayer["attn"], torch.from_numpy(x)),
           jbeats._gate_scale_rows(cfg, layer["attn"], jnp.asarray(x)), 1e-5)


def test_qformer_windows_matches_jax():
    cfg = jqformer.QFORMER_CONFIGS["tiny-test"]
    jp = jqformer.init_qformer(jax.random.PRNGKey(0), cfg)
    feats = np.random.RandomState(6).randn(2, 1500, cfg.encoder_width).astype(np.float32)
    want = jqformer.qformer_windows(cfg, jp, jnp.asarray(feats))
    got = tqformer.qformer_windows(tqformer.QFORMER_CONFIGS["tiny-test"], _bridge(jp),
                                   torch.from_numpy(feats))
    assert got.shape == (2, 88, 128)
    _close(got, want)


@pytest.fixture(scope="module")
def decoder():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    lcfg = jllama.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    params = jllama.init_decoder(jax.random.PRNGKey(0), cfg)
    lora = jax.tree_util.tree_map(np.asarray, jllama.init_lora(jax.random.PRNGKey(1), cfg, lcfg))
    rng = np.random.RandomState(7)
    for name in lora:  # a non-zero B so the LoRA delta is exercised
        lora[name]["b"] = (rng.randn(*lora[name]["b"].shape) * 0.05).astype(np.float32)
    return cfg, params, lora, lcfg.scaling


def test_decoder_prefill_and_decode_step_match_jax(decoder):
    cfg, jp, lora, scaling = decoder
    tcfg = tllama.DECODER_CONFIGS["tiny"]
    tp, tlora = _bridge(jp), params_from_numpy(lora)
    B, L, S = 2, 96, 128
    lengths = np.array([96, 61], np.int32)
    seq = (np.random.RandomState(8).randn(B, L, cfg.dim) * 0.5).astype(np.float32)

    # prefill into the cache (the JAX XLA path attends the whole cache under a mask)
    jcache = jllama.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    mask = jnp.concatenate([make_prefill_mask(jnp.asarray(lengths), L),
                            jnp.zeros((B, 1, L, S - L), bool)], axis=-1)
    positions = jnp.broadcast_to(jnp.arange(L), (B, L))
    jh, jcache = jllama.decoder_forward(cfg, jp, jnp.asarray(seq), mask, positions,
                                        cache=jcache, lora=jax.tree_util.tree_map(jnp.asarray, lora),
                                        lora_scaling=scaling)
    tcache = tllama.init_kv_cache(tcfg, B, S, dtype=torch.float32)
    th, tcache = tllama.decoder_forward(tcfg, tp, torch.from_numpy(seq),
                                        torch.from_numpy(lengths), cache=tcache,
                                        lora=tlora, lora_scaling=scaling)
    for b, n in enumerate(lengths):
        _close(th[b, :n], np.asarray(jh)[b, :n])
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])

    # one cached decode step (zero-copy layout, "xla" attention, one append)
    x = (np.random.RandomState(9).randn(B, 1, cfg.dim) * 0.5).astype(np.float32)
    jx, jcache = jllama.decoder_forward(
        cfg, jp, jnp.asarray(x), make_decode_mask(jnp.asarray(lengths) + 1, S),
        jnp.asarray(lengths)[:, None], cache=jcache, cache_positions=jnp.asarray(lengths),
        lora=jax.tree_util.tree_map(jnp.asarray, lora), lora_scaling=scaling,
        use_flash_decode="xla")
    tx, tcache = tllama.decode_step(tcfg, tp, torch.from_numpy(x), tcache,
                                    torch.from_numpy(lengths), tlora, scaling)
    _close(tx, jx)
    _close(tcache["k"], jcache["k"], 1e-5)
    _close(tcache["v"], jcache["v"], 1e-5)


def test_embed_and_logits_match_jax(decoder):
    cfg, jp, _, _ = decoder
    tp = _bridge(jp)
    ids = np.array([[0, 5, 36763, 40000]], np.int32)  # past the table: clamped
    _close(tllama.embed_tokens(tp, torch.from_numpy(ids)), jllama.embed_tokens(jp, jnp.asarray(ids)), 0)
    h = np.random.RandomState(10).randn(1, 3, cfg.dim).astype(np.float32)
    _close(tllama.lm_logits(tllama.DECODER_CONFIGS["tiny"], tp, torch.from_numpy(h)),
           jllama.lm_logits(cfg, jp, jnp.asarray(h)))
