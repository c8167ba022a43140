"""The port's Qwen2-Audio family against the JAX package's, on the CPU.

- the kernel modules on Qwen's path, their plain versions against the
  Pallas kernels in interpret mode (f32, 3e-5 forward, 1e-4 backward, the
  bounds of ``tests/test_torch_flash_attention.py`` and
  ``tests/test_torch_flash_backward.py``): K2 with per-clip key lengths at
  a length that is no multiple of a tile, K1 and K5/K6 at n_rep 7;
- ``whisper_encode`` with ``frame_lengths`` before the final LN, at 80 and
  128 mels; the length formulas, exactly; ``resample_kaiser`` (1e-5);
- a Qwen2-shaped decoder defined here (qkv biases, n_rep 7, rope θ 1e6,
  tied embeddings): the prefill and 3 decode steps, f32 plain, int8 and
  int4 weights (1e-4) and bf16 (stated below);
- qwen2-audio-tiny's model functions: ``encode_audio`` with clips of 1 s, 3
  s and a missing one (silence, as the collator pads it), compared at the
  positions each clip splices; the train loss and LoRA gradients (1e-5,
  1e-4 × max |g|); greedy and 2-beam tokens identical;
- the model surface, converted weights and ``convert_hf_qwen_audio``.

Weights are drawn by JAX and bridged (``params_from_numpy``), so both
packages compute on the same arrays.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu import registry as jregistry
from icl_speech_text_llm_tpu.data import factory as jdata
from icl_speech_text_llm_tpu.data.collate import collate_icl_batch as jcollate
from icl_speech_text_llm_tpu.data.packing import PackConfig as JPackConfig
from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.models import convert as jconvert
from icl_speech_text_llm_tpu.models import factory as jfactory
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qwen_audio as jqa
from icl_speech_text_llm_tpu.models import stream_convert as jstream
from icl_speech_text_llm_tpu.models import whisper as jwhisper
from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu.ops import quant as jquant
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask, make_prefill_mask
from icl_speech_text_llm_tpu.ops.attention import repeat_kv as jrepeat_kv
from icl_speech_text_llm_tpu.ops import mel as jmel
from icl_speech_text_llm_tpu.ops.mel import log_mel_spectrogram as jlog_mel
from icl_speech_text_llm_tpu.training import checkpoint as jckpt
from icl_speech_text_llm_tpu_torch import registry as tregistry
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data import factory as tdata
from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import convert as tconvert
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.models import qwen_audio as tqa
from icl_speech_text_llm_tpu_torch.models import whisper as twhisper
from icl_speech_text_llm_tpu_torch.models.synth_ckpt import write_hf_decoder_shards
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa
from icl_speech_text_llm_tpu_torch.ops import mel as tmel
from icl_speech_text_llm_tpu_torch.ops.mel import log_mel_spectrogram as tlog_mel
from icl_speech_text_llm_tpu_torch.training.step import merge_params, split_params, tree_map
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)
K = 2  # speech exemplars per request


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _arrays(shapes, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _valid_rows_max(a, b, lengths):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return max(d[i, :, :n].max() for i, n in enumerate(lengths))


# -- the kernels' plain versions against the Pallas kernels ------------------------------

def test_noncausal_plain_with_clip_lengths_matches_pallas_kernel(interpret_mode):
    """K2 as the audio tower calls it: every query row against the keys
    below its clip's frame count, S = 300 (no multiple of a tile; the port
    takes it as it is, JAX's kernel over a copy padded to 384 whose pad
    keys the lengths mask, as JAX's tower pads 1500 to 1536)."""
    B, H, S, D, P = 2, 2, 300, 64, 384
    q, k, v = _arrays([(B, H, S, D)] * 3, seed=21)
    lengths = [300, 77]
    pad = [(0, 0), (0, 0), (0, P - S), (0, 0)]
    o_j, m_j, l_j = jfa._flash_forward_noncausal(
        *(jnp.asarray(np.pad(a, pad)) for a in (q, k, v)), jnp.asarray(lengths, jnp.int32),
        D ** -0.5, 128, 128)
    o_t, m_t, l_t = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                              torch.tensor(lengths), causal=False)
    rows = [S, S]  # every query row of both clips attends its valid keys
    assert _valid_rows_max(o_t, np.asarray(o_j)[:, :, :S], rows) < 3e-5
    assert _valid_rows_max(m_t[..., None], np.asarray(m_j)[:, :, 0, :S, None], rows) < 3e-5
    rel = l_t.numpy() / np.asarray(l_j)[:, :, 0, :S]
    assert _valid_rows_max(rel[..., None], np.ones_like(rel)[..., None], rows) < 3e-5


@pytest.mark.parametrize("H,Hkv", [(7, 1), (14, 2)])
def test_causal_plain_at_n_rep_7_matches_pallas_kernel(interpret_mode, H, Hkv):
    """K1 at Qwen2-7B's grouping (7 query heads a kv head): the plain
    version reads kv head h // 7; JAX's kernel gets repeat_kv'd k/v."""
    B, S, D = 2, 256, 128
    (q,) = _arrays([(B, H, S, D)], seed=22)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed=23)
    lengths = [256, 131]
    o_j, m_j, l_j = jfa._flash_forward(jnp.asarray(q), jrepeat_kv(jnp.asarray(k), H // Hkv),
                                       jrepeat_kv(jnp.asarray(v), H // Hkv),
                                       jnp.asarray(lengths, jnp.int32), True, D ** -0.5,
                                       128, 128)
    o_t, m_t, l_t = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                              torch.tensor(lengths), causal=True)
    assert _valid_rows_max(o_t, o_j, lengths) < 3e-5
    assert _valid_rows_max(m_t[..., None], np.asarray(m_j)[:, :, 0, :, None], lengths) < 3e-5
    rel = l_t.numpy() / np.asarray(l_j)[:, :, 0]
    assert _valid_rows_max(rel[..., None], np.ones_like(rel)[..., None], lengths) < 3e-5


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_at_n_rep_7_matches_pallas_kernels(interpret_mode, causal):
    """K5/K6 at n_rep 7 (H 7 over Hkv 1, D 128, S 256): dq, and dk/dv summed
    over the seven query heads of the kv head, against JAX's Pallas
    backward over repeated k/v with its dk/dv summed per group."""
    B, H, Hkv, S, D = 2, 7, 1, 256, 128
    n_rep = H // Hkv
    lengths = [256, 147]
    (q,) = _arrays([(B, H, S, D)], seed=24, scale=0.3)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed=25, scale=0.3)
    (do,) = _arrays([(B, H, S, D)], seed=26, scale=0.1)
    do = do * (np.arange(S)[None, None, :, None] < np.asarray(lengths)[:, None, None, None])
    do = do.astype(np.float32)
    sm = D ** -0.5
    jl = jnp.asarray(lengths, jnp.int32)
    jq = jnp.asarray(q)
    jk, jv = jrepeat_kv(jnp.asarray(k), n_rep), jrepeat_kv(jnp.asarray(v), n_rep)
    if causal:
        o, m, l = jfa._flash_forward(jq, jk, jv, jl, True, sm, 128, 128)
    else:
        o, m, l = jfa._flash_forward_noncausal(jq, jk, jv, jl, sm, 128, 128)
    res = (jq, jk, jv, jl, o, m[:, :, 0], l[:, :, 0])
    dq_j, dk_j, dv_j = jfa._flash_bwd_rule(causal, sm, 128, 128, 128, 128, res,
                                           jnp.asarray(do))[:3]
    t = torch.from_numpy
    o_t, m_t, l_t = tfa.flash_attention_plain(t(q), t(k), t(v), torch.tensor(lengths), causal)
    dq_t, dk_t, dv_t = tfa.flash_attention_bwd_plain(t(q), t(k), t(v), o_t, m_t, l_t, t(do),
                                                     torch.tensor(lengths), causal)
    group = lambda g: np.asarray(g, np.float64).reshape(B, Hkv, n_rep, S, D).sum(2)
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dk_t.numpy(), group(dk_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dv_t.numpy(), group(dv_j), rtol=0, atol=1e-4)


# -- Whisper with per-clip frame lengths, the length formulas ----------------------------

@pytest.mark.parametrize("n_mels", [80, 128])
def test_whisper_encode_with_frame_lengths_before_ln_matches_jax(n_mels):
    """The tower as Qwen2-Audio runs it: keys past each clip's frames
    masked, no final LN. Compared on each clip's valid rows (the rows past
    a clip's frames are garbage in both packages, and differ)."""
    cfg = dataclasses.replace(jwhisper.WHISPER_CONFIGS["tiny-test"], n_mels=n_mels)
    tcfg = dataclasses.replace(twhisper.WHISPER_CONFIGS["tiny-test"], n_mels=n_mels)
    params = _np(jwhisper.init_whisper_encoder(jax.random.PRNGKey(3), cfg))
    rng = np.random.RandomState(4)
    for blk in ("attn", "mlp"):  # non-zero biases
        for name, leaf in params["blocks"][blk].items():
            if name.startswith("b"):
                params["blocks"][blk][name] = (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
    (mel,) = _arrays([(3, n_mels, 3000)], seed=5, scale=1.0)
    frames = [1500, 250, 37]
    want = np.asarray(jwhisper.whisper_encode(cfg, _jnp(params), jnp.asarray(mel),
                                              apply_ln_post=False,
                                              frame_lengths=jnp.asarray(frames, jnp.int32)))
    got = twhisper.whisper_encode(tcfg, params_from_numpy(params, device="cpu"),
                                  torch.from_numpy(mel), apply_ln_post=False,
                                  frame_lengths=torch.tensor(frames))
    assert got.shape == want.shape == (3, 1500, cfg.dim)
    for i, n in enumerate(frames):
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], rtol=1e-4, atol=1e-4)
    # the final LN on top gives the SALMONN path's output
    full = twhisper.whisper_encode(tcfg, params_from_numpy(params, device="cpu"),
                                   torch.from_numpy(mel))
    np.testing.assert_allclose(full.numpy(), np.asarray(jwhisper.whisper_encode(
        cfg, _jnp(params), jnp.asarray(mel))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [0, 1, 159, 160, 161, 16000, 80000, 479999, 480000])
def test_length_formulas_equal_jax(n):
    assert tqa.audio_feat_lengths(n) == int(jqa.audio_feat_lengths(n))
    assert tqa.audio_output_length(n) == int(jqa.audio_output_length(n))
    arr = np.array([n], np.int32)  # on arrays and tensors too, as the packer and the mask
    assert tqa.audio_output_length(torch.from_numpy(arr)).item() == int(
        np.asarray(jqa.audio_output_length(jnp.asarray(arr)))[0])
    assert tqa.audio_feat_lengths(torch.from_numpy(arr)).item() == int(
        np.asarray(jqa.audio_feat_lengths(jnp.asarray(arr)))[0])



@pytest.mark.parametrize("orig_sr,new_sr,n", [
    (8000, 16000, 7), (8000, 16000, 8),  # the input shorter than the filter
    (8000, 16000, 301), (16000, 8000, 300), (16000, 16000, 5),
    (44100, 16000, 100), (44100, 16000, 101),
    (22050, 16000, 44), (22050, 16000, 45)])  # 14080 and 14400 zero-stuffed, 14113 taps
def test_resample_kaiser_matches_jax(orig_sr, new_sr, n):
    """The windowed-sinc resampler: the same length exactly, and the same
    samples within 1e-5 (f32 sums of up to 14113 taps in another order),
    rising, falling and same rates, inputs shorter and longer than the
    filter, odd and even lengths."""
    (wav,) = _arrays([(n,)], seed=11, scale=1.0)
    want = np.asarray(jmel.resample_kaiser(jnp.asarray(wav), orig_sr, new_sr))
    got = tmel.resample_kaiser(torch.from_numpy(wav), orig_sr, new_sr).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- a Qwen2-shaped decoder ------------------------------------------------------------

#: Qwen2's shape at a test's size: qkv biases, 7 query heads a kv head,
#: rope θ 1e6, tied embeddings (no lm_head), head_dim 32
QWEN2_TEST = dict(vocab_size=36764, dim=224, n_layers=2, n_heads=7, n_kv_heads=1,
                  hidden_dim=384, qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
                  max_seq_len=2048)


@pytest.fixture(scope="module")
def qwen2_decoder():
    cfg = jllama.DecoderConfig(**QWEN2_TEST)
    lcfg = jllama.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wk"))
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    lora = _np(jllama.init_lora(jax.random.PRNGKey(1), cfg, lcfg))
    rng = np.random.RandomState(7)
    assert "lm_head" not in params
    for name in ("bq", "bk", "bv"):
        params["layers"]["attn"][name] = (
            rng.randn(*params["layers"]["attn"][name].shape) * 0.1).astype(np.float32)
    for name in lora:
        lora[name]["b"] = (rng.randn(*lora[name]["b"].shape) * 0.05).astype(np.float32)
    return cfg, params, lora, lcfg.scaling


def _decoder_run(jcfg, jp, jlora, tp, tlora, scaling, jdt, tdt):
    """Prefill of 2 ragged prompts into a cache, then 3 decode steps, in
    both packages → [(port, JAX) hidden states] per stage, f32 numpy."""
    tcfg = tllama.DecoderConfig(**QWEN2_TEST)
    B, L, S = 2, 96, 128
    lengths = np.array([96, 41], np.int32)
    (seq,) = _arrays([(B, L, jcfg.dim)], seed=8)
    jcache = jllama.init_kv_cache(jcfg, B, S, dtype=jdt)
    mask = jnp.concatenate([make_prefill_mask(jnp.asarray(lengths), L),
                            jnp.zeros((B, 1, L, S - L), bool)], axis=-1)
    positions = jnp.broadcast_to(jnp.arange(L), (B, L))
    jh, jcache = jllama.decoder_forward(jcfg, jp, jnp.asarray(seq).astype(jdt), mask, positions,
                                        cache=jcache, lora=jlora, lora_scaling=scaling)
    tcache = tllama.init_kv_cache(tcfg, B, S, dtype=tdt, device="cpu")
    th, tcache = tllama.decoder_forward(tcfg, tp, torch.from_numpy(seq).to(tdt),
                                        torch.from_numpy(lengths), cache=tcache, lora=tlora,
                                        lora_scaling=scaling)
    out = [(np.concatenate([th[b, :n].float().numpy() for b, n in enumerate(lengths)]),
            np.concatenate([np.asarray(jh[b, :n].astype(jnp.float32))
                            for b, n in enumerate(lengths)]))]
    cur = lengths.copy()
    for step in range(3):
        (x,) = _arrays([(B, 1, jcfg.dim)], seed=9 + step)
        jx, jcache = jllama.decoder_forward(
            jcfg, jp, jnp.asarray(x).astype(jdt), make_decode_mask(jnp.asarray(cur) + 1, S),
            jnp.asarray(cur)[:, None], cache=jcache, cache_positions=jnp.asarray(cur),
            lora=jlora, lora_scaling=scaling, use_flash_decode="xla")
        tx, tcache = tllama.decode_step(tcfg, tp, torch.from_numpy(x).to(tdt), tcache,
                                        torch.from_numpy(cur), tlora, scaling)
        logits_t = tllama.lm_logits(tcfg, tp, tx)
        logits_j = jllama.lm_logits(jcfg, jp, jx)
        out.append((logits_t.float().numpy(), np.asarray(logits_j.astype(jnp.float32))))
        cur = cur + 1
    return out


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_qwen2_shaped_decoder_prefill_and_decode_match_jax(qwen2_decoder, bits):
    """f32: the prefill's hidden states and the logits (tied embeddings) of
    3 cached decode steps within 1e-4, plain, int8 and int4 weights."""
    jcfg, params, lora, scaling = qwen2_decoder
    if bits:
        params = _np(jquant.quantize_decoder(_jnp(params), bits=bits))
        assert ("q4" if bits == 4 else "q") in params["layers"]["mlp"]["w_down"]
    for got, want in _decoder_run(jcfg, _jnp(params), _jnp(lora),
                                  params_from_numpy(params, device="cpu"),
                                  params_from_numpy(lora, device="cpu"), scaling,
                                  jnp.float32, torch.float32):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_qwen2_shaped_decoder_bf16_matches_jax(qwen2_decoder):
    """bf16 weights, activations and cache in both packages: each stage
    within 2e-2 × its largest |value| (about 3 bf16 steps: the two order
    their bf16 roundings differently), argmax logits equal."""
    jcfg, params, lora, scaling = qwen2_decoder
    bf = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    stages = _decoder_run(jcfg, bf(params), bf(lora),
                          params_from_numpy(params, device="cpu", dtype=torch.bfloat16),
                          params_from_numpy(lora, device="cpu", dtype=torch.bfloat16),
                          scaling, jnp.bfloat16, torch.bfloat16)
    for i, (got, want) in enumerate(stages):
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), i
        if i:
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# -- qwen2-audio-tiny's model functions ------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    """JAX's qwen2-audio-tiny weights (seed 0) with a non-zero LoRA B."""
    params = _np(jqa.init_qwen_audio(jax.random.PRNGKey(0), jqa.qwen2_audio_tiny()))
    rng = np.random.RandomState(5)
    for leaf in params["lora"].values():
        leaf["b"] = (rng.randn(*leaf["b"].shape) * 0.05).astype(np.float32)
    params["projector"]["b"] = (rng.randn(*params["projector"]["b"].shape) * 0.05).astype(
        np.float32)
    return params


def _pack(cls):
    return cls(seq_len=2560, text_len=512, max_slots=K + 1, audio_tokens_per_slot=750,
               audio_len_fn=tqa.audio_output_length if cls is PackConfig
               else jqa.audio_output_length)


def _dataset(factory, registry):
    return factory.create_dataset(
        registry.DatasetType.VOXCELEB, split=registry.DatasetSplit.TEST,
        input_mode="speech_only", fewshot_mode="speech", num_examples=K, max_samples=4,
        synthetic=True, synthetic_size=8, seed=3, prompt_style="qwen")


@pytest.fixture(scope="module")
def batches():
    """The same two Qwen-format requests packed by both packages → (port
    arrays, JAX arrays); they must agree exactly."""
    tok = get_tokenizer()
    tp = collate_icl_batch([_dataset(tdata, tregistry)[i] for i in range(2)], tok,
                           _pack(PackConfig))
    jp = jcollate([_dataset(jdata, jregistry)[i] for i in range(2)], tok, _pack(JPackConfig))
    arrays = []
    for p in (tp, jp):
        arrays.append({"text_tokens": p.text_tokens, "gather_idx": p.gather_idx,
                       "seq_mask": p.seq_mask, "seq_lengths": p.seq_lengths,
                       "shifted_labels": p.labels_shifted, **p.audio})
    for k in arrays[1]:
        np.testing.assert_array_equal(np.asarray(arrays[0][k]), np.asarray(arrays[1][k]), k)
    assert "audio_lengths" in arrays[0]
    return arrays


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_encode_audio_with_variable_clip_lengths_and_assembly_match_jax(tiny_params, batches):
    """Clips of 1 s and 3 s and a missing one (30 s of silence, as the
    collator pads it): each clip's first audio_output_length(n) positions
    (the positions the splice reads) within 1e-4; then the assembled
    sequence of a packed batch, every position."""
    cfg, tcfg = jqa.qwen2_audio_tiny(), tqa.qwen2_audio_tiny()
    tparams = params_from_numpy(tiny_params, device="cpu")
    rng = np.random.RandomState(6)
    wavs = np.zeros((3, 480000), np.float32)
    n = np.array([16000, 48000, 480000], np.int32)
    wavs[0, :16000] = rng.randn(16000) * 0.1
    wavs[1, :48000] = rng.randn(48000) * 0.1
    want = np.asarray(jqa.encode_audio(cfg, _jnp(tiny_params),
                                       jlog_mel(jnp.asarray(wavs), cfg.encoder.n_mels),
                                       jnp.asarray(n)))
    got = tqa.encode_audio(tcfg, tparams, tlog_mel(torch.from_numpy(wavs), tcfg.encoder.n_mels),
                           torch.from_numpy(n))
    assert got.shape == want.shape == (3, 750, tcfg.llm.dim)
    spliced = [tqa.audio_output_length(int(x)) for x in n]
    assert spliced == [25, 75, 750]  # 25 positions a second
    for i, m in enumerate(spliced):
        np.testing.assert_allclose(got[i, :m].numpy(), want[i, :m], rtol=1e-4, atol=1e-4)
    tb, jb = batches
    want_seq = np.asarray(jqa._assemble(cfg, _jnp(tiny_params), jnp.asarray(jb["text_tokens"]),
                                        jqa._encode_batch_audio(cfg, _jnp(tiny_params),
                                                                _jnp(jb)),
                                        jnp.asarray(jb["gather_idx"])))
    got_seq = tqa.qwen_sequence(tcfg, tparams, _t(tb))
    np.testing.assert_allclose(got_seq.numpy(), want_seq, rtol=1e-4, atol=1e-4)


def _tower_30s(tcfg, tparams, mels, frames):
    """The port's tower over the whole 3000-frame mel: ``whisper_encode``
    with the key mask, the pool, ``ln_post`` and the projector."""
    feats = twhisper.whisper_encode(tcfg.encoder, tparams["encoder"], mels,
                                    apply_ln_post=False, frame_lengths=frames)
    N, T, D = feats.shape
    pooled = feats.reshape(N, T // 2, 2, D).mean(dim=2)
    ln = tparams["encoder"]["ln_post"]
    pooled = twhisper.layer_norm(pooled, ln["w"], ln["b"])
    return twhisper.linear(pooled, tparams["projector"]["w"], tparams["projector"]["b"])


def _clip_samples(frames):
    """Raw sample counts whose clips hold these valid post-conv frames."""
    n = [(2 * f - 1) * 160 for f in frames]
    assert [int(tqa.audio_feat_lengths(x)) for x in n] == list(frames)
    return n


# (valid post-conv frames a clip) → post-conv frames the tower runs
_TRIM_CASES = {
    "longest_1s": ([50, 25], 128),
    "longest_3s": ([150, 50, 100], 256),
    "receptive_edge": ([127, 3], 128),  # the last valid frame at T' − 2, the + 1 frame at T' − 1
    "below_a_bucket": ([126, 64], 128),
    "above_a_bucket": ([128, 126], 256),  # without the + 1 frame: 128, and frame 127 off
    "clip_of_30s": ([1500, 50], 1500),
}


def _record_tower(monkeypatch):
    """Wrap ``encode_audio``'s tower (``whisper_encode``) → the mel frames
    each call got and the rows it returned."""
    seen = []
    encode = tqa.whisper_encode

    def recorded(cfg, params, mel, *a, **k):
        out = encode(cfg, params, mel, *a, **k)
        seen.append((mel.shape[-1], out.shape[1]))
        return out

    monkeypatch.setattr(tqa, "whisper_encode", recorded)
    return seen


@pytest.mark.parametrize("case", list(_TRIM_CASES))
def test_encode_audio_runs_to_the_longest_clip_and_matches_jax_and_the_30s_tower(
        tiny_params, monkeypatch, case):
    """``encode_audio`` runs the tower over one frame past the batch's
    longest clip in buckets of 128: at every spliced position within 1e-4 of
    JAX's ``encode_audio`` and of the port's own tower over the whole
    3000-frame mel; zeros from T'/2 to 750; the tower gets 2T' mel frames
    and returns T' rows, whether T' is read from the lengths on the device
    or given from the host copy (``host_tower_frames``), with the same
    output."""
    frames, run = _TRIM_CASES[case]
    cfg, tcfg = jqa.qwen2_audio_tiny(), tqa.qwen2_audio_tiny()
    tparams = params_from_numpy(tiny_params, device="cpu")
    n = np.array(_clip_samples(frames), np.int32)
    rng = np.random.RandomState(16)
    wavs = np.zeros((len(n), 480000), np.float32)
    for i, x in enumerate(n):
        wavs[i, :x] = rng.randn(x) * 0.1
    mels = tlog_mel(torch.from_numpy(wavs), tcfg.encoder.n_mels)
    want = np.asarray(jqa.encode_audio(cfg, _jnp(tiny_params),
                                       jlog_mel(jnp.asarray(wavs), cfg.encoder.n_mels),
                                       jnp.asarray(n)))
    full = _tower_30s(tcfg, tparams, mels, torch.tensor(frames))
    assert tqa.tower_frames(torch.tensor(frames)) == run == tqa.host_tower_frames(n)
    seen = _record_tower(monkeypatch)
    got = tqa.encode_audio(tcfg, tparams, mels, torch.from_numpy(n))
    given = tqa.encode_audio(tcfg, tparams, mels, torch.from_numpy(n), tqa.host_tower_frames(n))
    assert seen == [(2 * run, run)] * 2
    assert torch.equal(got, given)
    assert got.shape == want.shape == full.shape == (len(n), 750, tcfg.llm.dim)
    for i, x in enumerate(n):
        m = int(tqa.audio_output_length(x))
        np.testing.assert_allclose(got[i, :m].numpy(), want[i, :m], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[i, :m].numpy(), full[i, :m].numpy(), rtol=1e-4,
                                   atol=1e-4)
    assert torch.all(got[:, run // 2:] == 0)


def test_encode_audio_without_lengths_and_salmonns_whisper_run_every_frame(tiny_params,
                                                                           monkeypatch):
    """No ``sample_lengths``: no key mask, so all 1500 frames run and every
    position matches JAX's; SALMONN's Whisper path (no key mask either) runs
    1500 frames a clip and matches JAX's ``whisper_encode``."""
    from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
    from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn

    cfg, tcfg = jqa.qwen2_audio_tiny(), tqa.qwen2_audio_tiny()
    rng = np.random.RandomState(17)
    wavs = np.zeros((2, 480000), np.float32)
    wavs[0, :16000] = rng.randn(16000) * 0.1
    wavs[1, :40000] = rng.randn(40000) * 0.1
    want = np.asarray(jqa.encode_audio(cfg, _jnp(tiny_params),
                                       jlog_mel(jnp.asarray(wavs), cfg.encoder.n_mels)))
    seen = _record_tower(monkeypatch)
    got = tqa.encode_audio(tcfg, params_from_numpy(tiny_params, device="cpu"),
                           tlog_mel(torch.from_numpy(wavs), tcfg.encoder.n_mels))
    assert seen == [(3000, 1500)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    scfg = jsalmonn.salmonn_tiny()
    sparams = _np(jsalmonn.init_salmonn(jax.random.PRNGKey(0), scfg))
    mel80 = jlog_mel(jnp.asarray(wavs))
    want = np.asarray(jwhisper.whisper_encode(scfg.whisper, _jnp(sparams["whisper"]), mel80))
    got = tsalmonn.encoder_features(tsalmonn.salmonn_tiny(),
                                    params_from_numpy(sparams, device="cpu"),
                                    tlog_mel(torch.from_numpy(wavs)))
    assert got.shape == want.shape == (2, 1500, scfg.whisper.dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_the_engine_and_the_train_loop_pass_the_tower_frames_from_the_host(
        tiny_params, monkeypatch):
    """``SalmonnEngine.generate_tokens`` and the train loop's device batch
    carry ``host_tower_frames`` of the packed lengths, so ``encode_audio``
    gets T' without reading the lengths' device copy; it equals what that
    read gives."""
    from icl_speech_text_llm_tpu_torch.training.loop import _device_batch

    tok = get_tokenizer()
    tb = collate_icl_batch(_samples()[0], tok, _pack(PackConfig))
    lengths = tb.audio["audio_lengths"]
    run = tqa.host_tower_frames(lengths)
    assert run == tqa.tower_frames(tqa.audio_feat_lengths(torch.from_numpy(lengths).long()))
    assert _device_batch(tb, "cpu")["tower_frames"] == run
    given = []
    encode = tqa.encode_audio

    def recorded(cfg, params, mels, sample_lengths=None, run_frames=None):
        given.append(run_frames)
        return encode(cfg, params, mels, sample_lengths, run_frames)

    monkeypatch.setattr(tqa, "encode_audio", recorded)
    engine = tengine.SalmonnEngine(
        tqa.qwen2_audio_tiny(), params_from_numpy(tiny_params, device="cpu"), tok,
        tengine.GenerationConfig(max_new_tokens=2, eos_token_id=tok.eos_token_id,
                                 pad_token_id=tok.pad_token_id),
        device="cpu", sequence_fn=tqa.qwen_sequence)
    engine.generate_tokens(tb, tb.audio)
    assert given == [run]


def test_train_loss_and_lora_gradients_match_jax(tiny_params, batches):
    """The loss within 1e-5 and every LoRA gradient within 1e-4 × max |g|
    (the ROADMAP bounds); nothing but the LoRA trains."""
    cfg, tcfg = jqa.qwen2_audio_tiny(), tqa.qwen2_audio_tiny()
    tb, jb = batches
    jparams = _jnp(tiny_params)

    def jloss(lora):
        return jqa.qwen_audio_train_loss(cfg, {**jparams, "lora": lora}, _jnp(jb))

    want_loss, want_g = jax.value_and_grad(jloss)(jparams["lora"])
    trainable, frozen = split_params(params_from_numpy(tiny_params, device="cpu"))
    assert set(trainable) == {"lora"}
    trainable = tree_map(lambda t: t.requires_grad_(), trainable)
    loss = tqa.qwen_audio_train_loss(tcfg, merge_params(frozen, trainable), _t(tb))
    leaves = [trainable["lora"][n][ab] for n in ("wq", "wk") for ab in ("a", "b")]
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * max(1.0, abs(float(want_loss)))
    for g, (n, ab) in zip(grads, [(n, ab) for n in ("wq", "wk") for ab in ("a", "b")]):
        w = np.asarray(want_g[n][ab])
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("num_beams", [1, 2])
def test_generate_tokens_identical_to_jax(tiny_params, batches, num_beams):
    cfg, tcfg = jqa.qwen2_audio_tiny(), tqa.qwen2_audio_tiny()
    tb, jb = batches
    gen_kw = dict(max_new_tokens=8, eos_token_id=2, pad_token_id=0, num_beams=num_beams)
    keys = ("text_tokens", "gather_idx", "seq_lengths", "wavs", "audio_lengths")
    want = np.asarray(jax.jit(functools.partial(
        jqa.qwen_audio_generate, cfg, jengine.GenerationConfig(**gen_kw)))(
        _jnp(tiny_params), {k: jnp.asarray(jb[k]) for k in keys}))
    got = tqa.qwen_audio_generate(tcfg, tengine.GenerationConfig(**gen_kw),
                                  params_from_numpy(tiny_params, device="cpu"),
                                  _t({k: tb[k] for k in keys})).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    first = tengine.first_token_logits(tcfg, params_from_numpy(tiny_params, device="cpu"),
                                       _t({k: tb[k] for k in keys}), tqa.qwen_sequence)
    np.testing.assert_array_equal(first.argmax(-1).numpy(), want[:, 0])


# -- the model surface, converted weights, the converter ---------------------------------

def test_create_model_routes_every_qwen_preset_and_refuses_unknown_keys(monkeypatch):
    """Each of the five keys builds a QwenAudioModel on its preset, the same
    configuration as JAX's (the weights are not drawn here: 7B would be
    30 GB on the host); an unknown key raises ValueError, as JAX's does."""
    seen = []

    def init(cfg, gen, device, dtype, trainable_dtype=None, skip_llm=False):
        seen.append((cfg, dtype))
        return {}

    monkeypatch.setattr(tfactory, "init_qwen_audio", init)
    assert set(tfactory.QWEN_PRESETS) == set(jfactory.QWEN_PRESETS)
    for key in jfactory.QWEN_PRESETS:
        model = tfactory.create_model(key, device="cpu")
        assert isinstance(model, tfactory.QwenAudioModel)
        assert model.pack_cfg.audio_len_fn is tqa.audio_output_length
        assert model.engine.sequence_fn is tqa.qwen_sequence
        cfg, dtype = seen[-1]
        want = getattr(jqa, jfactory.QWEN_PRESETS[key])()
        assert dataclasses.asdict(cfg.llm) == dataclasses.asdict(want.llm)
        enc = dataclasses.asdict(want.encoder)
        enc.pop("use_flash")  # the port's tower always takes K2
        assert dataclasses.asdict(cfg.encoder) == enc
        assert cfg.lora == tllama.LoraConfig(**dataclasses.asdict(want.lora))
        assert cfg.audio_tokens_per_slot == want.audio_tokens_per_slot == 750
        assert dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
            want.compute_dtype]
    for factory in (jfactory, tfactory):
        with pytest.raises(ValueError, match="Unknown model type"):
            factory.create_model("qwen3-audio", device="cpu")


@pytest.fixture(scope="module")
def models(tiny_params):
    """JAX's and the port's qwen2-audio-tiny with the same weights."""
    jmodel = jfactory.create_model("qwen2-audio-tiny", seed=0)
    jmodel.params = _jnp(tiny_params)
    tmodel = tfactory.create_model("qwen2-audio-tiny", seed=0, device="cpu")
    tmodel.params = tmodel.engine.params = params_from_numpy(tiny_params, device="cpu")
    return jmodel, tmodel


def _samples():
    return ([_dataset(tdata, tregistry)[i] for i in range(2)],
            [_dataset(jdata, jregistry)[i] for i in range(2)])


def test_qwen_model_surface_matches_jax(models):
    jmodel, tmodel = models
    tsamples, jsamples = _samples()
    got = tmodel.forward(tsamples)["loss"].item()
    want = float(jmodel.forward(jsamples)["loss"])
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    assert tmodel.generate_output(tsamples) == jmodel.generate_output(jsamples)
    wavs = (np.random.RandomState(3).randn(2, 16000) * 0.1).astype(np.float32)
    np.testing.assert_allclose(tmodel.get_speech_embeddings(wavs).numpy(),
                               np.asarray(jmodel.get_speech_embeddings(wavs)),
                               rtol=1e-4, atol=1e-4)


def test_load_trainable_reads_a_jax_state_npy(models, tmp_path, monkeypatch):
    """A checkpoint JAX wrote for qwen2-audio-tiny (its LoRA only, as
    ``state.npy``: its format without orbax, which the port has not)
    replaces the port model's LoRA; the rest of the tree stays."""
    jmodel, tmodel = models
    rng = np.random.RandomState(9)
    lora = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.02).astype(np.float32), _np(jmodel.params["lora"]))
    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)
    jckpt.save_checkpoint(str(tmp_path / "ck"), {"lora": _jnp(lora)}, step=3)
    model = tfactory.create_model("qwen2-audio-tiny", seed=0, device="cpu")
    before = model.params["encoder"]["conv1"]["w"].clone()
    model.load_trainable(str(tmp_path / "ck"))
    for name in lora:
        for ab in ("a", "b"):
            np.testing.assert_array_equal(model.params["lora"][name][ab].numpy(), lora[name][ab])
    assert model.engine.params is model.params
    assert torch.equal(model.params["encoder"]["conv1"]["w"], before)


def test_llm_params_dir_of_a_qwen2_decoder_loads_as_in_jax(monkeypatch, tmp_path):
    """qwen2-audio-tiny over the Qwen2-shaped test decoder: HF shards
    (``synth_ckpt.write_hf_decoder_shards``, tied embeddings, qkv biases)
    converted by JAX at f32 load into both packages' models, which never
    draw the decoder; the decoder leaves are identical and the first-token
    logits of a packed batch agree within 1e-4 (the tiled filler of the
    shards repeats rows, so logits tie and tokens are not compared)."""
    jcfg = dataclasses.replace(jqa.qwen2_audio_tiny(), llm=jllama.DecoderConfig(**QWEN2_TEST))
    tcfg = dataclasses.replace(tqa.qwen2_audio_tiny(), llm=tllama.DecoderConfig(**QWEN2_TEST))
    monkeypatch.setattr(jqa, "qwen2_audio_tiny", lambda: jcfg)
    monkeypatch.setitem(tfactory.QWEN_PRESETS, "qwen2-audio-tiny", lambda: tcfg)
    shards = str(tmp_path / "hf")
    write_hf_decoder_shards(shards, tcfg.llm, dtype=np.float16, seed=4)
    dst = str(tmp_path / "llm")
    jstream.stream_decoder_to_dir(jstream.TensorSource(shards), jcfg.llm, dst, dtype="float32")
    jmodel = jfactory.create_model("qwen2-audio-tiny", seed=0, llm_params_dir=dst)
    tmodel = tfactory.create_model("qwen2-audio-tiny", seed=0, device="cpu", llm_params_dir=dst)
    jllm, tllm = _np(jmodel.params["llm"]), tmodel.params["llm"]
    assert "lm_head" not in tllm and set(tllm["layers"]["attn"]) >= {"bq", "bk", "bv"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jllm)[0]:
        node = tllm
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), leaf.astype(np.float32))
    # the subtrees neither loads (drawn differently by the two) from one source
    drawn = {k: _np(jmodel.params[k]) for k in ("encoder", "projector", "lora")}
    params = {**_np(jmodel.params), **drawn}
    tmodel.params = {**tmodel.params, **params_from_numpy(drawn, device="cpu")}
    tok = get_tokenizer()
    tb = collate_icl_batch(_samples()[0], tok, _pack(PackConfig))
    keys = {"text_tokens": tb.text_tokens, "gather_idx": tb.gather_idx,
            "seq_lengths": tb.seq_lengths, **tb.audio}
    got = tengine.first_token_logits(tcfg, tmodel.params, _t(keys), tqa.qwen_sequence)
    jparams = _jnp(params)
    seq = jqa._assemble(jcfg, jparams, jnp.asarray(tb.text_tokens),
                        jqa._encode_batch_audio(jcfg, jparams, _jnp(keys)),
                        jnp.asarray(tb.gather_idx))
    L = seq.shape[1]
    lengths = jnp.asarray(tb.seq_lengths)
    hidden, _ = jllama.decoder_forward(jcfg.llm, jparams["llm"], seq,
                                       make_prefill_mask(lengths, L),
                                       jnp.broadcast_to(jnp.arange(L), (2, L)),
                                       lora=jparams["lora"], lora_scaling=jcfg.lora.scaling)
    last = hidden[jnp.arange(2), lengths - 1]
    want = np.asarray(jllama.lm_logits(jcfg.llm, jparams["llm"], last))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _qwen_audio_state_dict(cfg, seed=0):
    """A synthetic Qwen2AudioForConditionalGeneration state dict at cfg's
    shapes (HF layout, torch (out, in) weights)."""
    rng = np.random.RandomState(seed)
    enc, llm = cfg.encoder, cfg.llm
    d, hd = enc.dim, llm.hd
    shapes = {"audio_tower.conv1.weight": (d, enc.n_mels, 3), "audio_tower.conv1.bias": (d,),
              "audio_tower.conv2.weight": (d, d, 3), "audio_tower.conv2.bias": (d,),
              "audio_tower.embed_positions.weight": (enc.n_ctx, d),
              "audio_tower.layer_norm.weight": (d,), "audio_tower.layer_norm.bias": (d,),
              "multi_modal_projector.linear.weight": (llm.dim, d),
              "multi_modal_projector.linear.bias": (llm.dim,),
              "language_model.model.embed_tokens.weight": (llm.vocab_size, llm.dim),
              "language_model.model.norm.weight": (llm.dim,)}
    if not llm.tie_embeddings:
        shapes["language_model.lm_head.weight"] = (llm.vocab_size, llm.dim)
    for i in range(enc.n_layers):
        p = f"audio_tower.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[p + f"self_attn.{n}.weight"] = (d, d)
            if n != "k_proj":
                shapes[p + f"self_attn.{n}.bias"] = (d,)
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[p + f"{n}.weight"] = (d,)
            shapes[p + f"{n}.bias"] = (d,)
        shapes.update({p + "fc1.weight": (4 * d, d), p + "fc1.bias": (4 * d,),
                       p + "fc2.weight": (d, 4 * d), p + "fc2.bias": (d,)})
    for i in range(llm.n_layers):
        p = f"language_model.model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (llm.n_heads * hd, llm.dim),
                       p + "self_attn.k_proj.weight": (llm.n_kv_heads * hd, llm.dim),
                       p + "self_attn.v_proj.weight": (llm.n_kv_heads * hd, llm.dim),
                       p + "self_attn.o_proj.weight": (llm.dim, llm.n_heads * hd),
                       p + "mlp.gate_proj.weight": (llm.hidden_dim, llm.dim),
                       p + "mlp.up_proj.weight": (llm.hidden_dim, llm.dim),
                       p + "mlp.down_proj.weight": (llm.dim, llm.hidden_dim),
                       p + "input_layernorm.weight": (llm.dim,),
                       p + "post_attention_layernorm.weight": (llm.dim,)})
        if llm.qkv_bias:
            shapes.update({p + "self_attn.q_proj.bias": (llm.n_heads * hd,),
                           p + "self_attn.k_proj.bias": (llm.n_kv_heads * hd,),
                           p + "self_attn.v_proj.bias": (llm.n_kv_heads * hd,)})
    return {k: (rng.randn(*s) * 0.05).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("llm", ["tiny", "qwen2-test"])
def test_convert_hf_qwen_audio_is_byte_identical_to_jax(llm):
    jcfg = jqa.qwen2_audio_tiny()
    if llm != "tiny":
        jcfg = dataclasses.replace(jcfg, llm=jllama.DecoderConfig(**QWEN2_TEST))
    sd = _qwen_audio_state_dict(jcfg)
    want = _np(jconvert.convert_hf_qwen_audio(sd, jcfg))
    got = tconvert.convert_hf_qwen_audio(sd, jcfg)
    flat_w = {"/".join(p.key for p in kp): v
              for kp, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {"/".join(p.key for p in kp): v
              for kp, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        g = np.asarray(flat_g[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
    tree = params_from_numpy(got, device="cpu")  # the port's tree layout
    assert tree["projector"]["w"].shape == (jcfg.encoder.dim, jcfg.llm.dim)
