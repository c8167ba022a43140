"""K7, the flash-decode kernel: its plain PyTorch version against the JAX
package's Pallas ``flash_decode_attention`` / ``flash_decode_attention_q8``
in interpret mode, and the decode step with ``use_flash_decode=True``
against JAX's zero-copy flash path, on the CPU.

Same inputs (numpy, seeded) through both. Bounds: 1e-5 at f32 (the f32
rounding of two softmax orders: JAX tiles the keys by 128 with an online
softmax, the plain version takes one max); at bf16 2e-2 (p is rounded to
bf16 before the P·V product, against a different running max per tile in
the kernel, so probabilities may differ by one bf16 ulp, 2^-8 relative).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu.ops import quant as jquant
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask
from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
B, S, D = 2, 256, 128
LENGTHS = [200, 37]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _arrays(shapes, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _decode_inputs(H, Hkv, seed):
    q, = _arrays([(B, H, 1, D)], seed)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed + 1)
    kn, vn = _arrays([(B, Hkv, 1, D)] * 2, seed + 2)
    return q, k, v, kn, vn


def _jax_bf16(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _torch_bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (7, 1)])
@pytest.mark.parametrize("self_col", [False, True])
def test_flash_decode_plain_matches_pallas_kernel(dtype, tol, H, Hkv, self_col):
    """bf16 cache: MHA, n_rep = 2 and n_rep = 7, ragged lengths, with and
    without the self column (lengths then count previous tokens)."""
    q, k, v, kn, vn = _decode_inputs(H, Hkv, seed=H * 10 + Hkv)
    lens = np.array(LENGTHS, np.int32)
    if dtype == "bf16":
        jq, jk, jv, jkn, jvn = _jax_bf16(q, k, v, kn, vn)
        tq, tk, tv, tkn, tvn = _torch_bf16(q, k, v, kn, vn)
    else:
        jq, jk, jv, jkn, jvn = map(jnp.asarray, (q, k, v, kn, vn))
        tq, tk, tv, tkn, tvn = map(torch.from_numpy, (q, k, v, kn, vn))
    want = jfa.flash_decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=128,
                                      self_kv=(jkn, jvn) if self_col else None)
    got = tfa.flash_decode_attention_plain(tq, tk, tv, torch.from_numpy(lens),
                                           self_kv=(tkn, tvn) if self_col else None)
    assert got.shape == (B, H, 1, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _quantized_cache(k, v):
    """int8 rows and f32 per-position scales by the JAX package's quantize_kv."""
    k8, ks = jquant.quantize_kv(jnp.asarray(k))
    v8, vs = jquant.quantize_kv(jnp.asarray(v))
    return [np.array(a) for a in (k8, v8, ks, vs)]


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_flash_decode_q8_plain_matches_pallas_kernel(dtype, tol, H, Hkv):
    """int8 cache: k's scale on the score columns, v's on p after l, the self
    column unquantized."""
    q, k, v, kn, vn = _decode_inputs(H, Hkv, seed=50 + H + Hkv)
    k8, v8, ks, vs = _quantized_cache(k * 2, v * 2)
    lens = np.array(LENGTHS, np.int32)
    cast_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dtype == "bf16" else jnp.asarray
    cast_t = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) if dtype == "bf16" \
        else torch.from_numpy
    want = jfa.flash_decode_attention_q8(
        cast_j(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(lens), block_k=128, self_kv=(cast_j(kn), cast_j(vn)))
    got = tfa.flash_decode_attention_q8(
        cast_t(q), *map(torch.from_numpy, (k8, v8, ks, vs)), torch.from_numpy(lens),
        self_kv=(cast_t(kn), cast_t(vn)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def test_flash_decode_reads_the_stacked_cache_at_a_layer():
    """``layer=`` on a stacked (L, B, Hkv, S, D) cache reads that layer's view,
    as the Pallas kernel's scalar-prefetched layer index does."""
    L, H, Hkv = 3, 4, 2
    q, = _arrays([(B, H, 1, D)], 60)
    ck, cv = _arrays([(L, B, Hkv, S, D)] * 2, 61)
    lens = np.array(LENGTHS, np.int32)
    want = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                      jnp.asarray(lens), block_k=128,
                                      layer=jnp.asarray([2], jnp.int32))
    got = tfa.flash_decode_attention(*map(torch.from_numpy, (q, ck, cv, lens)), layer=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    k8, v8, ks, vs = (np.stack(t) for t in zip(*[_quantized_cache(ck[l], cv[l])
                                                 for l in range(L)]))
    want8 = jfa.flash_decode_attention_q8(
        jnp.asarray(q), *map(jnp.asarray, (k8, v8, ks, vs)), jnp.asarray(lens), block_k=128,
        layer=jnp.asarray([1], jnp.int32))
    got8 = tfa.flash_decode_attention_q8(torch.from_numpy(q),
                                         *map(torch.from_numpy, (k8, v8, ks, vs, lens)), layer=1)
    np.testing.assert_allclose(got8.numpy(), np.asarray(want8), rtol=0, atol=1e-5)


def test_flash_decode_gate_and_cpu_wrappers():
    """The shape gate states what the CUDA kernel takes; on CPU tensors the
    wrappers run the plain version and count no launch; a length of 0
    without the self column gives 0."""
    assert tfa.flash_decode_usable((4, 32, 1, 128), (4, 32, 1152, 128))
    assert tfa.flash_decode_usable((16, 28, 1, 128), (16, 4, 256, 128))  # n_rep 7
    assert not tfa.flash_decode_usable((4, 32, 1, 64), (4, 32, 1152, 64))
    assert not tfa.flash_decode_usable((4, 32, 2, 128), (4, 32, 1152, 128))
    assert not tfa.flash_decode_usable((4, 32, 1, 128), (4, 2, 1152, 128))  # n_rep 16
    kernels.reset_launch_counts()
    q, k, v, kn, vn = (torch.from_numpy(a) for a in _decode_inputs(4, 2, 70))
    lens = torch.tensor([0, 5])
    o = tfa.flash_decode_attention(q, k, v, lens)
    assert torch.all(o[0] == 0) and torch.all(o[1] != 0)
    o_self = tfa.flash_decode_attention(q, k, v, lens, self_kv=(kn, vn))
    # a sample with no cached token attends only its own column: o = v_new
    np.testing.assert_allclose(o_self[0, :, 0].numpy(),
                               np.repeat(vn[0, :, 0].numpy(), 2, axis=0), atol=1e-6)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def _tiny_decoder(n_heads, n_kv_heads):
    cfg = dataclasses.replace(jllama.DECODER_CONFIGS["tiny"], n_heads=n_heads,
                              n_kv_heads=n_kv_heads, head_dim=128)
    tcfg = dataclasses.replace(tllama.DECODER_CONFIGS["tiny"], n_heads=n_heads,
                               n_kv_heads=n_kv_heads, head_dim=128)
    params = jax.tree_util.tree_map(np.asarray, jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    return cfg, tcfg, params


@pytest.mark.parametrize("quant,dtype,tol", [(False, "f32", 1e-4), (True, "f32", 1e-4),
                                             (False, "bf16", 3e-2)])
def test_decode_step_with_flash_decode_matches_jax_zero_copy_flash_path(monkeypatch, quant,
                                                                         dtype, tol):
    """Two chained decode steps with ``use_flash_decode=True``: JAX takes its
    zero-copy path through the Pallas kernel (the gate opened, as its own
    test does off the TPU), the port the K7 plain version. Hidden states
    within 1e-4 at f32 and 3e-2 at bf16 (weights, activations and cache in
    bf16 on both sides, rounded at other places); the appended rows and
    scales as JAX's (int8 bytes within ±1 on rounding ties, bf16 rows within
    one bf16 step)."""
    monkeypatch.setattr(jfa, "flash_decode_usable", lambda *a: True)
    cfg, tcfg, params = _tiny_decoder(4, 2)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    tp = params_from_numpy(params, device="cpu", dtype=tdt)
    Sc = 256
    cur = np.array([100, 40], np.int32)
    k0, v0 = _arrays([(cfg.n_layers, B, 2, Sc, 128)] * 2, 80, 0.5)
    if quant:
        k8, v8, ks, vs = _quantized_cache(k0, v0)
        jcache = {"k": jnp.asarray(k8), "v": jnp.asarray(v8), "k_s": jnp.asarray(ks),
                  "v_s": jnp.asarray(vs)}
    else:
        jcache = {"k": jnp.asarray(k0, jdt), "v": jnp.asarray(v0, jdt)}
    tcache = params_from_numpy({n: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                                else np.asarray(a) for n, a in jcache.items()},
                               device="cpu", dtype=tdt)
    for step in range(2):
        x, = _arrays([(B, 1, cfg.dim)], 90 + step, 0.5)
        jx, jcache = jllama.decoder_forward(
            cfg, jp, jnp.asarray(x, jdt), make_decode_mask(jnp.asarray(cur) + 1, Sc),
            jnp.asarray(cur)[:, None], cache=jcache, cache_positions=jnp.asarray(cur),
            use_flash_decode=True)
        tx, tcache = tllama.decode_step(tcfg, tp, torch.from_numpy(x).to(tdt), tcache,
                                        torch.from_numpy(cur),
                                        attention=tllama.DecodeAttention.FLASH)
        np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx, np.float32),
                                   rtol=tol, atol=tol)
        for name in jcache:
            want = np.asarray(jcache[name], np.float32 if dtype == "bf16" else None)
            got = tcache[name].float().numpy() if dtype == "bf16" else tcache[name].numpy()
            if name in ("k", "v") and quant:
                d = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3
            elif dtype == "bf16":  # one bf16 step at the rows' magnitude (≤ 4)
                np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -6)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        cur = cur + 1


@pytest.mark.parametrize("quant", [False, True])
def test_decode_step_flash_outside_the_gate_takes_the_xla_math(monkeypatch, quant):
    """``use_flash_decode=True`` at a shape ``flash_decode_usable`` refuses
    (head_dim 32, as salmonn-tiny's) is a routing choice, not an error: the
    port decodes with ``_xla_decode_attn`` and never calls K7, as JAX takes
    its generic path. Two chained f32 steps match JAX's to 1e-4: its generic
    path for the bf16 cache; for the int8 cache its ``"xla"`` path, since the
    generic one attends the current token through its quantized row where
    both zero-copy paths keep it unquantized."""
    cfg = dataclasses.replace(jllama.DECODER_CONFIGS["tiny"], head_dim=32)
    tcfg = dataclasses.replace(tllama.DECODER_CONFIGS["tiny"], head_dim=32)
    assert not tfa.flash_decode_usable((B, tcfg.n_heads, 1, 32), (B, tcfg.n_kv_heads, 256, 32))
    params = jax.tree_util.tree_map(np.asarray, jllama.init_decoder(jax.random.PRNGKey(1), cfg))

    def refuse(*a, **kw):
        raise AssertionError("K7 called outside its gate")

    monkeypatch.setattr(tllama, "flash_decode_attention", refuse)
    monkeypatch.setattr(tllama, "flash_decode_attention_q8", refuse)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu", dtype=torch.float32)
    Sc = 256
    cur = np.array([100, 40], np.int32)
    k0, v0 = _arrays([(cfg.n_layers, B, cfg.n_kv_heads, Sc, 32)] * 2, 81, 0.5)
    if quant:
        k8, v8, ks, vs = _quantized_cache(k0, v0)
        cache = {"k": k8, "v": v8, "k_s": ks, "v_s": vs}
    else:
        cache = {"k": k0, "v": v0}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = params_from_numpy(cache, device="cpu", dtype=torch.float32)
    for step in range(2):
        x, = _arrays([(B, 1, cfg.dim)], 95 + step, 0.5)
        jx, jcache = jllama.decoder_forward(
            cfg, jp, jnp.asarray(x), make_decode_mask(jnp.asarray(cur) + 1, Sc),
            jnp.asarray(cur)[:, None], cache=jcache, cache_positions=jnp.asarray(cur),
            use_flash_decode="xla" if quant else True)
        tx, tcache = tllama.decode_step(tcfg, tp, torch.from_numpy(x), tcache,
                                        torch.from_numpy(cur),
                                        attention=tllama.DecodeAttention.FLASH)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
        cur = cur + 1
