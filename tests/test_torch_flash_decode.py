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


def test_decode_step_flash_over_an_int8_cache_k7_q8_cannot_read_takes_the_xla_math(
        monkeypatch):
    """An int8 cache of S = 1001 at head_dim 128: ``flash_decode_usable``
    admits the shapes, but K7 q8 reads rows in runs of 4 and its wrapper
    refuses S % 4 ≠ 0, so ``decode_step`` with ``attention=FLASH`` decodes
    with ``_xla_decode_attn`` and never calls K7 q8 (JAX's gate, S % 128 ==
    0, sends such a cache to its other paths). Two chained f32 steps match
    JAX's ``"xla"`` path to 1e-4, and the caches after each step match:
    int8 bytes within ±1 on rounding ties, scales within 1e-5 relative."""
    cfg, tcfg, params = _tiny_decoder(4, 2)
    Sc = 1001
    assert tfa.flash_decode_usable((B, 4, 1, 128), (B, 2, Sc, 128))

    def refuse(*a, **kw):
        raise AssertionError("K7 q8 called on a cache its wrapper refuses")

    monkeypatch.setattr(tllama, "flash_decode_attention_q8", refuse)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu", dtype=torch.float32)
    cur = np.array([998, 640], np.int32)  # the last step writes row S − 2
    k0, v0 = _arrays([(cfg.n_layers, B, 2, Sc, 128)] * 2, 82, 0.5)
    cache = dict(zip(("k", "v", "k_s", "v_s"), _quantized_cache(k0, v0)))
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = params_from_numpy(cache, device="cpu", dtype=torch.float32)
    assert not tfa.q8_cache_layout_ok(tcache["k"], tcache["v"], tcache["k_s"], tcache["v_s"])
    for step in range(2):
        x, = _arrays([(B, 1, cfg.dim)], 97 + step, 0.5)
        jx, jcache = jllama.decoder_forward(
            cfg, jp, jnp.asarray(x), make_decode_mask(jnp.asarray(cur) + 1, Sc),
            jnp.asarray(cur)[:, None], cache=jcache, cache_positions=jnp.asarray(cur),
            use_flash_decode="xla")
        tx, tcache = tllama.decode_step(tcfg, tp, torch.from_numpy(x), tcache,
                                        torch.from_numpy(cur),
                                        attention=tllama.DecodeAttention.FLASH)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
        for name in ("k", "v"):
            d = np.abs(tcache[name].numpy().astype(np.int32)
                       - np.asarray(jcache[name]).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       rtol=1e-5, atol=1e-6)
        cur = cur + 1


# K7 q8's split and merge (csrc/flash_decode.cu:flash_decode_q8_kernel): a
# cluster of `splits` blocks per (sample, kv head), 64-row tiles dealt to 4
# consumer warps in turn, each warp rescaling its state once a tile; the warps
# merge in order, then the ranks in rank order, then the self column.
Q8_TILE, Q8_WARPS = 64, 4


def _rank_rows(length, splits):
    """The rows rank r takes, as the kernel computes them from the sample's
    length: [len·r/splits, len·(r+1)/splits), each start rounded down to a
    multiple of 4, the last rank ending at the length."""
    starts = [(length * r // splits) & ~3 for r in range(splits)] + [length]
    return list(zip(starts[:-1], starts[1:]))


def _merge_states(states):
    """(m, l, acc) states of the same heads, merged in order (e-domain)."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l, acc = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        c = torch.where(mi == -np.inf, torch.zeros_like(mi), torch.exp(mi - m))
        l = l + li * c
        acc = acc + ai * c[:, None]
    return m, l, acc


def _q8_split_merge_model(q, k8, v8, ks, vs, lengths, splits, self_kv=None):
    """f32 model of the kernel's algorithm → o (B, H, 1, D)."""
    B, H, _, D = q.shape
    Hkv, S = k8.shape[1], k8.shape[2]
    rep, scale = H // Hkv, D ** -0.5
    o = torch.zeros((B, H, 1, D))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        bounds = _rank_rows(n, splits)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(r0 % 4 == 0 and r0 <= r1 for r0, r1 in bounds)
        for hk in range(Hkv):
            qg = q[b, hk * rep:(hk + 1) * rep, 0].float()
            empty = (torch.full((rep,), -np.inf), torch.zeros(rep), torch.zeros((rep, D)))
            ranks = []
            for r0, r1 in bounds:
                warps = [empty] * Q8_WARPS
                for j, t0 in enumerate(range(r0, r1, Q8_TILE)):
                    rows = slice(t0, min(t0 + Q8_TILE, r1))
                    s = qg @ k8[b, hk, rows].float().T * scale * ks[b, hk, rows]
                    m, l, acc = warps[j % Q8_WARPS]
                    mn = torch.maximum(m, s.amax(1))
                    alpha = torch.where(m == -np.inf, torch.zeros_like(m), torch.exp(m - mn))
                    p = torch.exp(s - mn[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + (p * vs[b, hk, rows]) @ v8[b, hk, rows].float()
                    warps[j % Q8_WARPS] = (mn, l, acc)
                ranks.append(_merge_states(warps))
            m, l, acc = _merge_states(ranks)
            if self_kv is not None:
                kn, vn = (t[b, hk, 0].float() for t in self_kv)
                s_self = (qg * kn).sum(-1) * scale
                mt = torch.maximum(m, s_self)
                c = torch.where(m == -np.inf, torch.zeros_like(m), torch.exp(m - mt))
                p_self = torch.exp(s_self - mt)
                l = l * c + p_self
                acc = acc * c[:, None] + p_self[:, None] * vn
            out = torch.where(l[:, None] == 0, torch.zeros_like(acc),
                              acc / torch.where(l == 0, torch.ones_like(l), l)[:, None])
            o[b, hk * rep:(hk + 1) * rep, 0] = out
    return o


@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 2), (8, 2), (7, 1), (8, 1)])
@pytest.mark.parametrize("self_col", [False, True])
def test_q8_split_merge_model_matches_plain_and_pallas_kernel(H, Hkv, self_col):
    """The kernel's split over a cluster, its tiles and its merges, modelled
    in f32, against the plain version and the JAX Pallas q8 kernel in
    interpret mode at 1e-5: n_rep 1, 2, 4, 7 and 8; lengths 0, 1, fewer
    rows than the split (5 < 8), ragged and S; cluster sizes 1, 3 and 8."""
    Bq = 5
    rng = np.random.RandomState(100 + H + Hkv)
    q = rng.randn(Bq, H, 1, D).astype(np.float32)
    k, v = (rng.randn(Bq, Hkv, S, D).astype(np.float32) * 2 for _ in range(2))
    kn, vn = (rng.randn(Bq, Hkv, 1, D).astype(np.float32) for _ in range(2))
    k8, v8, ks, vs = _quantized_cache(k, v)
    lens = np.array([0, 1, 5, 200, S], np.int32)
    want = jfa.flash_decode_attention_q8(
        jnp.asarray(q), *map(jnp.asarray, (k8, v8, ks, vs, lens)), block_k=128,
        self_kv=(jnp.asarray(kn), jnp.asarray(vn)) if self_col else None)
    t = [torch.from_numpy(a) for a in (q, k8, v8, ks, vs, lens, kn, vn)]
    self_kv = (t[6], t[7]) if self_col else None
    plain = tfa.flash_decode_attention_plain(t[0], t[1], t[2], t[5], self_kv=self_kv,
                                             k_s=t[3], v_s=t[4])
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for splits in (1, 3, 8):
        got = _q8_split_merge_model(*t[:6], splits, self_kv)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        if not self_col:
            assert torch.all(got[0] == 0)  # no key at all: o = 0


#: blocks of K7 q8 (n_rep 1) an NVIDIA H100 80GB HBM3 holds at once for
#: cluster sizes 1-8 (c × cudaOccupancyMaxActiveClusters, as
#: ``decode_resident`` reads them; printed by ``chip_smoke._decode_sweep``)
H100_RESIDENT = (660, 660, 609, 616, 620, 606, 588, 616)


@pytest.mark.parametrize("B,Hkv,want", [(4, 40, 3), (16, 40, 1), (4, 32, 4), (16, 32, 1),
                                        (1, 8, 8), (64, 40, 1)])
def test_decode_splits_balances_132_sms_in_one_wave(B, Hkv, want):
    """The cluster size of K7 q8 at the 13B decode (4 rows; 4 beams: 16),
    the 7B one, a grid too small to balance and one of several waves: the
    busiest SM at most 1.1× the mean, the grid in one wave where it can be;
    c = 1 where the (sample, head) pairs fill the card already; the split
    whose busiest SM has the least share where no split balances."""
    c = tfa.decode_splits(B, Hkv, 132, H100_RESIDENT)
    assert c == want
    work = tfa.decode_sm_blocks(B * Hkv * c, 132)
    assert sum(work) == B * Hkv * c and max(work) - min(work) <= 1
    if B * Hkv * tfa.DECODE_MAX_SPLITS >= 2 * 132:
        assert 10 * max(work) * 132 <= 11 * sum(work)
    if B * Hkv * c <= H100_RESIDENT[0]:
        assert B * Hkv * c <= H100_RESIDENT[c - 1]


def test_q8_layout_check_states_what_the_bulk_copies_read():
    """K7 q8 reads each (sample, head)'s rows and scales as one contiguous
    run: the stacked cache's layer view passes; a cache strided along S, a
    transposed one, S not a multiple of 4, or scales strided along S do not."""
    L, Bq, Hkv, Sq = 2, 2, 3, 16
    k8 = torch.zeros((L, Bq, Hkv, Sq, D), dtype=torch.int8)
    ks = torch.zeros((L, Bq, Hkv, Sq))
    assert tfa._q8_layout_ok(k8[1], k8[0], ks[1], ks[0])
    assert not tfa._q8_layout_ok(k8[1, :, :, ::2], k8[0, :, :, ::2], ks[1, :, :, ::2],
                                 ks[0, :, :, ::2])
    kt = k8[1].transpose(1, 2).contiguous().transpose(1, 2)
    assert not tfa._q8_layout_ok(kt, kt, ks[1], ks[0])
    k6, s6 = torch.zeros((Bq, Hkv, 6, D), dtype=torch.int8), torch.zeros((Bq, Hkv, 6))
    assert not tfa._q8_layout_ok(k6, k6, s6, s6)
    s2 = torch.zeros((Bq, Hkv, Sq, 2))[..., 0]
    assert not tfa._q8_layout_ok(k8[1], k8[0], s2, s2)


def test_q8_cache_layout_check_reads_every_layer_of_the_stacked_cache():
    """``q8_cache_layout_ok`` on the stacked (L, B, Hkv, S, D) cache, as
    ``decode_step`` routes by it: ``init_kv_cache``'s layout passes at S =
    1152 and 1000; S = 1001 (rows in runs of 4 no more, and layers no more
    16 bytes apart) and scale planes strided along S do not."""
    cfg = tllama.DECODER_CONFIGS["tiny"]
    for Sq, ok in ((1152, True), (1000, True), (1001, False)):
        c = tllama.init_kv_cache(cfg, 2, Sq, quant=True, device="cpu")
        assert tfa.q8_cache_layout_ok(c["k"], c["v"], c["k_s"], c["v_s"]) is ok
    c = tllama.init_kv_cache(cfg, 2, 64, quant=True, device="cpu")
    s2 = torch.zeros(c["k_s"].shape + (2,))[..., 0]
    assert not tfa.q8_cache_layout_ok(c["k"], c["v"], s2, s2)
