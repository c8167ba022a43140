"""K4 and K4 q8, the decode step's KV append, on the CPU: the plain version
of the quantizing append against the JAX package's ``quantize_kv`` and its
per-sample ``dynamic_update_slice`` of rows and scales (the decode step's
int8-cache write, JAX ``models/llama.py`` after the decode scan), and the
decode step that calls it against the route it replaced.

Same inputs (numpy, seeded) through both. Bounds: bit-identical bytes and
scales (one f32 division, one rounding, the same on both sides); the decode
step's hidden state within 1e-6 of the old route's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.ops import quant as jquant
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.models.common import layer_at, rms_norm
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa
from icl_speech_text_llm_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def _rows(L, B, Hkv, D, seed, scale=2.0):
    """New rows (L, B, Hkv, 1, D) with the cases the rounding must get right:
    an all-zero row (scale 0, bytes 0), and rows of exact .5 ties at scale 1
    (amax 127, entries ±0.5, ±1.5, ±2.5) and at scale 2 (amax 254, entries
    ±1, ±3, ±5), which round half to even."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(L, B, Hkv, 1, D) * scale).astype(np.float32)
    x[0, 0, 0, 0] = 0.0
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5], np.float32)
    x[-1, -1, 0, 0] = 0.0
    x[-1, -1, 0, 0, :6], x[-1, -1, 0, 0, 6] = ties, 127.0
    if Hkv > 1:
        x[0, -1, 1, 0] = 0.0
        x[0, -1, 1, 0, :6], x[0, -1, 1, 0, 6] = 2 * ties, -254.0
    return x


def _jax_append_q8(ck, cv, ks, vs, nk, nv, pos):
    """JAX's int8-cache write: quantize_kv of the new rows, then the
    per-sample dynamic_update_slice of rows and scales."""
    qk, sk = jquant.quantize_kv(jnp.asarray(nk))
    qv, sv = jquant.quantize_kv(jnp.asarray(nv))

    def dus(c, n, p):
        return jax.lax.dynamic_update_slice(c, n, (0, 0, p) + (0,) * (c.ndim - 3))

    vw = jax.vmap(dus, in_axes=(1, 1, 0), out_axes=1)
    p = jnp.asarray(pos)
    return [np.asarray(vw(jnp.asarray(c), n, p))
            for c, n in ((ck, qk), (cv, qv), (ks, sk), (vs, sv))]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_append_kv_q8_plain_is_bit_identical_to_jax_quantize_and_dus(D, dtype):
    """Positions 0 and S − 1 and one inside; f32 rows and bf16 rows (JAX
    quantizes the bf16 k/v of a bf16 decode the same way, after a cast to
    f32)."""
    L, B, Hkv, S = 3, 3, 2, 24
    nk, nv = _rows(L, B, Hkv, D, 1), _rows(L, B, Hkv, D, 2, scale=0.3)
    if dtype == "bf16":
        nk, nv = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                  for a in (nk, nv))
    rng = np.random.RandomState(3)
    ck, cv = (rng.randint(-127, 128, (L, B, Hkv, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.rand(L, B, Hkv, S).astype(np.float32) for _ in range(2))
    pos = np.array([0, S - 1, 7], np.int32)
    want = _jax_append_q8(ck, cv, ks, vs, nk, nv, pos)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = tfa.append_kv_q8(*map(torch.from_numpy, (ck, cv, ks, vs)),
                           torch.from_numpy(nk).to(tdt), torch.from_numpy(nv).to(tdt),
                           torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # the written rows: the tie rows round half to even, the zero row is 0
    q_tie = got[0][-1, -1, 0, pos[-1], :7].tolist()
    assert q_tie == [0, 0, 2, -2, 2, -2, 127] and got[2][-1, -1, 0, pos[-1]] == 1.0
    assert got[2][0, 0, 0, 0] == 0 and torch.all(got[0][0, 0, 0, 0] == 0)


def test_append_plain_versions_leave_positions_outside_the_cache_unwritten():
    """Positions −1 and S write nothing, as the kernels' rule; the other
    samples are written as usual (bf16 and int8 appends)."""
    L, B, Hkv, S, D = 2, 3, 2, 8, 16
    rng = np.random.RandomState(4)
    ck, cv = (torch.from_numpy(rng.randn(L, B, Hkv, S, D).astype(np.float32)) for _ in range(2))
    nk, nv = (torch.from_numpy(rng.randn(L, B, Hkv, 1, D).astype(np.float32)) for _ in range(2))
    pos = torch.tensor([-1, S, 3], dtype=torch.int32)
    before = ck.clone(), cv.clone()
    tfa.append_kv(ck, cv, nk, nv, pos)
    for c, c0, n in ((ck, before[0], nk), (cv, before[1], nv)):
        assert torch.equal(c[:, :2], c0[:, :2])
        assert torch.equal(c[:, 2, :, 3], n[:, 2, :, 0])
        assert torch.equal(c[:, 2, :, :3], c0[:, 2, :, :3])
    q8 = [torch.zeros((L, B, Hkv, S, D), dtype=torch.int8) for _ in range(2)]
    sc = [torch.full((L, B, Hkv, S), 7.0) for _ in range(2)]
    tfa.append_kv_q8(*q8, *sc, nk, nv, pos)
    qk, sk = tquant.quantize_kv(nk[:, 2, :, 0])
    assert torch.all(q8[0][:, :2] == 0) and torch.all(sc[0][:, :2] == 7.0)
    assert torch.equal(q8[0][:, 2, :, 3], qk) and torch.equal(sc[0][:, 2, :, 3], sk)


def _old_decode_step(cfg, params, x, cache, cache_positions):
    """The int8-cache decode step as it was before K4 q8: each layer's k and
    v quantized by ``quantize_kv`` into int8 staging rows, ONE ``append_kv``
    of the int8 rows after the loop, then each scale plane written by
    ``index_put_``."""
    B, L, hd = x.shape[0], cfg.n_layers, cfg.hd
    inv_freq = tllama._inv_freq(cfg, x.device)
    new_k = torch.empty((L, B, cfg.n_kv_heads, 1, hd), dtype=torch.int8)
    new_v = torch.empty_like(new_k)
    new_ks = torch.empty((L, B, cfg.n_kv_heads, 1))
    new_vs = torch.empty_like(new_ks)
    for l in range(L):
        layer = layer_at(params["layers"], l)
        q, k, v = tllama._qkv_heads(cfg, layer, None, 1.0, x, cache_positions[:, None], inv_freq)
        out = tllama._xla_decode_attn(cfg, q, cache["k"][l], cache["v"][l], k, v,
                                      cache_positions, cache["k_s"][l], cache["v_s"][l])
        new_k[l], new_ks[l] = tquant.quantize_kv(k)
        new_v[l], new_vs[l] = tquant.quantize_kv(v)
        x = tllama._attn_out_mlp(cfg, layer, None, 1.0, x,
                                 out.transpose(1, 2).reshape(B, 1, cfg.n_heads * hd))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    tfa.append_kv(cache["k"], cache["v"], new_k, new_v, cache_positions)
    b_idx, pos = torch.arange(B), cache_positions.long()
    for plane, new in ((cache["k_s"], new_ks), (cache["v_s"], new_vs)):
        plane.permute(1, 3, 0, 2).index_put_((b_idx, pos), new[..., 0].permute(1, 0, 2))
    return x, cache


def test_decode_step_on_an_int8_cache_writes_what_the_old_route_wrote(monkeypatch):
    """Two chained f32 decode steps on an int8 cache (salmonn-tiny's decoder,
    head_dim 32): the step's one ``append_kv_q8`` leaves the cache equal to
    the old route's (per-layer ``quantize_kv``, ``append_kv`` of int8 rows,
    ``index_put_`` of the scales), hidden states within 1e-6; the step
    itself calls ``quantize_kv`` no more."""
    cfg = tllama.DECODER_CONFIGS["tiny"]
    params = jax.tree_util.tree_map(np.asarray, jllama.init_decoder(jax.random.PRNGKey(2),
                                                                   jllama.DECODER_CONFIGS["tiny"]))
    tp = params_from_numpy(params, device="cpu", dtype=torch.float32)
    B, Sc = 2, 64
    rng = np.random.RandomState(5)
    new = tllama.init_kv_cache(cfg, B, Sc, quant=True, device="cpu")
    for name in ("k", "v"):
        q, s = tquant.quantize_kv(torch.from_numpy(
            rng.randn(*new[name].shape).astype(np.float32) * 0.5))
        new[name].copy_(q)
        new[name + "_s"].copy_(s)
    old = {n: t.clone() for n, t in new.items()}

    def refuse(*a, **kw):
        raise AssertionError("the decode step quantized its rows itself")

    monkeypatch.setattr(tllama, "quantize_kv", refuse)
    cur = torch.tensor([40, 17], dtype=torch.int32)
    for step in range(2):
        x = torch.from_numpy(rng.randn(B, 1, cfg.dim).astype(np.float32) * 0.5)
        x_new, new = tllama.decode_step(cfg, tp, x, new, cur)
        x_old, old = _old_decode_step(cfg, tp, x, old, cur)
        np.testing.assert_allclose(x_new.numpy(), x_old.numpy(), rtol=0, atol=1e-6)
        for name in new:
            assert torch.equal(new[name], old[name]), name
        cur = cur + 1
