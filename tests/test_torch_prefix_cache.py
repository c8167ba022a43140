"""Prefix-cached serving and the prefill over an existing cache, in the
port against the JAX package: one counterpart for each test of
``tests/test_prefix_cache.py``, plus ``make_chunk_mask`` and
``decoder_forward(cache_positions=)`` against JAX's ``decoder_forward``
with ``make_chunk_mask``.

A prefix is registered once (prefilled through K1 in the port) and its KV
copied into each admitted slot; requests prefill only their suffix, over
that KV, with the plain masked attention in both packages. Tokens must be
identical to the JAX engine's on the same requests (tiny decoder, f32, the
port's weights bridged from JAX's). Under the int8 pool the JAX
registration runs its Pallas flash prefill in interpret mode (its serving
flash gate opened for 128-multiple buckets), as the port's does through K1:
both attend the unquantized current k/v there, and the suffix attends the
dequantized cache.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.inference import serving as jserving
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.ops.attention import make_chunk_mask as jmake_chunk_mask
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.inference import serving as tserving
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.ops.attention import make_chunk_mask

torch.set_num_threads(1)
EOS = 2
MAX_NEW = 6
_JAX = {}


@pytest.fixture
def jax_serving_flash(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jserving, "_flash_prefill_ok", lambda use_flash, L, cfg: L % 128 == 0)


@pytest.fixture(scope="module")
def llm():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    jparams = jllama.init_decoder(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return {"jax": (jserving, cfg, jparams),
            "torch": (tserving, tllama.DECODER_CONFIGS["tiny"], tparams)}


def _full_prompts(dim, n, prefix_len, rng_seed=11):
    rng = np.random.RandomState(rng_seed)
    prefix = (rng.randn(prefix_len, dim) * 0.3).astype(np.float32)
    suffixes = [((rng.randn(l, dim) * 0.3).astype(np.float32), l)
                for l in rng.randint(4, 15, size=n)]
    return prefix, suffixes


def _engine(world, **scfg_kw):
    mod, cfg, params = world
    kw = {"device": "cpu"} if mod is tserving else {}
    scfg = dict(num_slots=2, max_new_tokens=MAX_NEW, eos_token_id=EOS, admit_batch=2)
    return mod.ContinuousBatchingEngine(cfg, params, mod.ServingConfig(**dict(scfg, **scfg_kw)),
                                        **kw)


def _both(llm, name, scenario):
    if name not in _JAX:
        _JAX[name] = scenario(llm["jax"])
    return scenario(llm["torch"]), _JAX[name]


def _baseline(prefix, suffixes, **kw):
    """The requests as full concatenations through a no-prefix engine."""
    def scenario(world):
        eng = _engine(world, prompt_buckets=(64,), **kw)
        rids = [eng.submit(np.concatenate([prefix, suf]), len(prefix) + l)
                for suf, l in suffixes]
        res = eng.run()
        return [res[r] for r in rids]
    return scenario


def _with_prefix(prefix, suffixes, **kw):
    def scenario(world):
        eng = _engine(world, **kw)
        pid = eng.register_prefix(prefix, len(prefix))
        rids = [eng.submit(suf, l, prefix_id=pid) for suf, l in suffixes]
        res = eng.run()
        return [res[r] for r in rids], eng.stats["prefill_waves"]
    return scenario


def test_prefix_cache_token_parity(llm):
    prefix, suffixes = _full_prompts(128, 5, prefix_len=20)
    (got, waves), (want, jwaves) = _both(llm, "parity", _with_prefix(
        prefix, suffixes, prompt_buckets=(16,), prefix_buckets=(32,)))
    assert got == want and waves == jwaves == {(16, 2, 32): 3}
    # and the same as the full prompts through the port's plain admission
    base, _ = _both(llm, "parity_base", _baseline(prefix, suffixes))
    assert got == base


def test_mixed_prefix_and_plain_requests(llm):
    """Prefix and plain requests through one engine; two prefixes share a
    wave (stacked per row)."""
    prefix_a, suffixes = _full_prompts(128, 4, prefix_len=20, rng_seed=5)
    prefix_b = (np.random.RandomState(6).randn(28, 128) * 0.3).astype(np.float32)
    plan = [(prefix_a, 0), (prefix_b, 1), (None, 2), (prefix_a, 3)]

    def scenario(world):
        eng = _engine(world, prompt_buckets=(16,), prefix_buckets=(32,))
        pids = {id(prefix_a): eng.register_prefix(prefix_a, len(prefix_a)),
                id(prefix_b): eng.register_prefix(prefix_b, len(prefix_b))}
        rids = []
        for pfx, i in plan:
            suf, l = suffixes[i]
            rids.append(eng.submit(suf, l, prefix_id=None if pfx is None else pids[id(pfx)]))
        res = eng.run()
        return [res[r] for r in rids], eng.stats["prefill_waves"]

    (got, waves), (want, jwaves) = _both(llm, "mixed", scenario)
    assert got == want and waves == jwaves
    full = [(np.concatenate([p, suffixes[i][0]]) if p is not None else suffixes[i][0])
            for p, i in plan]
    base, _ = _both(llm, "mixed_base", _baseline(np.zeros((0, 128), np.float32),
                                                 [(f, len(f)) for f in full]))
    assert got == base


def test_prefix_cache_int8_kv(llm, jax_serving_flash):
    prefix, suffixes = _full_prompts(128, 3, prefix_len=20, rng_seed=9)
    (got, waves), (want, jwaves) = _both(llm, "int8", _with_prefix(
        prefix, suffixes, prompt_buckets=(128,), prefix_buckets=(128,), kv_int8=True))
    assert got == want and waves == jwaves


def test_prefix_cache_validation(llm):
    for world in (llm["torch"], llm["jax"]):
        eng = _engine(world, prompt_buckets=(16,))
        with pytest.raises(ValueError):  # no prefix_buckets configured
            eng.register_prefix(np.zeros((8, 128), np.float32), 8)
        with pytest.raises(ValueError):  # unknown prefix id
            eng.submit(np.zeros((4, 128), np.float32), 4, prefix_id=0)
        eng = _engine(world, prompt_buckets=(16,), prefix_buckets=(32,))
        with pytest.raises(ValueError):  # longer than every prefix bucket
            eng.register_prefix(np.zeros((64, 128), np.float32), 64)
        pid = eng.register_prefix(np.zeros((8, 128), np.float32), 8)
        with pytest.raises(ValueError):  # the beam lane has no prefix path
            eng.submit(np.zeros((4, 128), np.float32), 4, prefix_id=pid, num_beams=2)


@pytest.mark.parametrize("kw", [dict(prompt_buckets=(128,), prefix_buckets=(512,)),
                                dict(prompt_buckets=(256, 1024), max_new_tokens=10),
                                dict(prompt_buckets=(100,), prefix_buckets=(30, 300),
                                     max_new_tokens=3)])
def test_cache_len_covers_prefix(kw):
    got, want = tserving.ServingConfig(**kw), jserving.ServingConfig(**kw)
    assert got.cache_len == want.cache_len
    assert got.cache_len % 128 == 0
    assert got.cache_len >= max(got.prompt_buckets) + max(got.prefix_buckets or (0,)) \
        + got.max_new_tokens


def test_prefix_cache_with_chunked_prefill(llm):
    prefix, suffixes = _full_prompts(128, 4, prefix_len=20, rng_seed=13)
    (got, _), (want, _) = _both(llm, "chunked", _with_prefix(
        prefix, suffixes, prompt_buckets=(16,), prefix_buckets=(32,), chunk_len=8))
    assert got == want
    base, _ = _both(llm, "chunked_base", _baseline(prefix, suffixes))
    assert got == base


def test_make_chunk_mask_matches_jax():
    starts = np.array([0, 3, 17, 30], np.int32)
    got = make_chunk_mask(torch.from_numpy(starts), 5, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmake_chunk_mask(jnp.asarray(starts),
                                                                           5, 40)))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cache_prefill_matches_jax_decoder_forward(llm, quant):
    """``decoder_forward(cache_positions=)`` against JAX's decoder_forward
    with ``make_chunk_mask``: ragged starts over a cache already holding
    rows, a LoRA adapter on wq/wv; the hidden states and the cache within
    1e-5 (int8 bytes within ±1 and the same almost everywhere)."""
    _, jcfg, jparams = llm["jax"]
    _, tcfg, tparams = llm["torch"]
    lcfg = jllama.LoraConfig(rank=4, targets=("wq", "wv"))
    lora = jax.tree_util.tree_map(np.asarray, jllama.init_lora(jax.random.PRNGKey(3), jcfg,
                                                               lcfg))
    rng = np.random.RandomState(4)
    for name in lora:
        lora[name]["b"] = (rng.randn(*lora[name]["b"].shape) * 0.05).astype(np.float32)
    B, T, S = 3, 8, 48
    starts = np.array([3, 0, 17], np.int32)
    x = (rng.randn(B, T, jcfg.dim) * 0.3).astype(np.float32)
    shape = (jcfg.n_layers, B, jcfg.n_kv_heads, S, jcfg.hd)
    if quant:
        cache = {"k": rng.randint(-127, 128, shape).astype(np.int8),
                 "v": rng.randint(-127, 128, shape).astype(np.int8),
                 "k_s": rng.uniform(1e-3, 1e-2, shape[:-1]).astype(np.float32),
                 "v_s": rng.uniform(1e-3, 1e-2, shape[:-1]).astype(np.float32)}
    else:
        cache = {"k": rng.randn(*shape).astype(np.float32),
                 "v": rng.randn(*shape).astype(np.float32)}
    positions = starts[:, None] + np.arange(T)[None]
    want_h, want_c = jllama.decoder_forward(
        jcfg, jparams, jnp.asarray(x), jmake_chunk_mask(jnp.asarray(starts), T, S),
        jnp.asarray(positions), cache={k: jnp.asarray(v) for k, v in cache.items()},
        cache_positions=jnp.asarray(starts), lora=jax.tree_util.tree_map(jnp.asarray, lora),
        lora_scaling=lcfg.scaling)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got_h, got_c = tllama.decoder_forward(
        tcfg, tparams, torch.from_numpy(x), None, cache=tcache,
        lora=params_from_numpy(lora, device="cpu"), lora_scaling=lcfg.scaling,
        cache_positions=torch.from_numpy(starts))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    for k in cache:
        got, want = got_c[k].numpy(), np.asarray(want_c[k])
        if got.dtype == np.int8:
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (k, d.max(), (d > 0).mean())
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=k)
    # rows outside [starts[b], starts[b] + T) are untouched
    written = (np.arange(S)[None] >= starts[:, None]) & (np.arange(S)[None] < starts[:, None] + T)
    for k in cache:
        for b in range(B):
            np.testing.assert_array_equal(got_c[k].numpy()[:, b][:, :, ~written[b]],
                                          cache[k][:, b][:, :, ~written[b]])
