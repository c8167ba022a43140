"""Multi-LoRA banks in the port against the JAX package: one counterpart for
each test of ``tests/test_lora_bank_ckpt.py`` (``load_lora_bank`` from
trainable checkpoints, the bank it serves with, its errors), plus
``stack_lora_bank``, ``_proj``, ``decoder_forward`` and ``decode_step``
with per-sample ``lora_ids`` against JAX's at 1e-5 (tiny decoder, f32,
weights bridged from JAX's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.inference import serving as jserving
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask, make_prefill_mask
from icl_speech_text_llm_tpu.training import checkpoint as jckpt
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.inference import serving as tserving
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.training.checkpoint import load_lora_bank, save_checkpoint

torch.set_num_threads(1)
LCFG = jllama.LoraConfig(rank=4, targets=("wq", "wv"))
ALL_TARGETS = jllama.LoraConfig(rank=4, targets=("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                 "w_down"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adapter(cfg, lcfg, seed):
    a = jllama.init_lora(jax.random.PRNGKey(seed), cfg, lcfg)
    return _np(jax.tree_util.tree_map(lambda x, _s=seed: x + 0.02 * (_s + 1), a))


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    jparams = jllama.init_decoder(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, params_from_numpy(_np(jparams), device="cpu")


def _save_bank(tmp_path, adapters):
    dirs = []
    for i, a in enumerate(adapters):
        d = str(tmp_path / f"task{i}")
        save_checkpoint(d, {"lora": params_from_numpy(a, device="cpu")}, step=i)
        dirs.append(d)
    return dirs


def test_load_lora_bank_roundtrip(tmp_path):
    """Three adapters saved by the port: the port's bank is JAX's stack of
    them, and JAX's ``load_lora_bank`` reads the same dirs to the same
    bank."""
    cfg = jllama.DECODER_CONFIGS["tiny"]
    adapters = [_adapter(cfg, LCFG, s) for s in (1, 2, 3)]
    dirs = _save_bank(tmp_path, adapters)
    bank = load_lora_bank(dirs)
    want = _np(jllama.stack_lora_bank([jax.tree_util.tree_map(jnp.asarray, a)
                                        for a in adapters]))
    jbank = _np(jckpt.load_lora_bank(dirs))
    for name in want:
        for leaf in ("a", "b"):
            assert bank[name][leaf].shape == (cfg.n_layers, 3) + want[name][leaf].shape[2:]
            np.testing.assert_array_equal(bank[name][leaf].numpy(), want[name][leaf])
            np.testing.assert_array_equal(jbank[name][leaf], want[name][leaf])


def test_load_lora_bank_serves(tmp_path, tiny):
    """A bank loaded from disk serves the same tokens as the in-memory
    ``stack_lora_bank`` bank and as JAX's engine over JAX's bank."""
    cfg, jparams, tparams = tiny
    adapters = [_adapter(cfg, LCFG, s) for s in (5, 6)]
    dirs = _save_bank(tmp_path, adapters)
    rng = np.random.RandomState(3)
    reqs = [(rng.randn(10, cfg.dim).astype(np.float32) * 0.3, 10) for _ in range(3)]

    def run(mod, params, lora, **kw):
        scfg = mod.ServingConfig(num_slots=2, max_new_tokens=5, prompt_buckets=(32,),
                                 eos_token_id=2, admit_batch=2)
        eng = mod.ContinuousBatchingEngine(cfg if mod is jserving else tllama.DECODER_CONFIGS[
            "tiny"], params, scfg, lora=lora, lora_scaling=LCFG.scaling, **kw)
        rids = [eng.submit(emb, length, adapter_id=i % 2) for i, (emb, length) in enumerate(reqs)]
        res = eng.run()
        return [res[r] for r in rids]

    from_disk = run(tserving, tparams, load_lora_bank(dirs), device="cpu")
    in_memory = run(tserving, tparams, tllama.stack_lora_bank(
        [params_from_numpy(a, device="cpu") for a in adapters]), device="cpu")
    want = run(jserving, jparams, jllama.stack_lora_bank(
        [jax.tree_util.tree_map(jnp.asarray, a) for a in adapters]))
    assert from_disk == in_memory == want


def test_load_lora_bank_errors(tmp_path):
    with pytest.raises(ValueError):
        load_lora_bank([])
    d = str(tmp_path / "nolora")
    save_checkpoint(d, {"qformer": {"w": torch.zeros((2, 2))}})
    with pytest.raises(KeyError):
        load_lora_bank([d])
    with pytest.raises(ValueError):
        tllama.stack_lora_bank([])


def _bank(cfg, lcfg, seeds):
    return jllama.stack_lora_bank([jax.tree_util.tree_map(jnp.asarray, _adapter(cfg, lcfg, s))
                                   for s in seeds])


@pytest.mark.parametrize("name", ["wq", "wo", "w_down"])
def test_proj_with_lora_ids_matches_jax(tiny, name):
    cfg, jparams, tparams = tiny
    bank = _bank(cfg, ALL_TARGETS, (1, 2, 3))
    ids = np.array([2, 0, 2, 1], np.int32)
    layer = jax.tree_util.tree_map(lambda x: x[1], bank)
    d_in = layer[name]["a"].shape[1]
    x = np.random.RandomState(5).randn(4, 3, d_in).astype(np.float32)
    group = "attn" if name in ("wq", "wk", "wv", "wo") else "mlp"
    w = np.asarray(jparams["layers"][group][name][1])
    want = jllama._proj(jnp.asarray(x), jnp.asarray(w), layer, name, 2.0,
                        lora_ids=jnp.asarray(ids))
    got = tllama._proj(torch.from_numpy(x), torch.from_numpy(w.copy()),
                       params_from_numpy(_np(layer), device="cpu"), name, 2.0,
                       lora_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_decoder_forward_and_decode_step_with_lora_ids_match_jax(tiny):
    """The prefill (K1's plain version in the port, JAX's masked attention)
    and one decode step with a bank on every target, each sample its own
    adapter: hidden states and the cache within 1e-5."""
    cfg, jparams, tparams = tiny
    bank = _bank(cfg, ALL_TARGETS, (4, 5))
    tbank = params_from_numpy(_np(bank), device="cpu")
    assert tbank["w_up"]["a"].shape == (cfg.n_layers, 2, cfg.dim, 4)
    ids = np.array([1, 0, 1], np.int32)
    lengths = np.array([11, 16, 5], np.int32)
    B, T, S = 3, 16, 32
    x = (np.random.RandomState(6).randn(B, T, cfg.dim) * 0.3).astype(np.float32)
    jcache = jllama.init_kv_cache(cfg, B, T, dtype=jnp.float32)
    want_h, jcache = jllama.decoder_forward(
        cfg, jparams, jnp.asarray(x), make_prefill_mask(jnp.asarray(lengths), T),
        jnp.broadcast_to(jnp.arange(T), (B, T)), cache=jcache, lora=bank, lora_scaling=2.0,
        lora_ids=jnp.asarray(ids), use_flash_decode="xla")
    tcache = tllama.init_kv_cache(tllama.DECODER_CONFIGS["tiny"], B, T, dtype=torch.float32,
                                  device="cpu")
    tcfg = tllama.DECODER_CONFIGS["tiny"]
    got_h, tcache = tllama.decoder_forward(
        tcfg, tparams, torch.from_numpy(x), torch.from_numpy(lengths), cache=tcache, lora=tbank,
        lora_scaling=2.0, lora_ids=torch.from_numpy(ids))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got_h[b, :n].numpy(), np.asarray(want_h)[b, :n],
                                   atol=1e-5, rtol=1e-5)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k][:, b, :, :n].numpy(),
                                       np.asarray(jcache[k])[:, b, :, :n], atol=1e-5, rtol=1e-5)
    # one decode step at each sample's length, the caches padded to S
    pad = [(0, 0)] * 3 + [(0, S - T), (0, 0)]
    jcache = {k: jnp.pad(v, pad) for k, v in jcache.items()}
    tcache = {k: torch.nn.functional.pad(v, (0, 0, 0, S - T)) for k, v in tcache.items()}
    step = (np.random.RandomState(7).randn(B, 1, cfg.dim) * 0.3).astype(np.float32)
    want_h, jcache = jllama.decoder_forward(
        cfg, jparams, jnp.asarray(step), make_decode_mask(jnp.asarray(lengths) + 1, S),
        jnp.asarray(lengths)[:, None], cache=jcache, cache_positions=jnp.asarray(lengths),
        lora=bank, lora_scaling=2.0, lora_ids=jnp.asarray(ids), use_flash_decode="xla")
    got_h, tcache = tllama.decode_step(tcfg, tparams, torch.from_numpy(step), tcache,
                                       torch.from_numpy(lengths), tbank, 2.0,
                                       lora_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    for b, n in enumerate(lengths):
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k][:, b, :, :n + 1].numpy(),
                                       np.asarray(jcache[k])[:, b, :, :n + 1],
                                       atol=1e-5, rtol=1e-5)
