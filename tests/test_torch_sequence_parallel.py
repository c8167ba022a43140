"""Ring attention and sequence parallelism (``parallel/ring_attention.py``,
``parallel/sequence_parallel.py``) on four gloo ranks on the CPU (tp = 4: a
ring of more than two hops), against the JAX package: the port's
counterpart of ``tests/test_ring_attention.py`` and
``tests/test_sequence_parallel.py``.

- ``ring_attention``, causal with per-sample lengths and full, with two
  query heads a KV head (the port rotates the un-repeated heads), against
  JAX's ``ring_attention`` on a tp = 4 mesh of the virtual CPU devices
  (given the repeated heads), within 1e-5;
- ``decoder_forward(ring=…)`` without and with remat, and
  ``sp_decoder_forward`` without LoRA and with LoRA (B non-zero) under
  remat, against JAX's plain ``decoder_forward`` on ragged lengths, within
  1e-5 on each sample's valid rows (JAX's tests' bound and region);
- the sequence-length guard, JAX's message;
- one SALMONN train step with the decoder sequence-parallel over tp
  against JAX's plain step: the loss within 1e-4 relative; the gradients
  (from AdamW's moments) within ``chip_smoke.DP_LIMITS`` and every updated
  trainable leaf within JAX's test's atol of 1e-4 or ``DP_LIMITS``, where
  that is looser; a label past the vocabulary skips the step everywhere.

One spawn of ``chip_smoke.py --dp_worker … 1,1,4 sp,sp_step`` (one process
a rank, ``torch.set_num_threads(1)``) on salmonn-tiny's JAX-initialised
weights carried across by ``bridge.py``.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.ops.attention import make_prefill_mask, repeat_kv
from icl_speech_text_llm_tpu.parallel.mesh import make_mesh
from icl_speech_text_llm_tpu.parallel.ring_attention import ring_attention
from icl_speech_text_llm_tpu.training import step as jstep
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120
TP = 4
B, T = 2, 32
DECODER = {"n_layers": 2}
LORA = jllama.LoraConfig(rank=4, alpha=8.0)
VALID = [T, T - 7]  # test_sequence_parallel.py's lengths


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    """The tiny decoder at 2 layers with a LoRA (B non-zero), x and ragged
    lengths (test_sequence_parallel.py's), and the ring's q, k, v (4 query
    heads on 2 KV heads, S = 64) and lengths (test_ring_attention.py's)."""
    cfg = dataclasses.replace(jllama.DECODER_CONFIGS["tiny"], **DECODER)
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    lora = _np(jllama.init_lora(jax.random.PRNGKey(2), cfg, LORA))
    rng = np.random.RandomState(3)
    for sub in lora.values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, T, cfg.dim)) * 0.1)
    q, k, v = (np.asarray(jax.random.normal(jax.random.PRNGKey(i), shape) * 0.5)
               for i, shape in ((0, (2, 4, 64, 16)), (1, (2, 2, 64, 16)), (2, (2, 2, 64, 16))))
    arrays = {**{f"params.{k}": v for k, v in chip_smoke._paths(params).items()},
              **{f"lora.{k}": v for k, v in chip_smoke._paths(lora).items()},
              "x": x, "lengths": np.array(VALID, np.int32), "q": q, "k": k, "v": v,
              "ring_lengths": np.array([64, 40], np.int32)}
    return cfg, params, lora, arrays


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """JAX's ring attention over tp = 4 devices and its plain decoder."""
    cfg, params, lora, a = inputs
    mesh = make_mesh(dp=1, fsdp=1, tp=TP, devices=jax.devices()[:TP])
    q, k, v = (jnp.asarray(a[n]) for n in ("q", "k", "v"))
    k, v = repeat_kv(k, 2), repeat_kv(v, 2)
    mask = make_prefill_mask(jnp.asarray(a["lengths"]), T)
    pos = jnp.broadcast_to(jnp.arange(T), (B, T))
    return {
        "ring_causal": np.asarray(ring_attention(q, k, v, mesh, "tp",
                                                 lengths=jnp.asarray(a["ring_lengths"]))),
        "ring_full": np.asarray(ring_attention(q, k, v, mesh, "tp", causal=False)),
        "plain": np.asarray(jllama.decoder_forward(cfg, _jnp(params), jnp.asarray(a["x"]),
                                                   mask, pos)[0]),
        "lora": np.asarray(jllama.decoder_forward(cfg, _jnp(params), jnp.asarray(a["x"]),
                                                  mask, pos, lora=_jnp(lora),
                                                  lora_scaling=LORA.scaling)[0]),
    }


@pytest.fixture(scope="module")
def world():
    params = _np(jsalmonn.init_salmonn(jax.random.PRNGKey(0), jsalmonn.salmonn_tiny()))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    return params, chip_smoke._dp_batch(tsalmonn.salmonn_tiny())


@pytest.fixture(scope="module")
def jax_step(world):
    params, batch = world
    cfg = jsalmonn.salmonn_tiny()
    jp, jb = _jnp(params), {k: jnp.asarray(v) for k, v in batch.items()}
    opt = jstep.make_optimizer(jstep.OptimizerSettings(**chip_smoke.DP_OPT))
    state, frozen = jstep.init_train_state(jp, opt)
    grads = jax.grad(lambda tr: jsalmonn.salmonn_train_loss(
        cfg, jstep.merge_params(frozen, tr), jb))(state.trainable)
    state, metrics = jstep.make_train_step(cfg, opt)(state, frozen, jb)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "leaves": chip_smoke._paths(_np(state.trainable)),
            "grads": chip_smoke._paths(_np(grads))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, world, inputs):
    params, batch = world
    d = str(tmp_path_factory.mktemp("sp"))
    np.savez(os.path.join(d, "sp.npz"), **inputs[3])
    with open(os.path.join(d, "sp.json"), "w") as f:
        json.dump({"cfg": DECODER, "scaling": LORA.scaling}, f)
    return chip_smoke._dp_spawn(d, "file", params, batch, "cpu", world=TP, timeout=TIMEOUT,
                                mesh=f"1,1,{TP}", tasks=("sp", "sp_step"))


@pytest.mark.parametrize("name", ["ring_causal", "ring_full"])
def test_ring_attention_matches_jax_ring(ranks, jax_ref, name):
    for _, arrays in ranks:
        np.testing.assert_allclose(arrays[f"sp.{name}"], jax_ref[name], atol=1e-5)


def _valid_rows(got, want):
    d = np.abs(got - want)
    for b, n in enumerate(VALID):
        assert d[b, :n].max() < 1e-5, (b, d[b, :n].max())


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_forward_with_ring_matches_plain(ranks, jax_ref, remat):
    for _, arrays in ranks:
        _valid_rows(arrays[f"sp.dec_ring_{remat}"], jax_ref["plain"])


@pytest.mark.parametrize("name, ref", [("sp_plain", "plain"), ("sp_lora_remat", "lora")])
def test_sp_decoder_forward_matches_plain(ranks, jax_ref, name, ref):
    """Every rank its slice, gathered whole on each."""
    for _, arrays in ranks:
        _valid_rows(arrays[f"sp.{name}"], jax_ref[ref])


def test_sp_seq_divisibility_guard(ranks):
    for res, _ in ranks:
        assert res["sp"]["guard"] == f"seq len {T - 2} not divisible by tp={TP}"


def test_train_step_with_sp_matches_plain(ranks, jax_step):
    lim = chip_smoke.DP_LIMITS
    for res, arrays in ranks:
        s = res["sp_step"]
        assert not s["skipped"]
        assert abs(s["loss"] - jax_step["loss"]) <= 1e-4 * abs(jax_step["loss"])
        want_norm = jax_step["grad_norm"]
        assert abs(s["grad_norm"] - want_norm) <= lim["grad_norm"] * want_norm
        leaves = {k[len("trainable."):]: v for k, v in arrays.items()
                  if k.startswith("trainable.")}
        grads = chip_smoke._dp_grads({k[len("mu."):]: v for k, v in arrays.items()
                                      if k.startswith("mu.")}, s["grad_norm"])
        assert set(leaves) == set(jax_step["leaves"]) == set(grads)
        for name, want in jax_step["leaves"].items():
            tol = max(1e-4, lim["leaves"] * chip_smoke._group_max(jax_step["leaves"], name))
            assert np.abs(leaves[name] - want).max() <= tol, name
        for name, want in jax_step["grads"].items():
            err = np.abs(grads[name] - want).max() / chip_smoke._group_max(jax_step["grads"], name)
            assert err <= lim["grads"], (name, err)
        for k, v in arrays.items():
            if k.startswith(("trainable.", "mu.")):
                np.testing.assert_array_equal(v, ranks[0][1][k])
        assert s["nan_skipped"] == 1.0 and s["kept_after_nan"] and not np.isfinite(s["nan_loss"])
