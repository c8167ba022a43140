"""Tensor parallelism where tp does not divide a head count (the split-head
path of ``parallel/sharding.py:ShardContext.split_heads``) on gloo ranks on
the CPU, against the JAX package UNSHARDED.

GSPMD computes on the logical arrays, so the JAX package trains and
generates on such a mesh; the first test shows it on 4 of the 8 virtual
devices. The port's ranks gather their q/k/v column blocks into whole heads,
attend all of them, and cut the output back to their columns for wo.

- (1,1,4), one spawn of ``chip_smoke.py --dp_worker … MESH TASKS``:
  salmonn-tiny with Whisper and BEATs at 2 heads (16 of a head's 32
  columns a rank; the decoder's 2 KV heads split too, its 4 query heads
  not), passed to the worker as ``salmonn.json``: the train loss, one train
  step and its collective calls, greedy tokens, the XLA, FLASH and GENERIC
  decode routes of a 2/2-head decoder; Qwen2-Audio with qwen2-0.5b's
  decoder at 2 layers (14 heads over 2 KV heads), the tower whole: the
  loss, one step and its collective calls, greedy tokens.
- (1,1,4,2), pp = 2 × tp = 4 on 8 ranks: the variant's loss and step
  through the GPipe pipeline, each stage's layers on the split-head path.

Limits: the loss within 1e-4 relative (``test_parallel.py``); the step's
loss, grad norm, gradients and updated leaves within
``chip_smoke.DP_LIMITS``; tokens equal; the decode routes within 2e-4;
collective calls equal to ``chip_smoke.mesh_step_counts``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qwen_audio as jqwen
from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask
from icl_speech_text_llm_tpu.parallel import mesh as jmesh
from icl_speech_text_llm_tpu.parallel import sharding as jsharding
from icl_speech_text_llm_tpu.training import step as jstep
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.models.llama import DECODER_CONFIGS, SplitHeadConfig, _local_cfg
from icl_speech_text_llm_tpu_torch.parallel import sharding as tsharding

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from tests.test_torch_tensor_parallel import (  # noqa: E402
    _gen_batch,
    _jnp,
    _np,
    _train_batch4,
    _write,
)

torch.set_num_threads(1)
TIMEOUT = 150
GEN_KW = dict(max_new_tokens=5, eos_token_id=2, pad_token_id=0)
#: salmonn-tiny's encoders at 2 heads: tp = 4 cuts each head in two
VARIANT = {"whisper": {"n_heads": 2}, "beats": {"n_heads": 2}}
DECODE_CFG = dict(n_heads=2, n_kv_heads=2, head_dim=128)
#: qwen2_audio_smoke: qwen2-0.5b's decoder (14 heads, 2 KV heads) at 2 layers
QWEN = {"n_layers": 2, "tower": {}}
MESH, PIPE_MESH = "1,1,4", "1,1,4,2"


def _variant(family=jsalmonn):
    return chip_smoke._salmonn_variant(VARIANT, family)


def _qwen_gen(batch):
    """The Qwen train batch's prompts as a generation batch."""
    return {"text_tokens": batch["text_tokens"], "gather_idx": batch["gather_idx"],
            "seq_lengths": batch["seq_mask"].sum(axis=1).astype(np.int32),
            "wavs": batch["wavs"], "audio_lengths": batch["audio_lengths"]}


def _step_ref(cfg, params, batch, loss_fn):
    """JAX's unsharded loss and step: metrics, gradients, updated leaves."""
    jp, jb = _jnp(params), {k: jnp.asarray(v) for k, v in batch.items()}
    loss = float(loss_fn(cfg, jp, jb))
    opt = jstep.make_optimizer(jstep.OptimizerSettings(**chip_smoke.DP_OPT))
    state, frozen = jstep.init_train_state(jp, opt)
    grads = jax.grad(lambda tr: loss_fn(cfg, jstep.merge_params(frozen, tr), jb))(
        state.trainable)
    state, metrics = jstep.make_train_step(cfg, opt, loss_fn=loss_fn)(state, frozen, jb)
    return {"loss": loss, "step_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "leaves": chip_smoke._paths(_np(state.trainable)),
            "grads": chip_smoke._paths(_np(grads))}


@pytest.fixture(scope="module")
def world():
    params = _np(jsalmonn.init_salmonn(jax.random.PRNGKey(0), _variant()))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    return params, _train_batch4(), _gen_batch()


@pytest.fixture(scope="module")
def qwen_world():
    cfg = chip_smoke._qwen_mesh_cfg(QWEN, jqwen)
    params = _np(jqwen.init_qwen_audio(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(2)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    n_audio = int(jqwen.audio_output_length(5 * 16000))
    batch = chip_smoke._train_batch(cfg, n_audio, 512, clip_samples=5 * 16000)
    return cfg, params, batch


@pytest.fixture(scope="module")
def jax_ref(world, qwen_world):
    """The JAX package unsharded: the variant's and Qwen's loss, step and
    greedy tokens."""
    params, batch, gen = world
    cfg = _variant()
    ref = _step_ref(cfg, params, batch, jsalmonn.salmonn_train_loss)
    gcfg = jengine.GenerationConfig(**GEN_KW)
    ref["tokens"] = np.asarray(jengine.salmonn_generate(
        cfg, gcfg, _jnp(params), {k: jnp.asarray(v) for k, v in gen.items()}))
    qcfg, qparams, qbatch = qwen_world
    ref["qwen"] = _step_ref(qcfg, qparams, qbatch, jqwen.qwen_audio_train_loss)
    ref["qwen"]["tokens"] = np.asarray(jqwen.qwen_audio_generate(
        qcfg, gcfg, _jnp(qparams), {k: jnp.asarray(v) for k, v in _qwen_gen(qbatch).items()}))
    return ref


@pytest.fixture(scope="module")
def decode_inputs():
    cfg = dataclasses.replace(jllama.DECODER_CONFIGS["tiny"], **DECODE_CFG)
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 1, cfg.dim), jnp.float32))
    cur = np.array([100, 40], np.int32)
    S = 256
    want, _ = jllama.decoder_forward(
        cfg, _jnp(params), jnp.asarray(x), make_decode_mask(jnp.asarray(cur) + 1, S),
        jnp.asarray(cur)[:, None], cache=jllama.init_kv_cache(cfg, 2, S, dtype=jnp.float32),
        cache_positions=jnp.asarray(cur), use_flash_decode=False)
    arrays = {**{f"params.{k}": v for k, v in chip_smoke._paths(params).items()},
              "x": x, "cur_len": cur}
    return ("decode", arrays, {"cfg": DECODE_CFG, "S": S}), np.asarray(want)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory, world, qwen_world, decode_inputs):
    params, batch, gen = world
    _, qparams, qbatch = qwen_world
    d = str(tmp_path_factory.mktemp("tp4"))
    for args in (("salmonn", None, VARIANT), ("gen", gen, {"kw": GEN_KW}), decode_inputs[0],
                 ("qwen", chip_smoke._paths(qparams), QWEN), ("qbatch", qbatch),
                 ("qgen", _qwen_gen(qbatch))):
        _write(d, *args)
    return chip_smoke._dp_spawn(d, "file", params, batch, "cpu", world=4, timeout=TIMEOUT,
                                mesh=MESH, tasks=("loss", "step", "generate", "decode", "qwen",
                                                  "qwen_step", "qwen_generate"))


@pytest.fixture(scope="module")
def pp2_tp4(tmp_path_factory, world):
    params, batch, _ = world
    d = str(tmp_path_factory.mktemp("pp2tp4"))
    _write(d, "salmonn", None, VARIANT)
    return chip_smoke._dp_spawn(d, "file", params, batch, "cpu", world=8, timeout=TIMEOUT,
                                mesh=PIPE_MESH, tasks=("loss", "step"))


def test_jax_runs_the_split_heads_sharded(world, jax_ref):
    """The premise: JAX's jitted, tp = 4 sharded loss and generation on 4 of
    the 8 virtual devices equal its unsharded ones, though tp cuts every
    encoder head and the decoder's KV heads in two."""
    params, batch, gen = world
    cfg = _variant()
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=4, devices=jax.devices()[:4])
    sp = jsharding.shard_params(_jnp(params), mesh)
    loss = float(jax.jit(lambda p, b: jsalmonn.salmonn_train_loss(cfg, p, b))(
        sp, jsharding.shard_batch(batch, mesh)))
    assert loss == pytest.approx(jax_ref["loss"], rel=1e-6)
    gcfg = jengine.GenerationConfig(**GEN_KW)
    toks = jax.jit(lambda p, b: jengine.salmonn_generate(cfg, gcfg, p, b))(
        sp, jsharding.shard_batch(gen, mesh))
    np.testing.assert_array_equal(np.asarray(toks), jax_ref["tokens"])


@pytest.mark.parametrize("model", ["salmonn", "qwen"])
def test_the_layout_rule_picks_per_model(model):
    """Each model's layout from its config and the mesh: at tp = 4 the
    variant's Whisper and BEATs and both decoders split, at tp = 2 none
    does (2-head encoders, 4 over 2 and 14 over 2 heads)."""
    four = tsharding.ShardContext({"tp": 4}, {"tp": 1}, {})
    two = tsharding.ShardContext({"tp": 2}, {"tp": 1}, {})
    cfg = (_variant(tsalmonn).llm if model == "salmonn"
           else dataclasses.replace(DECODER_CONFIGS["qwen2-0.5b"], n_layers=2))
    for ctx, split in ((four, True), (two, False)):
        with tsharding.shard_context(ctx):
            local = _local_cfg(cfg)
        assert isinstance(local, SplitHeadConfig) == split
        assert (local.n_heads, local.n_kv_heads) == (
            (cfg.n_heads, cfg.n_kv_heads) if split else (cfg.n_heads // 2, cfg.n_kv_heads // 2))
    if model == "salmonn":
        enc = _variant(tsalmonn)
        assert four.split_heads(enc.whisper.n_heads) and four.split_heads(enc.beats.n_heads)
        assert not two.split_heads(enc.whisper.n_heads, enc.beats.n_heads)


def _check_step(s, arrays, want, first, label):
    """One rank's step (``arrays``: its ``trainable.*`` and ``mu.*``)
    against JAX's, its arrays equal to the ``first`` rank's."""
    lim = chip_smoke.DP_LIMITS
    assert not s["skipped"]
    assert abs(s["loss"] - want["step_loss"]) <= lim["loss"] * abs(want["step_loss"])
    assert abs(s["grad_norm"] - want["grad_norm"]) <= lim["grad_norm"] * want["grad_norm"]
    leaves = {k[len("trainable."):]: v for k, v in arrays.items() if k.startswith("trainable.")}
    grads = chip_smoke._dp_grads({k[len("mu."):]: v for k, v in arrays.items()
                                  if k.startswith("mu.")}, s["grad_norm"])
    assert set(leaves) == set(want["leaves"]) == set(grads)
    for name, w in want["leaves"].items():
        err = np.abs(leaves[name] - w).max() / chip_smoke._group_max(want["leaves"], name)
        assert err <= lim["leaves"], (label, name, err)
    for name, w in want["grads"].items():
        err = np.abs(grads[name] - w).max() / chip_smoke._group_max(want["grads"], name)
        assert err <= lim["grads"], (label, name, err)
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, first[k])
    assert s["nan_skipped"] == 1.0 and s["kept_after_nan"] and not np.isfinite(s["nan_loss"])


def _step_arrays(arrays, prefix=""):
    """A rank's ``{prefix}trainable.*`` and ``{prefix}mu.*``, unprefixed."""
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith((prefix + "trainable.", prefix + "mu."))}


@pytest.mark.parametrize("model", ["salmonn", "qwen"])
def test_split_head_loss_matches_jax_unsharded(tp4, jax_ref, model):
    want = jax_ref if model == "salmonn" else jax_ref["qwen"]
    for res, _ in tp4:
        assert res["loss" if model == "salmonn" else "qwen"]["loss"] == pytest.approx(
            want["loss"], rel=1e-4)


@pytest.mark.parametrize("model", ["salmonn", "qwen"])
def test_split_head_step_matches_jax_full_batch_step(tp4, jax_ref, model):
    """Loss, grad norm, the gradients (from AdamW's first moments) and the
    gathered updated leaves within the dp test's limits, equal on every
    rank; the NaN step skipped everywhere. A head straddling two ranks'
    blocks takes gradient from both: without the gather's reduce-scatter
    the LoRA gradients of wq/wv (wq/wk for Qwen) would miss half."""
    task, prefix = ("step", "") if model == "salmonn" else ("qwen_step", "qwen_step.")
    want = jax_ref if model == "salmonn" else jax_ref["qwen"]
    first = _step_arrays(tp4[0][1], prefix)
    for res, arrays in tp4:
        _check_step(res[task], _step_arrays(arrays, prefix), want, first, task)


@pytest.mark.parametrize("model", ["salmonn", "qwen"])
def test_split_head_collective_counts_equal_their_formula(tp4, model):
    """One all-gather a split layer (Whisper's 2, BEATs' 2, the decoder's 2)
    in the forward, one reduce-scatter a decoder layer in the backward, on
    top of the head-sharded path's counts."""
    cfg = _variant(tsalmonn) if model == "salmonn" else chip_smoke._qwen_mesh_cfg(QWEN)
    want = chip_smoke.mesh_step_counts(cfg, (1, 1, 4))
    n_split = (cfg.whisper.n_layers + cfg.beats.n_layers if model == "salmonn" else 0)
    assert want["all_gather"] == n_split + cfg.llm.n_layers
    assert want["reduce_scatter"] == cfg.llm.n_layers
    for res, _ in tp4:
        assert res["step" if model == "salmonn" else "qwen_step"]["counts"] == want


@pytest.mark.parametrize("model", ["salmonn", "qwen"])
def test_split_head_greedy_tokens_match_jax_unsharded(tp4, jax_ref, model):
    want = jax_ref["tokens"] if model == "salmonn" else jax_ref["qwen"]["tokens"]
    name = "generate" if model == "salmonn" else "qwen_generate"
    for res, arrays in tp4:
        np.testing.assert_array_equal(arrays[f"{name}.tokens"], want)


def test_split_head_decode_routes_match_jax_generic(tp4, decode_inputs):
    """Every rank's cache holds both KV heads; XLA, FLASH (JAX's gate sends
    split heads to the plain math) and GENERIC against JAX's
    ``use_flash_decode=False``."""
    want = decode_inputs[1]
    for res, arrays in tp4:
        assert res["decode"]["kv_heads"] == DECODE_CFG["n_kv_heads"]
        assert res["plain"]["flash_decode_attention_plain"] == 0
        for route in ("xla", "flash", "generic"):
            np.testing.assert_allclose(arrays[f"decode.{route}"], want, rtol=2e-4, atol=2e-4)


def test_pipeline_with_split_head_stages_matches_jax(pp2_tp4, jax_ref):
    """pp = 2 × tp = 4: each stage runs its layers through the same layer
    code (``_local_cfg``), on the split-head path; the loss and one step
    as JAX's unsharded."""
    assert sorted(res["ranks"]["pp"] for res, _ in pp2_tp4) == [0] * 4 + [1] * 4
    first = _step_arrays(pp2_tp4[0][1])
    for res, arrays in pp2_tp4:
        assert res["loss"]["loss"] == pytest.approx(jax_ref["loss"], rel=1e-4)
        _check_step(res["step"], _step_arrays(arrays), jax_ref, first, "pp2 tp4 step")
