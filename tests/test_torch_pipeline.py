"""Pipeline parallelism (``parallel/pipeline.py``, the GPipe schedule) on gloo
ranks on the CPU, against the JAX package UNSHARDED: the port's counterpart
of ``tests/test_pipeline.py``.

- ``pipeline_decoder_forward`` at JAX's shapes (B 4, T 16, 2 microbatches,
  the tiny decoder at 4 layers) on a (dp=2, pp=4) mesh, JAX's own, each
  dp coordinate's 2 rows a pipeline of 4 stages: the hidden without LoRA,
  with LoRA (B non-zero) and with LoRA under remat against JAX's
  ``decoder_forward``; the gradients of Σ hidden · w with respect to the
  input (on stage 0 alone) and every LoRA leaf (on the stage holding its
  layers alone), without and with remat; the layer and batch guards; the
  point-to-point transfers each stage makes; pp = 1 in one process.
- One SALMONN train step on (dp=2, fsdp=2, pp=2), JAX's train-step mesh,
  against JAX's plain step on the same 8-row batch: the loss within 1e-4
  relative, the step's loss, grad norm, gradients and every updated
  trainable leaf within ``chip_smoke.DP_LIMITS``, equal on every rank.
- The train CLI at ``--mesh 1,1,1,2`` with the default ``--pp_microbatches``:
  its gathered checkpoint reloads in one process with the loss the
  pipeline gives its weights.

Both spawns are ``chip_smoke.py --dp_worker … MESH TASKS`` (one process a
rank, ``torch.set_num_threads(1)``) on salmonn-tiny's JAX-initialised
weights carried across by ``bridge.py``, LoRA B drawn non-zero.
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
from icl_speech_text_llm_tpu.ops.attention import make_prefill_mask
from icl_speech_text_llm_tpu.training import step as jstep
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.models import factory as tmodels
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.parallel import make_mesh, shutdown_distributed
from icl_speech_text_llm_tpu_torch.parallel.pipeline import pipeline_decoder_forward
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 120
B, T, N_MICRO = 4, 16, chip_smoke.PP_MICRO
DECODER = {"n_layers": 4}
LORA = jllama.LoraConfig(rank=4, alpha=8.0)
PIPE_MESH = (2, 1, 1, 4)
STEP_MESH = "2,2,1,2"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def decoder():
    """test_pipeline.py's decoder and inputs, LoRA B non-zero, and the
    weights w of the gradient check's Σ hidden · w."""
    cfg = dataclasses.replace(jllama.DECODER_CONFIGS["tiny"], **DECODER)
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    lora = _np(jllama.init_lora(jax.random.PRNGKey(2), cfg, LORA))
    rng = np.random.RandomState(3)
    for sub in lora.values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, T, cfg.dim))) * 0.1
    lengths = np.array([T, T - 3, T - 5, T], np.int32)
    w = np.cos(np.arange(B * T * cfg.dim, dtype=np.float32)).reshape(B, T, cfg.dim)
    return cfg, params, lora, x.astype(np.float32), lengths, w


@pytest.fixture(scope="module")
def jax_decoder(decoder):
    """JAX's plain ``decoder_forward``: the hidden without and with LoRA,
    and the gradients of Σ hidden · w with LoRA."""
    cfg, params, lora, x, lengths, w = decoder
    mask = make_prefill_mask(jnp.asarray(lengths), T)
    pos = jnp.broadcast_to(jnp.arange(T), (B, T))

    def fwd(x, lo):
        return jllama.decoder_forward(cfg, _jnp(params), x, mask, pos, lora=lo,
                                      lora_scaling=LORA.scaling)[0]

    plain = jllama.decoder_forward(cfg, _jnp(params), jnp.asarray(x), mask, pos)[0]
    gx, glo = jax.grad(lambda x, lo: jnp.sum(fwd(x, lo) * w), argnums=(0, 1))(
        jnp.asarray(x), _jnp(lora))
    return {"plain": np.asarray(plain), "lora": np.asarray(fwd(jnp.asarray(x), _jnp(lora))),
            "grad_x": np.asarray(gx), "grad_lora": chip_smoke._paths(_np(glo))}


def _batch8():
    """phase check's train batch (``chip_smoke._dp_batch``) as 8 rows whose
    (dp, fsdp) coordinates hold 2 rows each with different label counts."""
    b = chip_smoke._dp_batch(tsalmonn.salmonn_tiny())
    out = {k: np.concatenate([v, v[::-1], v, v[::-1]]) for k, v in b.items()}
    labels = out["shifted_labels"]
    labels[2, (labels[2] != -100).nonzero()[0][2:]] = -100
    labels[7, (labels[7] != -100).nonzero()[0][3:]] = -100
    return out


@pytest.fixture(scope="module")
def world():
    params = _np(jsalmonn.init_salmonn(jax.random.PRNGKey(0), jsalmonn.salmonn_tiny()))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    return params, _batch8()


@pytest.fixture(scope="module")
def jax_step(world):
    """JAX's unsharded loss and step (metrics, gradients, updated leaves)."""
    params, batch = world
    cfg = jsalmonn.salmonn_tiny()
    jp, jb = _jnp(params), {k: jnp.asarray(v) for k, v in batch.items()}
    loss = float(jsalmonn.salmonn_train_loss(cfg, jp, jb))
    opt = jstep.make_optimizer(jstep.OptimizerSettings(**chip_smoke.DP_OPT))
    state, frozen = jstep.init_train_state(jp, opt)
    grads = jax.grad(lambda tr: jsalmonn.salmonn_train_loss(
        cfg, jstep.merge_params(frozen, tr), jb))(state.trainable)
    state, metrics = jstep.make_train_step(cfg, opt)(state, frozen, jb)
    return {"loss": loss, "step_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "leaves": chip_smoke._paths(_np(state.trainable)),
            "grads": chip_smoke._paths(_np(grads))}


def _write(d, name, arrays=None, spec=None):
    if arrays is not None:
        np.savez(os.path.join(d, f"{name}.npz"), **arrays)
    if spec is not None:
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(spec, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, world, decoder):
    """Eight ranks: the decoder tasks on a (2, 1, 1, 4) mesh of their own,
    the train loss and step on (2, 2, 1, 2)."""
    params, batch = world
    _, dparams, lora, x, lengths, w = decoder
    d = str(tmp_path_factory.mktemp("pipeline"))
    arrays = {**{f"params.{k}": v for k, v in chip_smoke._paths(dparams).items()},
              **{f"lora.{k}": v for k, v in chip_smoke._paths(lora).items()},
              "x": x, "lengths": lengths, "w": w}
    _write(d, "pipe", arrays, {"mesh": PIPE_MESH, "cfg": DECODER, "scaling": LORA.scaling})
    return chip_smoke._dp_spawn(d, "file", params, batch, "cpu", world=8, timeout=TIMEOUT,
                                mesh=STEP_MESH, tasks=("pipeline", "loss", "step"))


def _stage_rows(ranks):
    """{dp coordinate's first row: [(stage, res, arrays), ...]} of the
    decoder task, and the rows a rank holds."""
    groups = {}
    for res, arrays in ranks:
        start, n = res["pipeline"]["rows"]
        groups.setdefault(start, []).append((res["pipeline"]["stage"], res, arrays))
    return groups, B // n


def test_forward_matches_jax_decoder_forward(ranks, jax_decoder):
    """Every stage returns the last stage's hidden: without LoRA, with it,
    with it under remat, each equal to JAX's plain forward on its rows."""
    groups, n = _stage_rows(ranks)
    assert sorted(groups) == [0, 1] and all(sorted(s for s, _, _ in g) == [0, 1, 2, 3]
                                            for g in groups.values())
    for start, group in groups.items():
        rows = slice(start * n, (start + 1) * n)
        for _, _, arrays in group:
            np.testing.assert_allclose(arrays["pipe.plain"], jax_decoder["plain"][rows],
                                       atol=1e-5)
            for name in ("lora", "remat"):
                np.testing.assert_allclose(arrays[f"pipe.{name}"], jax_decoder["lora"][rows],
                                           atol=1e-5)


@pytest.mark.parametrize("remat", ["plain", "remat"])
def test_gradients_match_jax(ranks, jax_decoder, remat):
    """The input's gradient lands on stage 0 alone and each LoRA leaf's on
    the stage holding its layers alone; summed over the ranks they are
    JAX's (test_pipeline.py's bound: 1e-4 of the leaf's max |g|)."""
    groups, n = _stage_rows(ranks)
    total = {}
    for start, group in groups.items():
        rows = slice(start * n, (start + 1) * n)
        for stage, _, arrays in group:
            gx = arrays[f"pipe.grad_{remat}.x"]
            if stage:
                assert not gx.any()
            else:
                want = jax_decoder["grad_x"][rows]
                assert np.abs(gx - want).max() <= 1e-4 * np.abs(want).max()
            per = DECODER["n_layers"] // PIPE_MESH[3]
            for k, g in chip_smoke._paths({"lora": _lora_grads(arrays, remat)}).items():
                mine = np.zeros(g.shape[0], bool)
                mine[stage * per:(stage + 1) * per] = True
                assert not g[~mine].any(), (k, stage)
                total[k] = total.get(k, 0) + g
    for k, want in jax_decoder["grad_lora"].items():
        err = np.abs(total[f"lora.{k}"] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


def _lora_grads(arrays, remat):
    prefix = f"pipe.grad_{remat}.lora."
    return chip_smoke._unpaths({k[len(prefix):]: v for k, v in arrays.items()
                                if k.startswith(prefix)})


def test_guards_and_transfers(ranks):
    """JAX's guards and messages (layers % pp, batch % n_micro); a stage
    sends and receives each microbatch once a direction and neighbour."""
    for res, _ in ranks:
        p = res["pipeline"]
        assert p["layer_guard"] == "6 layers not divisible by pp=4"
        assert p["batch_guard"] == f"batch 1 not divisible by n_micro={N_MICRO}"
        neighbours = 1 if p["stage"] in (0, PIPE_MESH[3] - 1) else 2
        assert p["p2p_forward"] == N_MICRO * neighbours
        assert p["p2p_step"] == 2 * N_MICRO * neighbours


def test_single_stage_degenerates_to_plain(decoder, jax_decoder):
    """pp = 1 in one process (a group of one): the microbatched loop is
    the plain forward."""
    cfg, params, lora, x, lengths, _ = decoder
    try:
        mesh = make_mesh(device="cpu")
        tparams = params_from_numpy(params, device="cpu")
        with torch.no_grad():
            for n_micro in (1, N_MICRO):
                out = pipeline_decoder_forward(mesh, cfg, tparams, torch.from_numpy(x),
                                               torch.from_numpy(lengths), n_micro)
                np.testing.assert_allclose(out.numpy(), jax_decoder["plain"], atol=1e-5)
    finally:
        shutdown_distributed()


def test_pipeline_loss_matches_jax_unsharded(ranks, jax_step):
    for res, _ in ranks:
        assert res["loss"]["loss"] == pytest.approx(jax_step["loss"], rel=1e-4)


def test_one_train_step_matches_jax_full_batch_step(ranks, jax_step):
    """JAX's train-step mesh (dp 2, fsdp 2, pp 2): loss, grad norm, the
    summed gradients (from AdamW's first moments) and the gathered updated
    leaves within the dp test's limits, equal on every rank; a label past
    the vocabulary on one (dp, fsdp) coordinate skips the step on every
    rank; each stage sends and receives each microbatch once a direction."""
    lim = chip_smoke.DP_LIMITS
    for res, arrays in ranks:
        s = res["step"]
        assert not s["skipped"]
        assert abs(s["loss"] - jax_step["step_loss"]) <= 1e-4 * abs(jax_step["step_loss"])
        want_norm = jax_step["grad_norm"]
        assert abs(s["grad_norm"] - want_norm) <= lim["grad_norm"] * want_norm
        leaves = {k[len("trainable."):]: v for k, v in arrays.items()
                  if k.startswith("trainable.")}
        grads = chip_smoke._dp_grads({k[len("mu."):]: v for k, v in arrays.items()
                                      if k.startswith("mu.")}, s["grad_norm"])
        assert set(leaves) == set(jax_step["leaves"]) == set(grads)
        for name, want in jax_step["leaves"].items():
            err = (np.abs(leaves[name] - want).max()
                   / chip_smoke._group_max(jax_step["leaves"], name))
            assert err <= lim["leaves"], (name, err)
        for name, want in jax_step["grads"].items():
            err = np.abs(grads[name] - want).max() / chip_smoke._group_max(jax_step["grads"], name)
            assert err <= lim["grads"], (name, err)
        for k, v in arrays.items():
            if k.startswith(("trainable.", "mu.")):
                np.testing.assert_array_equal(v, ranks[0][1][k])
        assert s["nan_skipped"] == 1.0 and s["kept_after_nan"] and not np.isfinite(s["nan_loss"])
        assert s["counts"]["p2p"] == 2 * N_MICRO


def test_train_cli_pipeline_checkpoint_reloads_in_one_process(tmp_path_factory, world):
    """``--mesh 1,1,1,2`` with the default ``--pp_microbatches`` (2): two
    steps, the same losses on both stages; rank 0 writes the leaves
    gathered over pp in the one-process format, and loaded into one
    process's model they give the loss the pipeline gives its weights."""
    _, batch = world
    batch = {k: v[:2] for k, v in batch.items()}
    d = str(tmp_path_factory.mktemp("ckpt_pp"))
    argv = ["--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "1",
            "--batch_size", "2", "--max_samples", "4", "--seq_len", "768", "--text_len", "384",
            "--val_max_samples", "2", "--device", "cpu", "--mesh", "1,1,1,2",
            "--output_dir", os.path.join(d, "out")]
    _write(d, "cli", spec={"argv": argv})
    ranks = chip_smoke._dp_spawn(d, "file", None, batch, "cpu", world=2, timeout=TIMEOUT,
                                 mesh="1,1,1,2", tasks=("train_cli",))
    res = [r["train_cli"] for r, _ in ranks]
    assert all(r["steps"] == 2 and not r["skipped"] for r in res)
    assert res[0]["losses"] == res[1]["losses"]
    (ckpt,) = res[0]["checkpoints"]
    assert not res[1]["checkpoints"]
    model = tmodels.create_model("salmonn-tiny", seed=42, device="cpu")
    trainable = tckpt.load_checkpoint(ckpt)["trainable"]
    assert trainable["lora"]["wq"]["a"].shape[0] == model.cfg.llm.n_layers
    params = tckpt.apply_trainable(model.params, params_from_numpy(trainable, device="cpu"))
    with torch.no_grad():
        loss = model.loss_fn(model.cfg, params,
                             {k: torch.as_tensor(v) for k, v in batch.items()}).item()
    for r in res:
        assert r["loss_after"] == pytest.approx(loss, rel=1e-4)
