"""The port's training path against the JAX package's, on the CPU at f32.

- ``salmonn_train_loss`` and its gradients on salmonn-tiny: the same
  JAX-initialised parameters (LoRA B drawn non-zero so the A gradients are
  non-zero too) and the same packed train batch through both. Loss within
  1e-5 relative; each gradient leaf within 1e-4 × the max |g| of its group
  (``lora.*.a``, ``lora.*.b``, ``qformer``), for every remat setting; the
  port's remat settings agree with each other within 1e-6 of that scale. The JAX reference runs without remat (remat
  changes what is stored, not the math).
- ``make_train_step`` against the JAX optax chain: clipping that fires,
  AdamW with a warmup schedule, accumulation and the non-finite no-op;
  trainable parameters within 1e-5 relative after every step.
- every ``--scheduler`` name against the JAX ``get_schedule``;
- the checkpoint layout the JAX ``load_checkpoint`` reads, and the CLI.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.training import checkpoint as jckpt
from icl_speech_text_llm_tpu.training import schedulers as jsched
from icl_speech_text_llm_tpu.training import step as jstep
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt
from icl_speech_text_llm_tpu_torch.training import schedulers as tsched
from icl_speech_text_llm_tpu_torch.training import step as tstep
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)
REMATS = [False, True, "dots", "1in2"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, prefix=""):
    """{'a.b.c': leaf} of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def world():
    """JAX-initialised salmonn-tiny params with LoRA B non-zero, and one
    packed train batch (2 requests, 1 speech exemplar each)."""
    cfg = jsalmonn.salmonn_tiny()
    params = _np_tree(jsalmonn.init_salmonn(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    ds = create_dataset(DatasetType.VOXCELEB, split=DatasetSplit.TRAIN, is_training=True,
                        input_mode="speech_only", fewshot_mode="speech", num_examples=1,
                        max_samples=2, synthetic=True, synthetic_size=4, seed=5)
    pack = PackConfig(seq_len=512, text_len=384, max_slots=2,
                      audio_tokens_per_slot=cfg.audio_tokens_per_slot)
    b = collate_icl_batch([ds[0], ds[1]], get_tokenizer(), pack)
    batch = {"text_tokens": b.text_tokens, "gather_idx": b.gather_idx, "seq_mask": b.seq_mask,
             "shifted_labels": b.labels_shifted, "wavs": b.audio["wavs"]}
    assert (b.labels_shifted != -100).sum() > 0
    return params, batch


@pytest.fixture(scope="module")
def jax_loss_and_grads(world):
    params, batch = world
    cfg = jsalmonn.salmonn_tiny()
    trainable, frozen = jstep.split_params(jax.tree_util.tree_map(jnp.asarray, params))

    def loss(tr, fr, b):
        return jsalmonn.salmonn_train_loss(cfg, jstep.merge_params(fr, tr), b)

    val, grads = jax.jit(jax.value_and_grad(loss))(
        trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(val), _paths(_np_tree(grads))


@pytest.fixture(scope="module")
def port_loss_and_grads(world):
    params, batch = world
    cfg = tsalmonn.salmonn_tiny()
    tparams = params_from_numpy(params, device="cpu")
    out = {}
    for remat in REMATS:
        trainable, frozen = tstep.split_params(tparams)
        trainable = tstep.tree_map(lambda t: t.clone().requires_grad_(), trainable)
        loss = tsalmonn.salmonn_train_loss(
            cfg, tstep.merge_params(frozen, trainable),
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, remat=remat)
        named = _paths(trainable)
        grads = torch.autograd.grad(loss, list(named.values()))
        out[remat] = (loss.item(), {k: g.numpy() for k, g in zip(named, grads)})
    return out


@pytest.mark.parametrize("remat", REMATS)
def test_train_loss_and_gradients_match_jax(remat, jax_loss_and_grads, port_loss_and_grads):
    want_loss, want = jax_loss_and_grads
    got_loss, got = port_loss_and_grads[remat]
    assert np.isfinite(got_loss)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss), (got_loss, want_loss)
    assert set(got) == set(want)
    for name in want:
        err = np.abs(got[name] - want[name]).max()
        assert err <= 1e-4 * _group_scale(want, name), (remat, name, err)
    assert all(np.abs(want[n]).max() > 0 for n in want if n.startswith("lora") and n.endswith(".a"))


def _group_scale(grads, name):
    """max |g| over the leaf's group (lora.*.a, lora.*.b or qformer): some
    leaves' gradients are zero up to rounding (a key bias shifts every score
    of a softmax row alike), so a leaf's own max is no scale for them."""
    group = ("lora", name[-1]) if name.startswith("lora") else ("qformer", "")
    scale = max(np.abs(g).max() for n, g in grads.items()
                if n.startswith(group[0]) and n.endswith(group[1]))
    assert scale > 0, name
    return scale


def test_remat_settings_agree_with_each_other(port_loss_and_grads):
    base_loss, base = port_loss_and_grads[False]
    for remat in REMATS[1:]:
        loss, grads = port_loss_and_grads[remat]
        assert abs(loss - base_loss) <= 1e-6 * abs(base_loss), remat
        for name in base:
            err = np.abs(grads[name] - base[name]).max()
            assert err <= 1e-6 * _group_scale(base, name), (remat, name, err)


def test_one_in_k_that_does_not_divide_degrades_to_full_remat(world, caplog):
    """salmonn-tiny has 2 LLM layers: '1in3' falls back to full remat with
    the JAX package's warning, and the loss is unchanged."""
    params, batch = world
    tparams = params_from_numpy(params, device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    cfg = tsalmonn.salmonn_tiny()
    with torch.no_grad():
        base = tsalmonn.salmonn_train_loss(cfg, tparams, tb).item()
        with caplog.at_level("WARNING"):
            got = tsalmonn.salmonn_train_loss(cfg, tparams, tb, remat="1in3").item()
    assert got == base
    assert "degraded to full per-layer remat" in caplog.text


def test_cross_entropy_matches_jax_including_masked_and_out_of_vocab_labels():
    """Mean over unmasked positions with denominator max(count, 1); an
    all-ignored batch gives 0; a label past the vocabulary gives NaN in both
    (JAX's fill-mode gather), so the train step skips such a batch."""
    from icl_speech_text_llm_tpu.models import llama as jllama
    from icl_speech_text_llm_tpu_torch.models import llama as tllama

    rng = np.random.RandomState(3)
    logits = rng.randn(2, 7, 11).astype(np.float32) * 3
    cases = [rng.randint(0, 11, (2, 7)), np.full((2, 7), -100), rng.randint(0, 11, (2, 7))]
    cases[0][0, :3] = -100
    cases[2][1, 4] = 11
    for labels in cases:
        want = float(jllama.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
        got = tllama.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item()
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert np.isnan(got) and tllama.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(cases[1])).item() == 0.0


def test_pipeline_and_sp_are_not_ported(world):
    """The pipeline and sequence-parallel decoders are ported (their
    parity with JAX is ``tests/test_torch_pipeline.py`` and
    ``tests/test_torch_sequence_parallel.py``, on gloo ranks); this pins,
    in one process (a group of one), JAX's batch guard and its message,
    the step's refusals of what JAX's step cannot mean, and that a
    pipeline of one stage and a sequence over one rank give the plain
    loss."""
    from icl_speech_text_llm_tpu_torch.parallel import make_mesh, shutdown_distributed

    params, batch = world
    cfg = tsalmonn.salmonn_tiny()
    tparams = params_from_numpy(params, device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    try:
        mesh = make_mesh(device="cpu")
        with torch.no_grad():
            with pytest.raises(ValueError, match="batch 2 not divisible by n_micro=3"):
                tsalmonn.salmonn_train_loss(cfg, tparams, tb, pipeline=(mesh, 3))
            plain = tsalmonn.salmonn_train_loss(cfg, tparams, tb).item()
            for kw in ({"pipeline": (mesh, 2)}, {"sp": (mesh, "tp")}):
                assert tsalmonn.salmonn_train_loss(cfg, tparams, tb, **kw).item() == \
                    pytest.approx(plain, rel=1e-6), kw
        opt = tstep.AdamW(tstep.OptimizerSettings())
        with pytest.raises(ValueError, match="pass one"):
            tstep.make_train_step(cfg, opt, pipeline=(mesh, 2), sp=(mesh, "tp"))
        with pytest.raises(ValueError, match="a batch axis splits the rows"):
            tstep.make_train_step(cfg, opt, sp=(mesh, "dp"))
    finally:
        shutdown_distributed()


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _targets(trainable, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*np.shape(v)) * 0.5).astype(np.float32)
            for k, v in _paths(trainable).items()}


def _jax_loss(cfg, params, batch, remat=False):
    leaves = _paths({k: params[k] for k in ("lora", "qformer")})
    return sum(jnp.sum(jnp.sin(leaves[k]) * batch[k]) for k in leaves)


def _port_loss(cfg, params, batch, remat=False):
    leaves = _paths({k: params[k] for k in ("lora", "qformer")})
    return sum(torch.sum(torch.sin(leaves[k]) * batch[k]) for k in leaves)


def _run_both(params, settings_kw, batches, loss_j=_jax_loss, loss_t=_port_loss):
    """Step the JAX and the port train steps over ``batches``; yield the two
    trainable trees (as {path: array}) and metrics after each step."""
    cfg = jsalmonn.salmonn_tiny()
    sched_kw = settings_kw.pop("warmup", None)
    jkw, tkw = dict(settings_kw), dict(settings_kw)
    if sched_kw is not None:
        jkw["schedule"] = jsched.get_schedule("linear", settings_kw["learning_rate"], sched_kw, 10)
        tkw["schedule"] = tsched.get_schedule("linear", settings_kw["learning_rate"], sched_kw, 10)
    jopt = jstep.make_optimizer(jstep.OptimizerSettings(**jkw))
    jstate, jfrozen = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jfn = jstep.make_train_step(cfg, jopt, loss_fn=loss_j)
    topt = tstep.AdamW(tstep.OptimizerSettings(**tkw))
    tstate, tfrozen = tstep.init_train_state(params_from_numpy(params, device="cpu"), topt)
    tfn = tstep.make_train_step(tsalmonn.salmonn_tiny(), topt, loss_fn=loss_t)
    for b in batches:
        jstate, jm = jfn(jstate, jfrozen, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tfn(tstate, tfrozen, {k: torch.from_numpy(v) for k, v in b.items()})
        yield (_paths(_np_tree(jstate.trainable)),
               {k: v.detach().numpy() for k, v in _paths(tstate.trainable).items()}, jm, tm)


def _assert_close(got, want, what):
    for name in want:
        err = np.abs(got[name] - want[name]).max()
        assert err <= 1e-5 * max(np.abs(want[name]).max(), 1e-30), (what, name, err)


def test_three_steps_with_clipping_match_optax(world):
    params, _ = world
    trainable, _ = jstep.split_params(params)
    batches = [_targets(trainable, s) for s in (10, 11, 12)]
    before = _paths(trainable)
    settings = dict(learning_rate=1e-3, max_grad_norm=0.01, warmup=1)
    for i, (want, got, jm, tm) in enumerate(_run_both(params, settings, batches)):
        assert float(jm["grad_norm"]) > 0.01  # clipping fires
        assert tm["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert tm["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5, abs=1e-6)
        assert tm["step"] == i and tm["skipped_nonfinite"] == 0.0
        _assert_close(got, want, f"step {i}")
        moved = max(np.abs(got[k] - before[k]).max() for k in before)
        # update 0 runs at lr 0 (warmup); the later ones move the weights
        assert (moved == 0.0) if i == 0 else (moved > 0.0), (i, moved)


def test_gradient_accumulation_matches_optax_multisteps(world):
    params, _ = world
    trainable, _ = jstep.split_params(params)
    batches = [_targets(trainable, s) for s in (20, 21, 22, 23)]
    before = _paths(trainable)
    settings = dict(learning_rate=1e-3, max_grad_norm=0.01, grad_accum_steps=2)
    for i, (want, got, _, _) in enumerate(_run_both(params, settings, batches)):
        _assert_close(got, want, f"micro-step {i}")
        moved = max(np.abs(got[k] - before[k]).max() for k in before)
        if i == 0:
            assert moved == 0.0  # the first micro-step only accumulates


def test_nonfinite_loss_is_noop_update(world):
    """A NaN loss leaves parameters, moments and the accumulation buffer
    untouched (the JAX package's non-finite guard)."""
    params, _ = world
    topt = tstep.AdamW(tstep.OptimizerSettings(learning_rate=1e-2, grad_accum_steps=2))
    state, frozen = tstep.init_train_state(params_from_numpy(params, device="cpu"), topt)

    def nan_loss(cfg, p, batch, remat=False):
        return tstep.tree_leaves(p["lora"])[0].sum() * float("nan")

    good = tstep.make_train_step(tsalmonn.salmonn_tiny(), topt, loss_fn=_port_loss)
    trainable, _ = jstep.split_params(params)
    state, _ = good(state, frozen, {k: torch.from_numpy(v)
                                    for k, v in _targets(trainable, 30).items()})
    snap = {k: v.detach().clone() for k, v in _paths(
        {"p": state.trainable, "o": {k: state.opt_state[k] for k in ("mu", "nu", "acc")}}).items()}
    counters = (state.opt_state["count"], state.opt_state["mini_step"])
    state, metrics = tstep.make_train_step(tsalmonn.salmonn_tiny(), topt, loss_fn=nan_loss)(
        state, frozen, {})
    assert metrics["skipped_nonfinite"] == 1.0 and state.step == 2
    after = _paths({"p": state.trainable,
                    "o": {k: state.opt_state[k] for k in ("mu", "nu", "acc")}})
    for k, v in snap.items():
        assert torch.equal(after[k], v), k
    assert (state.opt_state["count"], state.opt_state["mini_step"]) == counters


# ---------------------------------------------------------------------------
# Schedules, checkpoints, CLI
# ---------------------------------------------------------------------------

SCHEDULERS = ["linear", "cosine", "cosine_with_restarts", "polynomial", "constant",
              "constant_with_warmup", "inverse_sqrt", "per_epoch_warmup_restart"]


@pytest.mark.parametrize("name", SCHEDULERS)
def test_schedules_match_jax(name):
    """Same f32 arithmetic in the same order: bit-identical but for the
    last bit of cos, so the bound is 1e-7 relative to max(|lr|, base_lr)."""
    for base_lr, warmup, total, per_epoch in ((1e-3, 10, 100, 20), (3e-5, 0, 37, 7),
                                              (1e-5, 100, 40, 10)):
        want = jsched.get_schedule(name, base_lr, warmup, total, per_epoch)
        got = tsched.get_schedule(name, base_lr, warmup, total, per_epoch)
        for step in range(total + 3):
            w, g = float(want(step)), got(step)
            assert isinstance(g, float)
            assert abs(g - w) <= 1e-7 * max(abs(w), base_lr), (name, step, g, w)


def test_checkpoint_round_trip_and_jax_reads_it(world, tmp_path):
    params, _ = world
    topt = tstep.AdamW(tstep.OptimizerSettings())
    state, _ = tstep.init_train_state(params_from_numpy(params, device="cpu"), topt)
    path = tckpt.save_checkpoint(str(tmp_path / "epoch_0_loss_1.2345"), state.trainable,
                                 opt_state=state.opt_state, step=7, epoch=1, loss=1.2345,
                                 metadata={"note": "port"})
    mine = tckpt.load_checkpoint(path)
    theirs = jckpt.load_checkpoint(path)
    want = _paths(jstep.split_params(params)[0])
    for ck in (mine, theirs):
        assert ck["step"] == 7 and ck["meta"]["epoch"] == 1
        assert ck["meta"]["metadata"] == {"note": "port"}
        got = _paths(ck["trainable"])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert mine["opt_state"]["count"] == 0 and "mu" in mine["opt_state"]
    # resume: copy the saved tree back into live tensors
    fresh, _ = tstep.init_train_state(params_from_numpy(params, device="cpu"), topt)
    with torch.no_grad():
        for t in tstep.tree_leaves(fresh.trainable):
            t.zero_()
    tckpt.copy_into(fresh.trainable, mine["trainable"])
    for k, v in _paths(fresh.trainable).items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k])
    merged = tckpt.apply_trainable({"llm": 1, "lora": 2}, {"lora": 3, "bogus": 4})
    assert merged == {"llm": 1, "lora": 3}
    with pytest.raises(KeyError):
        tckpt.apply_trainable({"llm": 1}, {"bogus": 4}, strict=True)


def test_train_cli_runs_two_steps_on_cpu(tmp_path, capsys):
    from icl_speech_text_llm_tpu_torch.cli import train

    out = tmp_path / "ckpt"
    result = train.main(["--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "1",
                         "--batch_size", "2", "--max_samples", "4", "--seq_len", "768",
                         "--text_len", "384", "--val_max_samples", "2", "--device", "cpu",
                         "--output_dir", str(out)])
    assert "done: 2 steps" in capsys.readouterr().out
    assert result.skipped_batches == 0 and all(np.isfinite(result.losses))
    ckpts = glob.glob(os.path.join(out, "epoch_0_loss_*"))
    assert len(ckpts) == 1 and os.path.exists(os.path.join(ckpts[0], "state.npy"))
    assert result.perf["steps"] == 2 and len(result.perf["launches_per_step"]) == 2
    # resume from the checkpoint with its optimizer moments: epoch 1 only
    saved = tckpt.load_checkpoint(ckpts[0])
    resumed = train.main(["--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "2",
                          "--batch_size", "2", "--max_samples", "4", "--seq_len", "768",
                          "--text_len", "384", "--val_max_samples", "2", "--device", "cpu",
                          "--output_dir", str(out), "--resume_from_checkpoint", ckpts[0]])
    assert resumed.state.step == 4 and resumed.state.opt_state["count"] == 4
    assert saved["opt_state"]["count"] == 2 and saved["meta"]["epoch"] == 1
    assert len(glob.glob(os.path.join(out, "epoch_1_loss_*"))) == 1
    # --pp_microbatches is read only where pp > 1 (3 does not divide these
    # 2 rows): the run is the first one's
    again = train.main(["--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "1",
                        "--batch_size", "2", "--max_samples", "4", "--seq_len", "768",
                        "--text_len", "384", "--val_max_samples", "0", "--device", "cpu",
                        "--save_every", "0", "--pp_microbatches", "3"])
    assert again.losses == result.losses
    # FSDP, tp and pp meshes (and --auto_batch with them) need their
    # processes: one process is the world-size error
    for argv in (["--mesh", "2,1,1"], ["--mesh", "1,2,1"], ["--mesh", "1,1,2"],
                 ["--mesh", "1,1,2", "--auto_batch"], ["--mesh", "1,1,1,2"]):
        with pytest.raises(ValueError, match="2 != 1 processes"):
            train.main(argv + ["--device", "cpu", "--output_dir", str(out)])
    with pytest.raises(SystemExit):
        train.main(["--compile_cache", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no pipeline"):  # JAX's Qwen loss takes none
        train.main(["--model_type", "qwen2-audio-tiny", "--mesh", "1,1,1,2", "--device", "cpu"])
