"""The port's ``UnifiedTrainer``, checkpoints and ``ValidationManager``
against the JAX package's, on salmonn-tiny at f32 on the CPU.

Both packages build their world from the same ``TrainingConfig`` (symbol
seed 0, so the same symbols and masked subsets); the port's model and MLP
adapter get JAX's weights through the bridge (LoRA B drawn non-zero), and
both trainers pack to 512 positions (the orchestrator's 2048 is exercised by
``tests/test_torch_symbol_cli.py``):

- the ``lora_mlp_joint`` schedule (a LoRA step with the MLP bypassed, an
  MLP step, a joint step; learning rate 1e-3) and a ``bypass_mlp_sym`` run
  with dynamic symbols regenerated every batch: every batch's loss within
  1e-5 relative, the trained leaves within 1e-4 × max |leaf|, and the
  subtree outside the phase bit-identical to what it was;
- checkpoints with config and mappings, written by the port and restored by
  JAX's ``InferenceOrchestrator``, and the other way round;
- every validation mode's predictions and composite equal to JAX's
  (``no_mlp_fresh`` under one patched seed in both; unseeded, by its
  properties).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.data.packing import PackConfig as JPackConfig
from icl_speech_text_llm_tpu.symbol_adapter import configs as jconfigs
from icl_speech_text_llm_tpu.symbol_adapter import orchestrator as jorch
from icl_speech_text_llm_tpu.symbol_adapter import schedulers as jsched
from icl_speech_text_llm_tpu.symbol_adapter import trainer as jtrainer
from icl_speech_text_llm_tpu.symbol_adapter import validation as jval
from icl_speech_text_llm_tpu.training import checkpoint as jckpt
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.models.factory import create_model
from icl_speech_text_llm_tpu_torch.symbol_adapter import configs as tconfigs
from icl_speech_text_llm_tpu_torch.symbol_adapter import orchestrator as torch_orch
from icl_speech_text_llm_tpu_torch.symbol_adapter import schedulers as tsched
from icl_speech_text_llm_tpu_torch.symbol_adapter import trainer as ttrainer
from icl_speech_text_llm_tpu_torch.symbol_adapter import validation as tval
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt

torch.set_num_threads(1)
SEQ = (512, 384)
TRACKERS = (jtrainer.PerformanceTracker, ttrainer.PerformanceTracker)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _np(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in _paths(tree).items()}


def _config(pkg, mode, **lora):
    cfg = pkg.TrainingConfig(mode=pkg.TrainingMode(mode), total_cycles=1,
                             model_type="salmonn-tiny")
    d = cfg.data_config
    d.dataset_type = d.val_dataset_type = "voxceleb"
    d.batch_size, d.max_samples, d.val_max_samples, d.val_batch_size = 2, 4, 2, 2
    d.num_examples, d.fewshot_mode, d.synthetic = 1, "text", True
    cfg.lora_config.epochs = cfg.mlp_config.epochs = cfg.lora_config.final_epochs = 1
    cfg.lora_config.learning_rate = cfg.mlp_config.learning_rate = 1e-3
    cfg.symbol_config.seed = 0
    for k, v in lora.items():
        setattr(cfg.lora_config, k, v)
    return cfg


class _Recorder:
    """``PerformanceTracker`` of both trainers, keeping every loss."""

    def __init__(self, base, sink):
        class Tracker(base):
            def update(self, loss=None, examples=0, tokens=0):
                sink.append(loss)
                super().update(loss=loss, examples=examples, tokens=tokens)

        self.cls = Tracker


def _worlds(mode, **lora):
    """(JAX orchestrator, port orchestrator) with the same weights, both
    packing to ``SEQ``, validators detached."""
    jo = jorch.build_training_world(_config(jconfigs, mode, **lora), seed=0)
    to = torch_orch.build_training_world(_config(tconfigs, mode, **lora), seed=0, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jo.model.params)
    rng = np.random.RandomState(3)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    jo.model.params = jo.model.engine.params = jax.tree_util.tree_map(jnp.asarray, params)
    to.model.params = to.model.engine.params = params_from_numpy(params, device="cpu")
    to.trainer.mlp_params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jo.trainer.mlp_params), device="cpu")
    T_a = jo.model.cfg.audio_tokens_per_slot
    kw = dict(seq_len=SEQ[0], text_len=SEQ[1], max_slots=1, audio_tokens_per_slot=T_a)
    jo.trainer.pack_cfg = jo.model.pack_cfg = JPackConfig(**kw)
    to.trainer.pack_cfg = to.model.pack_cfg = PackConfig(**kw)
    return jo, to


def _run_schedule(jo, to, monkeypatch, steps):
    """Each step in both trainers → [(step, jax losses, port losses, jax
    state before/after, port state before/after)]."""
    out = []
    for step in steps:
        jl, tl = [], []
        monkeypatch.setattr(jtrainer, "PerformanceTracker", _Recorder(TRACKERS[0], jl).cls)
        monkeypatch.setattr(ttrainer, "PerformanceTracker", _Recorder(TRACKERS[1], tl).cls)

        def state(tr):
            return {"lora": _np(tr.model.params["lora"]), "mlp": _np(tr.mlp_params)}

        jb, tb = state(jo.trainer), state(to.trainer)
        js = jo.trainer.train_step(copy.deepcopy(step[0]), jo.train_dataset)
        ts = to.trainer.train_step(copy.deepcopy(step[1]), to.train_dataset)
        out.append((step[1], jl, tl, jb, state(jo.trainer), tb, state(to.trainer), js, ts))
    return out


@pytest.fixture(scope="module")
def joint_run():
    jo, to = _worlds("lora_mlp_joint")
    jo.trainer.validator = to.trainer.validator = None
    steps = list(zip(jsched.TrainingScheduler(jo.config).generate_schedule(),
                     tsched.TrainingScheduler(to.config).generate_schedule()))
    assert [s[1].phase for s in steps] == ["lora", "mlp", "joint"]
    with pytest.MonkeyPatch.context() as mp:
        return jo, to, _run_schedule(jo, to, mp, steps)


def _check_step(rec):
    step, jl, tl, jb, ja, tb, ta, js, ts = rec
    assert len(tl) == len(jl) == 2 and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ts["final_loss"] == tl[-1] and ts["phase"] == js["phase"]
    assert ts["perf"]["steps"] == js["perf"]["steps"] == 2
    trained = {"lora": not step.freeze_lora, "mlp": not step.freeze_mlp}
    for sub, on in trained.items():
        for name, want in ja[sub].items():
            got = ta[sub][name]
            assert got.dtype == want.dtype == np.float32, name
            if on:
                scale = np.abs(want).max()
                assert np.abs(got - want).max() <= 1e-4 * scale, (sub, name)
            else:  # outside the phase: not touched, bit for bit
                assert np.array_equal(got, tb[sub][name]), (sub, name)
                assert np.array_equal(want, jb[sub][name]), (sub, name)
        moved = [n for n in ta[sub] if not np.array_equal(ta[sub][n], tb[sub][n])]
        assert bool(moved) == on, (sub, moved)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["lora", "mlp", "joint"])
def test_lora_mlp_joint_schedule_matches_jax(joint_run, i):
    _check_step(joint_run[2][i])


def test_frozen_weights_and_the_published_lora(joint_run):
    jo, to, _ = joint_run
    fresh = create_model("salmonn-tiny", seed=0, device="cpu", trainable_dtype=torch.float32)
    for sub in ("llm", "whisper", "beats", "qformer"):
        want = _np(jax.tree_util.tree_map(np.asarray, jo.model.params[sub]))
        for name, got in _np(to.model.params[sub]).items():
            assert np.array_equal(got, want[name]), (sub, name)
    assert to.model.engine.params is to.model.params
    for t in _paths(to.model.params["lora"]).values():
        assert t.dtype == torch.float32 and not t.requires_grad
    # a model that holds LoRA in another dtype gets it back in that dtype
    bf16 = create_model("salmonn-tiny", seed=0, device="cpu", trainable_dtype=torch.bfloat16)
    trainer = ttrainer.UnifiedTrainer(to.config, bf16, to.trainer.mlp_params,
                                      to.trainer.symbol_manager, to.trainer.pack_cfg)
    trainer._publish({"lora": ttrainer._masters(fresh.params["lora"])})
    assert all(t.dtype == torch.bfloat16 for t in _paths(bf16.params["lora"]).values())
    assert bf16.engine.params is bf16.params


def test_bypass_mlp_sym_with_dynamic_symbols_matches_jax(monkeypatch):
    """Dynamic symbols regenerated at every epoch and, with the cadence
    patched to 1 × accum 1, at every batch past the first: the same
    mappings, masked subsets and losses as JAX's."""
    jo, to = _worlds("bypass_mlp_sym", epochs=2, gradient_accumulation_steps=1)
    jo.trainer.validator = to.trainer.validator = None
    assert to.config.symbol_config.mode is tconfigs.SymbolMode.DYNAMIC_PER_EPOCH
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(mod, "FORCE_NEW_SYMBOLS_EVERY", 1)
    steps = list(zip(jsched.TrainingScheduler(jo.config).generate_schedule(),
                     tsched.TrainingScheduler(to.config).generate_schedule()))
    (step, jl, tl, jb, ja, tb, ta, js, ts), = _run_schedule(jo, to, monkeypatch, steps)
    assert step.bypass_mlp and step.dynamic_symbols and len(tl) == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    history = to.trainer.symbol_manager.epoch_mappings_history
    assert history == jo.trainer.symbol_manager.epoch_mappings_history and len(history) == 2
    assert to.trainer._symbol_token_ids == jo.trainer._symbol_token_ids
    for name, want in ja["lora"].items():
        assert np.abs(ta["lora"][name] - want).max() <= 1e-4 * np.abs(want).max(), name
    for name in ta["mlp"]:
        assert np.array_equal(ta["mlp"][name], tb["mlp"][name])


# ---------------------------------------------------------------- checkpoints
def test_port_checkpoint_restores_in_jax_and_jax_checkpoint_in_the_port(
        joint_run, tmp_path, monkeypatch):
    jo, to, records = joint_run
    step = records[-1][0]
    path = to.trainer.save_checkpoint_with_config(str(tmp_path / "port"), step, 1.5)
    meta = tckpt.load_checkpoint(path)["meta"]
    assert meta["metadata"]["symbol_mappings"] == to.trainer.symbol_manager.fixed_mappings
    assert meta["metadata"]["training_config"]["mode"] == "lora_mlp_joint"
    assert meta["metadata"]["phase"] == "joint" and meta["loss"] == 1.5
    restored = jorch.InferenceOrchestrator(path, config=_config(jconfigs, "lora_mlp_joint"))
    rt = restored.orchestrator.trainer
    for sub, want in (("lora", to.model.params["lora"]), ("mlp", to.trainer.mlp_params)):
        got = _np(jax.tree_util.tree_map(np.asarray, rt.model.params["lora"] if sub == "lora"
                                         else rt.mlp_params))
        assert list(got) == list(_np(want))
        for name, w in _np(want).items():
            assert np.array_equal(got[name], w), (sub, name)
    assert rt.symbol_manager.fixed_mappings == to.trainer.symbol_manager.fixed_mappings

    monkeypatch.setattr(jckpt, "_HAVE_ORBAX", False)  # JAX's layout without orbax
    jpath = jo.trainer.save_checkpoint_with_config(str(tmp_path / "jax"), step, 2.5)
    back = torch_orch.InferenceOrchestrator(jpath, config=_config(tconfigs, "lora_mlp_joint"),
                                            device="cpu")
    bt = back.orchestrator.trainer
    assert back.validator is bt.validator and back.config.inference_mode
    for sub, want in (("lora", jo.model.params["lora"]), ("mlp", jo.trainer.mlp_params)):
        got = _np(bt.model.params["lora"] if sub == "lora" else bt.mlp_params)
        for name, w in _np(jax.tree_util.tree_map(np.asarray, want)).items():
            assert got[name].dtype == np.float32 and np.array_equal(got[name], w), (sub, name)
    assert bt.model.engine.params is bt.model.params
    assert bt.symbol_manager.fixed_mappings == jo.trainer.symbol_manager.fixed_mappings


# ---------------------------------------------------------------- validation
@pytest.fixture(scope="module")
def fresh_worlds():
    return _worlds("lora_first")


def _seeded(sm_cls, seed):
    """``SymbolManager`` whose unseeded instances draw from ``seed``."""
    def make(*a, **kw):
        if kw.get("seed") is None:
            kw["seed"] = seed
        return sm_cls(*a, **kw)
    return make


@pytest.mark.parametrize("mode", tval.VALIDATION_MODES)
def test_validation_modes_match_jax(fresh_worlds, mode, monkeypatch):
    jo, to = fresh_worlds
    monkeypatch.setattr(jval, "SymbolManager", _seeded(jval.SymbolManager, 11))
    monkeypatch.setattr(tval, "SymbolManager", _seeded(tval.SymbolManager, 11))
    want = jo.trainer.validator._run_mode(mode, 0, collect_predictions=True)
    got = to.trainer.validator._run_mode(mode, 0, collect_predictions=True)
    assert len(got["predictions"]) == 2
    assert got["predictions"] == want["predictions"]
    assert got["composite"] == want["composite"] and got["per_dataset"] == want["per_dataset"]
    assert got["detailed"].keys() == want["detailed"].keys()


def test_unseeded_fresh_mode_draws_new_two_token_symbols(fresh_worlds):
    _, to = fresh_worlds
    v = to.trainer.validator
    fresh = v._mode_mappings("no_mlp_fresh", 0)
    assert list(fresh) == v.symbol_manager.original_labels
    tok = to.model.tokenizer
    for sym in fresh.values():
        assert len(tok.encode(sym, add_special_tokens=False)) == 2
    assert v._mode_mappings("no_mlp_symbols", 0) == v.symbol_manager.fixed_mappings
    assert v._mode_mappings("no_mlp_original", 0) is None
    composites = v.validate_model(epoch=0)
    assert list(composites) == list(tval.VALIDATION_MODES)
    assert all(c.startswith("voxceleb:") for c in composites.values())
