"""The port's symbol adapter against the JAX package's, on the CPU at f32.

- the copies (``configs``, ``schedulers``, ``symbol_manager``): their code
  is the original's below the module docstring (``--device`` in place of
  ``--platform``); the same argv parses to the same ``TrainingConfig``;
  every ``TrainingMode`` gives the same schedule (and the saved schedule
  loads across packages); a seeded manager gives the same fixed and
  dynamic mappings, the same masked subsets and the same
  ``convert_symbols_back``;
- the MLP adapter with JAX's parameters carried across by the bridge:
  ``mlp_forward``, ``quantize_to_vocab`` (soft, hard, ties),
  ``transform_label_embeddings`` (mask, bypass, ``quantize=False``) and
  ``collect_discoveries`` within 1e-5, ids identical;
- ``mlp_salmonn_train_loss`` on salmonn-tiny with symbol tokens masked by a
  seeded manager: the loss within 1e-5 relative, the LoRA and MLP
  gradients within 1e-4 × the max |g| of their group;
- ``replace_symbols_in_sample`` and ``PerformanceTracker``'s summary.
"""

import ast
import dataclasses
import enum
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.symbol_adapter import configs as jconfigs
from icl_speech_text_llm_tpu.symbol_adapter import losses as jlosses
from icl_speech_text_llm_tpu.symbol_adapter import mlp_adapter as jmlp
from icl_speech_text_llm_tpu.symbol_adapter import schedulers as jsched
from icl_speech_text_llm_tpu.symbol_adapter import symbol_manager as jsm
from icl_speech_text_llm_tpu.symbol_adapter.trainer import (
    replace_symbols_in_sample as jreplace,
)
from icl_speech_text_llm_tpu.utils import perf as jperf
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
from icl_speech_text_llm_tpu_torch.symbol_adapter import configs as tconfigs
from icl_speech_text_llm_tpu_torch.symbol_adapter import losses as tlosses
from icl_speech_text_llm_tpu_torch.symbol_adapter import mlp_adapter as tmlp
from icl_speech_text_llm_tpu_torch.symbol_adapter import schedulers as tsched
from icl_speech_text_llm_tpu_torch.symbol_adapter import symbol_manager as tsm
from icl_speech_text_llm_tpu_torch.symbol_adapter.trainer import (
    replace_symbols_in_sample as treplace,
)
from icl_speech_text_llm_tpu_torch.training import step as tstep
from icl_speech_text_llm_tpu_torch.utils import perf as tperf
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)


def _plain(x):
    """A config value with every enum replaced by its value."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max(), scale)


# ---------------------------------------------------------------- the copies
def _code_lines(module):
    """The module's source below its docstring."""
    src = inspect.getsource(module)
    doc = ast.parse(src).body[0]
    return src.splitlines()[doc.end_lineno:]


@pytest.mark.parametrize("jmod,tmod", [(jconfigs, tconfigs), (jsched, tsched), (jsm, tsm)],
                         ids=["configs", "schedulers", "symbol_manager"])
def test_copies_hold_the_original_code(jmod, tmod):
    want, got = _code_lines(jmod), _code_lines(tmod)
    if jmod is jconfigs:  # --device (default cuda) in place of --platform
        i = want.index('    p.add_argument("--platform", type=str, default=None)')
        want = want[:i] + got[i:i + 2] + want[i + 1:]
        assert got[i].strip() == 'p.add_argument("--device", type=str, default="cuda",'
    assert got == want


ARGVS = [
    [],
    ["--training_mode", "lora_mlp_joint", "--dataset_type", "meld_emotion-sqa",
     "--val_dataset_type", "meld_emotion-sqa", "--synthetic", "--total_cycles", "1",
     "--lora_epochs", "1", "--mlp_epochs", "1", "--batch_size", "2", "--max_samples", "8",
     "--val_max_samples", "2", "--model_type", "salmonn-7b"],
    ["--training_mode", "bypass_mlp_sym", "--symbol_mode", "fixed", "--mlp_lr", "3e-4",
     "--lora_lr", "2e-5", "--mlp_hidden_dim", "16", "--num_examples", "3",
     "--fewshot_mode", "speech", "--input_mode", "speech_and_text", "--only_original",
     "--run_name", "r", "--output_dir", "o"],
    ["--training_mode", "bypass_mlp_org", "--symbol_mode", "no_symbols"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "config4", "bypass_sym", "bypass_org"])
def test_the_same_argv_parses_to_the_same_training_config(argv):
    jargs, targs = jconfigs.parse_training_args(argv), tconfigs.parse_training_args(argv)
    assert targs.device == "cuda" and not hasattr(targs, "platform")
    jv, tv = vars(jargs), vars(targs)
    jv.pop("platform")
    tv.pop("device")
    assert jv == tv
    jcfg, tcfg = jconfigs.TrainingConfig.from_args(jargs), tconfigs.TrainingConfig.from_args(targs)
    assert _plain(dataclasses.asdict(tcfg)) == _plain(dataclasses.asdict(jcfg))
    assert tcfg.get_schedule_info() == jcfg.get_schedule_info()


@pytest.mark.parametrize("mode", [m.value for m in jconfigs.TrainingMode])
def test_every_training_mode_gives_the_same_schedule(mode, tmp_path):
    kw = dict(total_cycles=2)
    if mode == "bypass_mlp_org":
        jkw = dict(kw, symbol_config=jconfigs.SymbolConfig(mode=jconfigs.SymbolMode.NO_SYMBOLS))
        tkw = dict(kw, symbol_config=tconfigs.SymbolConfig(mode=tconfigs.SymbolMode.NO_SYMBOLS))
    else:
        jkw = tkw = kw
    jcfg = jconfigs.TrainingConfig(mode=jconfigs.TrainingMode(mode), **jkw)
    tcfg = tconfigs.TrainingConfig(mode=tconfigs.TrainingMode(mode), **tkw)
    jsch, tsch = jsched.TrainingScheduler(jcfg), tsched.TrainingScheduler(tcfg)
    want = [s.to_dict() for s in jsch.generate_schedule()]
    assert [s.to_dict() for s in tsch.generate_schedule()] == want
    assert tcfg.symbol_config.mode.value == jcfg.symbol_config.mode.value
    path = str(tmp_path / "schedule.json")
    tsch.save_schedule(path)
    assert [s.to_dict() for s in jsched.TrainingScheduler.load_schedule(path)] == want
    assert [s.to_dict() for s in tsched.TrainingScheduler.load_schedule(path)] == want


LABELS = ["anger", "disgust", "fear", "joy", "neutral", "sadness", "surprise", "positive",
          "negative", "question", "statement", "agree", "disagree", "thanks", "greeting",
          "other", "apology"]


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_manager_draws_the_same_symbols_and_subsets(seed, tmp_path):
    tok = get_tokenizer()
    jm = jsm.SymbolManager(LABELS, tok, seed=seed)
    tm = tsm.SymbolManager(LABELS, tok, seed=seed)
    assert tm.fixed_mappings == jm.fixed_mappings and len(tm.fixed_mappings) == len(LABELS)
    batch = {"prompt": [" ".join(LABELS), "pick joy or fear"], "completion": ["joy", "other"]}
    for _ in range(4):  # masked subsets of ⌈n/8⌉ labels, drawn from the same RNG
        assert tm.replace_symbols_in_batch(batch, random_mask=True) == \
            jm.replace_symbols_in_batch(batch, random_mask=True)
        assert tm._rng.sample(LABELS, 3) == jm._rng.sample(LABELS, 3)
    texts = ["", "joy", " ".join(tm.fixed_mappings.values()),
             " ".join(tm.fixed_mappings.values()).upper(), "no symbol here"]
    for text in texts:
        assert tm.convert_symbols_back(text) == jm.convert_symbols_back(text)

    jd = jsm.SymbolManager(LABELS[:5], tok, dynamic_per_epoch=True, seed=seed)
    td = tsm.SymbolManager(LABELS[:5], tok, dynamic_per_epoch=True, seed=seed)
    for epoch, force in [(0, False), (1, False), (0, False), (0, True), (2, True)]:
        assert td.get_symbols_for_epoch(epoch, force) == jd.get_symbols_for_epoch(epoch, force)
    assert td.get_reverse_mappings() == jd.get_reverse_mappings()
    path = str(tmp_path / "mappings.json")
    td.save_mappings(path)
    loaded = jsm.SymbolManager(["x"], tok, seed=9)
    loaded.load_mappings(path)
    assert loaded.epoch_mappings_history == td.epoch_mappings_history
    assert loaded.current_epoch == td.current_epoch


def test_replace_symbols_in_sample_matches_jax():
    ds = create_dataset(DatasetType.MELD_EMOTION, split=DatasetSplit.TRAIN, is_training=True,
                        input_mode="speech_only", fewshot_mode="text", num_examples=3,
                        max_samples=2, synthetic=True, synthetic_size=4, seed=2)
    sm = tsm.SymbolManager(["anger", "joy", "neutral", "sadness"], get_tokenizer(), seed=1)
    for masked in (None, {"joy"}, set()):
        for sample in (ds[0], ds[1]):
            got, want = treplace(sample, sm.fixed_mappings, masked), \
                jreplace(sample, sm.fixed_mappings, masked)
            assert (got.plan.segments, got.plan.slots, got.plan.prompt, got.completion) == \
                (want.plan.segments, want.plan.slots, want.plan.prompt, want.completion)
            assert got.slot_audio is sample.slot_audio and got.extras is sample.extras
    assert any(s in treplace(ds[0], sm.fixed_mappings).plan.prompt
               for s in sm.fixed_mappings.values())


def test_performance_tracker_keeps_the_same_counters():
    jt, tt = jperf.PerformanceTracker(log_interval=0), tperf.PerformanceTracker(log_interval=0)
    for loss, ex, tok in [(2.0, 2, 10), (1.0, 2, 12), (0.5, 3, 0)]:
        jt.update(loss=loss, examples=ex, tokens=tok)
        tt.update(loss=loss, examples=ex, tokens=tok)
    j, t = jt.get_summary(), tt.get_summary()
    assert list(t) == list(j)
    for k in ("steps", "avg_loss", "total_examples"):
        assert t[k] == j[k]
    assert t["examples_per_sec"] > 0 and t["avg_step_time"] > 0


# ---------------------------------------------------------------- the MLP adapter
@pytest.fixture(scope="module")
def mlp_world():
    """JAX adapter params (non-zero biases and LN affine), embeds, a vocab
    and a mask; the port's copies through the bridge."""
    D, H, V = 16, 8, 40
    jp = jmlp.init_mlp_adapter(jax.random.PRNGKey(0), D, H)
    rng = np.random.RandomState(0)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.randn(*a.shape) * 0.1).astype(np.float32), jp)
    embeds = rng.randn(2, 6, D).astype(np.float32)
    vocab = rng.randn(V, D).astype(np.float32)
    mask = np.zeros((2, 6), bool)
    mask[0, 2] = mask[1, 4] = mask[1, 5] = True
    return jp, embeds, vocab, mask


def test_the_adapter_tree_crosses_the_bridge(mlp_world):
    jp = mlp_world[0]
    tp = params_from_numpy(jp, device="cpu")
    mine = tmlp.init_mlp_adapter(torch.Generator().manual_seed(0), 16, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in _paths(tp).items()} == \
        {k: tuple(v.shape) for k, v in _paths(mine).items()}
    assert list(_paths(tp)) == list(_paths(_np_tree(jp)))
    for k, v in _paths(tp).items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), _paths(jp)[k])
    assert inspect.signature(tmlp.init_mlp_adapter).parameters["device"].default == "cuda"


def test_mlp_forward_matches_jax(mlp_world):
    jp, embeds, _, _ = mlp_world
    want = jmlp.mlp_forward(jp["input_mlp"], jnp.asarray(embeds))
    got = tmlp.mlp_forward(params_from_numpy(jp, device="cpu")["input_mlp"],
                           torch.from_numpy(embeds))
    _close(got, want, what="mlp_forward")


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("temperature", [0.1, 1.0])
def test_quantize_to_vocab_matches_jax(mlp_world, hard, temperature):
    _, embeds, vocab, _ = mlp_world
    want = jmlp.quantize_to_vocab(jnp.asarray(embeds), jnp.asarray(vocab), temperature, hard)
    got = tmlp.quantize_to_vocab(torch.from_numpy(embeds), torch.from_numpy(vocab),
                                 temperature, hard)
    _close(got[0], want[0], what="quantized")
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], what="similarities")


def test_quantize_to_vocab_takes_the_first_of_tied_rows(mlp_world):
    _, embeds, vocab, _ = mlp_world
    tied = np.concatenate([vocab[:5], vocab[:5] * 2.0, vocab[5:]])  # same directions
    x = np.stack([tied[3], tied[1] + 1e-3 * embeds[0, 0]])[None]
    want = jmlp.quantize_to_vocab(jnp.asarray(x), jnp.asarray(tied), hard=True)
    got = tmlp.quantize_to_vocab(torch.from_numpy(x), torch.from_numpy(tied), hard=True)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1][0, 0].item() == 3


TRANSFORMS = {"soft": {}, "hard": {"hard": True}, "bypass": {"bypass": True},
              "no_quantize": {"quantize": False}, "output_mlp": {"which": "output_mlp"}}


@pytest.mark.parametrize("kw", TRANSFORMS.values(), ids=TRANSFORMS.keys())
def test_transform_label_embeddings_matches_jax(mlp_world, kw):
    jp, embeds, vocab, mask = mlp_world
    want = jmlp.transform_label_embeddings(jp, jnp.asarray(embeds), jnp.asarray(mask),
                                           jnp.asarray(vocab), **kw)
    got = tmlp.transform_label_embeddings(params_from_numpy(jp, device="cpu"),
                                          torch.from_numpy(embeds), torch.from_numpy(mask),
                                          torch.from_numpy(vocab), **kw)
    _close(got[0], want[0], what="embeds")
    assert got[1].dtype == torch.int32
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], what="similarities")
    # outside the mask: the embeddings bit for bit, ids -1
    assert torch.equal(got[0][~torch.from_numpy(mask)],
                       torch.from_numpy(embeds)[~torch.from_numpy(mask)])
    assert (got[1][~torch.from_numpy(mask)] == -1).all()


def test_label_mask_and_discoveries_match_jax(mlp_world):
    jp, embeds, vocab, mask = mlp_world
    tok = get_tokenizer()
    sym = tsm.SymbolManager(["positive", "negative"], tok, seed=0).fixed_mappings
    ids = [i for s in sym.values() for i in tok.encode(s, add_special_tokens=False)
           + tok.encode(" " + s, add_special_tokens=False)]
    tokens = np.array([tok.encode(f"the answer is {sym['positive']} now and {sym['negative']}",
                                  add_special_tokens=False)])
    assert np.array_equal(tmlp.label_token_mask(tokens, ids), jmlp.label_token_mask(tokens, ids))
    assert tmlp.label_token_mask(tokens, []).shape == tokens.shape
    text_tokens = np.random.RandomState(2).randint(3, 40, size=mask.shape)
    want = jmlp.transform_label_embeddings(jp, jnp.asarray(embeds), jnp.asarray(mask),
                                           jnp.asarray(vocab))
    got = tmlp.transform_label_embeddings(params_from_numpy(jp, device="cpu"),
                                          torch.from_numpy(embeds), torch.from_numpy(mask),
                                          torch.from_numpy(vocab))
    jd = jmlp.collect_discoveries(want[1], want[2], text_tokens, tok)
    td = tmlp.collect_discoveries(got[1], got[2], torch.from_numpy(text_tokens), tok)
    assert sorted(td) == sorted(jd) and len(td) == int(mask.sum())
    for k in jd:
        assert abs(td[k].pop("similarity") - jd[k].pop("similarity")) < 1e-5
        assert td[k] == jd[k]


# ---------------------------------------------------------------- the loss
@pytest.fixture(scope="module")
def loss_world():
    """JAX-initialised salmonn-tiny params (LoRA B non-zero), a JAX adapter
    (hidden 8), and one packed train batch whose labels were replaced by a
    seeded manager's symbols, with the symbol-token mask."""
    cfg = jsalmonn.salmonn_tiny()
    params = _np_tree(jsalmonn.init_salmonn(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    mlp = _np_tree(jmlp.init_mlp_adapter(jax.random.PRNGKey(1), cfg.llm.dim, 8))
    tok = get_tokenizer()
    ds = create_dataset(DatasetType.VOXCELEB, split=DatasetSplit.TRAIN, is_training=True,
                        input_mode="speech_only", fewshot_mode="text", num_examples=2,
                        max_samples=2, synthetic=True, synthetic_size=4, seed=5)
    sm = tsm.SymbolManager(["positive", "negative", "neutral"], tok, seed=0)
    samples = [treplace(ds[i], sm.fixed_mappings) for i in range(2)]
    assert samples[0].completion in sm.fixed_mappings.values()
    pack = PackConfig(seq_len=512, text_len=384, max_slots=1,
                      audio_tokens_per_slot=cfg.audio_tokens_per_slot)
    b = collate_icl_batch(samples, tok, pack)
    ids = [i for s in sm.fixed_mappings.values()
           for i in tok.encode(s, add_special_tokens=False) + tok.encode(" " + s,
                                                                         add_special_tokens=False)]
    label_mask = tmlp.label_token_mask(b.text_tokens, ids)
    assert label_mask.sum() > 4
    batch = {"text_tokens": b.text_tokens, "gather_idx": b.gather_idx, "seq_mask": b.seq_mask,
             "shifted_labels": b.labels_shifted, "wavs": b.audio["wavs"],
             "label_mask": label_mask}
    return params, mlp, batch


LOSSES = {"soft": {}, "hard": {"hard_quantization": True}, "bypass": {"bypass_mlp": True},
          "no_mlp": {"no_mlp": True}}


@pytest.mark.parametrize("kw", LOSSES.values(), ids=LOSSES.keys())
def test_symbol_loss_and_gradients_match_jax(loss_world, kw):
    params, mlp, batch = loss_world
    kw = dict(kw)
    no_mlp = kw.pop("no_mlp", False)

    def jloss(trainable, static, b):
        loss, disc, sims = jlosses.mlp_salmonn_train_loss(
            jsalmonn.salmonn_tiny(), static, b,
            mlp_params=None if no_mlp else trainable["mlp_adapter"],
            lora_params=trainable["lora"], temperature=0.1, **kw)
        return loss, (disc, sims)

    jtrain = {"lora": params["lora"], "mlp_adapter": mlp}
    (jval, (jdisc, jsims)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jtrain), jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = params_from_numpy(params, device="cpu")
    ttrain = tstep.tree_map(lambda t: t.clone().requires_grad_(),
                            params_from_numpy(jtrain, device="cpu"))
    loss, disc, sims = tlosses.mlp_salmonn_train_loss(
        tsalmonn.salmonn_tiny(), tparams, {k: torch.from_numpy(np.asarray(v))
                                           for k, v in batch.items()},
        mlp_params=None if no_mlp else ttrain["mlp_adapter"], lora_params=ttrain["lora"],
        temperature=0.1, **kw)
    named = _paths(ttrain)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    assert abs(loss.item() - float(jval)) <= 1e-5 * abs(float(jval))
    assert np.array_equal(disc.numpy(), np.asarray(jdisc))
    _close(sims.detach(), jsims, what="similarities")
    if not (no_mlp or kw):
        assert (disc.numpy() >= 0).sum() == batch["label_mask"].sum()
    jg = _paths(_np_tree(jgrads))
    for group in ("lora.", "mlp_adapter.input_mlp.", "mlp_adapter.output_mlp."):
        names = [n for n in named if n.startswith(group)]
        want = np.concatenate([jg[n].ravel() for n in names])
        got = np.concatenate([np.zeros(named[n].numel()) if g is None else g.numpy().ravel()
                              for n, g in zip(named, grads) if n in names])
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * max(scale, 1e-30), group
        trains_input = group == "mlp_adapter.input_mlp." and not (no_mlp or kw)
        assert (scale > 0) == (group == "lora." or trains_input), group
