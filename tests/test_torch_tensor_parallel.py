"""FSDP and tensor parallelism (``parallel/sharding.py``, the sharded layer
code) on gloo ranks on the CPU, against the JAX package UNSHARDED, the
port's counterpart of ``tests/test_parallel.py``.

Each mesh is one spawn of ``chip_smoke.py --dp_worker … MESH TASKS`` (one
process a rank, ``torch.set_num_threads(1)``, its own timeout) that runs
several tasks of ``chip_smoke.MESH_TASKS`` on salmonn-tiny's JAX-initialised
weights (carried across by ``bridge.py``, LoRA B drawn non-zero):

- (1,1,2): the train loss, one train step, greedy tokens, the XLA, FLASH
  and GENERIC decode routes, Qwen2-Audio's loss (qwen2-0.5b's 14 heads and
  2 KV heads become 7 and 1, tied vocab-sharded logits, q/k/v biases, the
  tower whole), the serving engine with a 2-adapter LoRA bank on every
  target (whole on every rank, a prefix and a beam request under an
  adapter); a second spawn: int8 tokens (the quantized leaves whole on
  every rank) and ``--auto_batch --mesh 1,1,2``;
- (1,2,1): the train loss and step;
- (2,2,2): the train loss and step, greedy tokens and the serving engine
  with a registered prefix and a 2-beam request;
- (1,2,2): the train CLI, whose gathered checkpoint reloads in one
  process with the loss the mesh gives its weights.

Limits: the loss within 1e-4 relative (``test_parallel.py``); the step's
loss, grad norm, gradients and updated leaves within
``tests/test_torch_distributed.py``'s (``chip_smoke.DP_LIMITS``); tokens
equal; the decode routes within 2e-4. Each step's collective calls per
family equal the formula of the layer code (``chip_smoke.mesh_step_counts``).
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

from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.inference import serving as jserving
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qwen_audio as jqwen
from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.ops.attention import make_decode_mask
from icl_speech_text_llm_tpu.ops.quant import quantize_decoder
from icl_speech_text_llm_tpu.training import step as jstep
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.data import collate as tcollate
from icl_speech_text_llm_tpu_torch.data import factory as tfactory
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.models import factory as tmodels
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = 90
GEN_KW = dict(max_new_tokens=5, eos_token_id=2, pad_token_id=0)
DECODE_CFG = dict(n_heads=2, n_kv_heads=2, head_dim=128)
QWEN = {"n_layers": 2, "tower": {}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _train_batch4():
    """Four rows of phase check's train batch with 5, 1, 2 and 5 label
    tokens: the (dp, fsdp) coordinates hold different counts."""
    b = chip_smoke._dp_batch(tsalmonn.salmonn_tiny())
    out = {k: np.concatenate([v, v[::-1]]) for k, v in b.items()}
    labels = out["shifted_labels"]
    labels[2, (labels[2] != -100).nonzero()[0][2:]] = -100
    return out


def _gen_batch():
    """Four synthetic voxceleb requests (2 text exemplars, the query's clip
    alone: ``test_parallel.py:76``'s layout), packed."""
    ds = tfactory.create_dataset(DatasetType.VOXCELEB, split=DatasetSplit.TEST,
                                 input_mode="speech_only", fewshot_mode="text",
                                 num_examples=2, max_samples=4, synthetic=True,
                                 synthetic_size=8, seed=3)
    cfg = PackConfig(seq_len=512, text_len=320, max_slots=1,
                     audio_tokens_per_slot=tsalmonn.salmonn_tiny().audio_tokens_per_slot)
    p = tcollate.collate_icl_batch([ds[i] for i in range(4)], get_tokenizer(), cfg)
    return {"text_tokens": p.text_tokens, "gather_idx": p.gather_idx,
            "seq_lengths": p.seq_lengths, "wavs": p.audio["wavs"]}


def _write(d, name, arrays=None, spec=None):
    if arrays is not None:
        np.savez(os.path.join(d, f"{name}.npz"), **arrays)
    if spec is not None:
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(spec, f)


@pytest.fixture(scope="module")
def world():
    params = _np(jsalmonn.init_salmonn(jax.random.PRNGKey(0), jsalmonn.salmonn_tiny()))
    rng = np.random.RandomState(1)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    return params, _train_batch4(), _gen_batch()


@pytest.fixture(scope="module")
def jax_ref(world):
    """JAX's unsharded loss, step (metrics, grads, updated leaves) and
    greedy tokens (f32 and int8) on the same weights and batches."""
    params, batch, gen = world
    cfg = jsalmonn.salmonn_tiny()
    jp, jb = _jnp(params), {k: jnp.asarray(v) for k, v in batch.items()}
    loss = float(jsalmonn.salmonn_train_loss(cfg, jp, jb))
    opt = jstep.make_optimizer(jstep.OptimizerSettings(**chip_smoke.DP_OPT))
    state, frozen = jstep.init_train_state(jp, opt)
    grads = jax.grad(lambda tr: jsalmonn.salmonn_train_loss(
        cfg, jstep.merge_params(frozen, tr), jb))(state.trainable)
    state, metrics = jstep.make_train_step(cfg, opt)(state, frozen, jb)
    jg = {k: jnp.asarray(v) for k, v in gen.items()}
    gcfg = jengine.GenerationConfig(**GEN_KW)
    tokens = np.asarray(jengine.salmonn_generate(cfg, gcfg, jp, jg))
    q8 = {**jp, "llm": quantize_decoder(jp["llm"], bits=8)}
    tokens8 = np.asarray(jengine.salmonn_generate(cfg, gcfg, q8, jg))
    return {"loss": loss, "step_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "leaves": chip_smoke._paths(_np(state.trainable)),
            "grads": chip_smoke._paths(_np(grads)), "tokens": tokens, "tokens8": tokens8}


def _spawn(tmp_path_factory, params, batch, mesh, tasks, world_size, inputs=()):
    d = str(tmp_path_factory.mktemp("mesh" + mesh.replace(",", "")))
    for args in inputs:
        _write(d, *args)
    return chip_smoke._dp_spawn(d, "file", params, batch, "cpu", world=world_size,
                                timeout=TIMEOUT, mesh=mesh, tasks=tasks), d


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


def _qwen_cfg():
    return chip_smoke._qwen_mesh_cfg(QWEN, jqwen)


@pytest.fixture(scope="module")
def qwen_inputs():
    cfg = _qwen_cfg()
    params = _np(jqwen.init_qwen_audio(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(2)
    for sub in params["lora"].values():
        sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
    n_audio = int(jqwen.audio_output_length(5 * 16000))
    batch = chip_smoke._train_batch(cfg, n_audio, 512, clip_samples=5 * 16000)
    want = float(jqwen.qwen_audio_train_loss(cfg, _jnp(params),
                                             {k: jnp.asarray(v) for k, v in batch.items()}))
    return [("qwen", {k: v for k, v in chip_smoke._paths(params).items()}, QWEN),
            ("qbatch", batch)], want


@pytest.fixture(scope="module")
def bank_inputs():
    """The serving case with a 2-adapter bank on all seven targets (B
    non-zero): requests alternate adapters, the prefix and the beam
    request run under adapter 1; JAX's engine unsharded."""
    cfg = jllama.DECODER_CONFIGS["tiny"]
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    lcfg = jllama.LoraConfig(rank=4, alpha=8.0, targets=tuple(jllama.LORA_TARGET_SHAPES))
    rng = np.random.RandomState(4)
    adapters = []
    for seed in (5, 6):
        lo = _np(jllama.init_lora(jax.random.PRNGKey(seed), cfg, lcfg))
        for sub in lo.values():
            sub["b"] = (rng.randn(*sub["b"].shape) * 0.05).astype(np.float32)
        adapters.append(lo)
    bank = _np(jllama.stack_lora_bank([_jnp(a) for a in adapters]))
    serving = dict(num_slots=2, max_new_tokens=5, prompt_buckets=[16, 32],
                   prefix_buckets=[16], eos_token_id=2)
    reqs = [(rng.randn(int(n), cfg.dim).astype(np.float32) * 0.3, int(n))
            for n in rng.randint(5, 30, size=5)]
    prefix = rng.randn(12, cfg.dim).astype(np.float32) * 0.3
    adapter_ids = [1, 0, 1, 0, 1]
    spec = {"decoder": "tiny", "serving": serving, "lengths": [n for _, n in reqs],
            "prefix_request": 0, "beam_request": len(reqs) - 1, "adapters": adapter_ids,
            "prefix_adapter": 1, "lora_scaling": lcfg.scaling}
    arrays = {**{f"params.{k}": v for k, v in chip_smoke._paths(params).items()},
              **{f"bank.{k}": v for k, v in chip_smoke._paths(bank).items()},
              **{f"req.{i}": e for i, (e, _) in enumerate(reqs)}, "prefix": prefix}
    engine = jserving.ContinuousBatchingEngine(cfg, _jnp(params), jserving.ServingConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in serving.items()}),
        lora=_jnp(bank), lora_scaling=lcfg.scaling)
    pid = engine.register_prefix(prefix, len(prefix), adapter_id=1)
    rids = [engine.submit(e, n, num_beams=2 if i == len(reqs) - 1 else 1,
                          prefix_id=pid if i == 0 else None, adapter_id=adapter_ids[i])
            for i, (e, n) in enumerate(reqs)]
    res = engine.run()
    return ("serve_bank", arrays, spec), [res[r] for r in rids]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory, world, decode_inputs, qwen_inputs, bank_inputs):
    params, batch, gen = world
    inputs = [("gen", gen, {"kw": GEN_KW}), decode_inputs[0], *qwen_inputs[0], bank_inputs[0]]
    return _spawn(tmp_path_factory, params, batch, "1,1,2",
                  ("loss", "step", "generate", "decode", "qwen", "serve_bank"), 2, inputs)[0]


@pytest.fixture(scope="module")
def tp2_int8_cli(tmp_path_factory, world):
    """A second (1,1,2) spawn: int8 generation and the CLI's --auto_batch."""
    params, batch, gen = world
    inputs = [("gen", gen, {"kw": GEN_KW}),
              ("cli", None, {"auto_batch": True, "argv": [
                  "--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "1",
                  "--batch_size", "2", "--max_samples", "2", "--seq_len", "768",
                  "--text_len", "384", "--val_max_samples", "1", "--device", "cpu",
                  "--auto_batch", "--auto_batch_max", "2", "--mesh", "1,1,2",
                  "--save_every", "0"]})]
    return _spawn(tmp_path_factory, params, None, "1,1,2", ("generate_int8", "train_cli"), 2,
                  inputs)[0]


@pytest.fixture(scope="module")
def fsdp2(tmp_path_factory, world):
    params, batch, _ = world
    return _spawn(tmp_path_factory, params, batch, "1,2,1", ("loss", "step"), 2)[0]


@pytest.fixture(scope="module")
def serve_inputs():
    """``test_parallel.py``'s serving case: the tiny decoder, 5 requests of
    5-29 positions, a 12-position prefix for the first, 2 beams for the
    last; JAX's engine unsharded."""
    cfg = jllama.DECODER_CONFIGS["tiny"]
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), cfg))
    serving = dict(num_slots=2, max_new_tokens=5, prompt_buckets=[16, 32],
                   prefix_buckets=[16], eos_token_id=2)
    rng = np.random.RandomState(1)
    reqs = [(rng.randn(int(n), cfg.dim).astype(np.float32) * 0.3, int(n))
            for n in rng.randint(5, 30, size=5)]
    prefix = rng.randn(12, cfg.dim).astype(np.float32) * 0.3
    spec = {"decoder": "tiny", "serving": serving, "lengths": [n for _, n in reqs],
            "prefix_request": 0, "beam_request": len(reqs) - 1}
    arrays = {**{f"params.{k}": v for k, v in chip_smoke._paths(params).items()},
              **{f"req.{i}": e for i, (e, _) in enumerate(reqs)}, "prefix": prefix}
    engine = jserving.ContinuousBatchingEngine(cfg, _jnp(params), jserving.ServingConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in serving.items()}))
    pid = engine.register_prefix(prefix, len(prefix))
    rids = [engine.submit(e, n, num_beams=2 if i == len(reqs) - 1 else 1,
                          prefix_id=pid if i == 0 else None) for i, (e, n) in enumerate(reqs)]
    res = engine.run()
    return ("serve", arrays, spec), [res[r] for r in rids]


@pytest.fixture(scope="module")
def mesh222(tmp_path_factory, world, serve_inputs):
    params, batch, gen = world
    return _spawn(tmp_path_factory, params, batch, "2,2,2",
                  ("loss", "step", "generate", "serve"), 8,
                  [("gen", gen, {"kw": GEN_KW}), serve_inputs[0]])[0]


def _mesh_ranks(request, mesh):
    return request.getfixturevalue({"1,1,2": "tp2", "1,2,1": "fsdp2",
                                    "2,2,2": "mesh222"}[mesh])


@pytest.fixture(params=["1,1,2", "1,2,1", "2,2,2"])
def ranks(request):
    return request.param, _mesh_ranks(request, request.param)


def test_sharded_loss_matches_jax_unsharded(ranks, jax_ref):
    """``test_parallel.py:36``: the sharded loss equals the unsharded one."""
    _, ranks = ranks
    for res, _ in ranks:
        assert res["loss"]["loss"] == pytest.approx(jax_ref["loss"], rel=1e-4)


def test_one_train_step_matches_jax_full_batch_step(ranks, jax_ref):
    """Loss, grad norm, the summed gradients (from AdamW's first moments)
    and the gathered updated leaves within the dp test's limits, equal on
    every rank; a label past the vocabulary on one (dp, fsdp) coordinate
    skips the step on every rank."""
    mesh, ranks = ranks
    lim = chip_smoke.DP_LIMITS
    for res, arrays in ranks:
        s = res["step"]
        assert not s["skipped"]
        assert abs(s["loss"] - jax_ref["step_loss"]) <= lim["loss"] * abs(jax_ref["step_loss"])
        assert abs(s["grad_norm"] - jax_ref["grad_norm"]) <= lim["grad_norm"] * jax_ref["grad_norm"]
        leaves = {k[len("trainable."):]: v for k, v in arrays.items()
                  if k.startswith("trainable.")}
        grads = chip_smoke._dp_grads({k[len("mu."):]: v for k, v in arrays.items()
                                      if k.startswith("mu.")}, s["grad_norm"])
        assert set(leaves) == set(jax_ref["leaves"]) == set(grads)
        for name, want in jax_ref["leaves"].items():
            err = np.abs(leaves[name] - want).max() / chip_smoke._group_max(jax_ref["leaves"], name)
            assert err <= lim["leaves"], (mesh, name, err)
        for name, want in jax_ref["grads"].items():
            err = np.abs(grads[name] - want).max() / chip_smoke._group_max(jax_ref["grads"], name)
            assert err <= lim["grads"], (mesh, name, err)
        for k, v in arrays.items():
            if k.startswith(("trainable.", "mu.")):
                np.testing.assert_array_equal(v, ranks[0][1][k])
        assert s["nan_skipped"] == 1.0 and s["kept_after_nan"] and not np.isfinite(s["nan_loss"])


def test_collective_counts_per_step_equal_their_formula(ranks):
    """The port's counterpart of ``test_parallel.py:122`` (which bounds the
    compiled HLO's collectives): the calls each family makes in one step."""
    mesh, ranks = ranks
    want = chip_smoke.mesh_step_counts(tsalmonn.salmonn_tiny(),
                                       tuple(int(x) for x in mesh.split(",")))
    for res, _ in ranks:
        assert res["step"]["counts"] == want, mesh


@pytest.mark.parametrize("mesh", ["1,1,2", "2,2,2"])
def test_greedy_tokens_match_jax_unsharded(request, mesh, jax_ref):
    """``test_parallel.py:76``: tp-sharded static generation emits the
    unsharded tokens; every tp rank the same."""
    for res, arrays in _mesh_ranks(request, mesh):
        start, n = res["generate"]["rows"]
        rows = len(jax_ref["tokens"]) // n
        np.testing.assert_array_equal(arrays["generate.tokens"],
                                      jax_ref["tokens"][start * rows:(start + 1) * rows])


def test_int8_tokens_under_tp_match_jax(tp2_int8_cli, jax_ref):
    """The int8 LLM's quantized leaves match no rule: whole on every rank,
    each computing the full product and keeping its columns."""
    for res, arrays in tp2_int8_cli:
        np.testing.assert_array_equal(arrays["generate_int8.tokens"], jax_ref["tokens8"])


def test_serving_under_the_mesh_matches_jax_unsharded(mesh222, serve_inputs):
    """``test_parallel.py:167``: the slot pool with the rank's KV heads, a
    registered prefix and a 2-beam request, token for token."""
    for res, _ in mesh222:
        assert res["serve"]["results"] == serve_inputs[1]
        assert all(len(t) for t in res["serve"]["results"])


def test_lora_bank_serving_under_tp_matches_jax_unsharded(tp2, bank_inputs):
    """A bank whole on every tp rank: column targets cut B's columns, row
    targets A's rows (their partial deltas summed with the product's), a
    prefix and a beam lane under an adapter; token for token."""
    for res, _ in tp2:
        assert res["serve_bank"]["results"] == bank_inputs[1]
        assert all(len(t) for t in res["serve_bank"]["results"])


def test_decode_routes_under_tp_match_jax_generic(tp2, decode_inputs):
    """``test_parallel.py:209``: XLA, FLASH (K7's plain version on the
    rank's one KV head) and GENERIC against JAX's ``use_flash_decode=False``."""
    want = decode_inputs[1]
    for res, arrays in tp2:
        assert res["decode"]["kv_heads"] == 1
        for route in ("xla", "flash", "generic"):
            np.testing.assert_allclose(arrays[f"decode.{route}"], want, rtol=2e-4, atol=2e-4)


def test_qwen_loss_under_tp_matches_jax(tp2, qwen_inputs):
    for res, _ in tp2:
        assert res["qwen"]["loss"] == pytest.approx(qwen_inputs[1], rel=1e-4)


def test_auto_batch_under_a_mesh_picks_one_size(tp2_int8_cli):
    """Each rank's own measure says a different largest size ((3 + 2 rank)
    GiB a row against the default 8 GiB budget: 2 and 1); agreed over the
    ranks, both pick 1 and train with it."""
    ranks = tp2_int8_cli
    assert [res["train_cli"]["picks"] for res, _ in ranks] == [[1], [1]]
    for res, _ in ranks:
        assert res["train_cli"]["steps"] == 2 and not res["train_cli"]["skipped"]
    assert ranks[0][0]["train_cli"]["losses"] == ranks[1][0]["train_cli"]["losses"]


def test_checkpoint_written_under_a_mesh_reloads_in_one_process(tmp_path_factory, world):
    """The train CLI at (1,2,2): rank 0 writes the gathered leaves in the
    one-process format; loaded into one process's model, they give the
    loss the mesh gives its weights."""
    _, batch, _ = world
    argv = ["--model_type", "salmonn-tiny", "--synthetic", "--num_epochs", "1",
            "--batch_size", "2", "--max_samples", "4", "--seq_len", "768", "--text_len", "384",
            "--val_max_samples", "2", "--device", "cpu", "--mesh", "1,2,2"]
    d = str(tmp_path_factory.mktemp("ckpt"))
    argv += ["--output_dir", os.path.join(d, "out")]
    _write(d, "cli", spec={"argv": argv})
    ranks = chip_smoke._dp_spawn(d, "file", None, batch, "cpu", world=4, timeout=TIMEOUT,
                                 mesh="1,2,2", tasks=("train_cli",))
    res = [r["train_cli"] for r, _ in ranks]
    assert all(r["steps"] == 2 and not r["skipped"] for r in res)
    assert len({json.dumps(r["losses"]) for r in res}) == 1
    (ckpt,) = res[0]["checkpoints"]
    assert all(not r["checkpoints"] for r in res[1:])
    model = tmodels.create_model("salmonn-tiny", seed=42, device="cpu")
    trainable = tckpt.load_checkpoint(ckpt)["trainable"]
    params = tckpt.apply_trainable(model.params, params_from_numpy(trainable, device="cpu"))
    with torch.no_grad():
        loss = model.loss_fn(model.cfg, params,
                             {k: torch.as_tensor(v) for k, v in batch.items()}).item()
    for r in res:
        assert r["loss_after"] == pytest.approx(loss, rel=1e-4)
