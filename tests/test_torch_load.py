"""Loading converted weights and checkpoints into the port, against the JAX
package, on salmonn-tiny in f32 on the CPU.

- ``create_model(llm_params_dir=)``: HF shards converted by JAX at f32, f16,
  int8 and int4 load into the port as into JAX (the same leaves), and greedy
  tokens over them are identical to JAX's;
- ``create_model(adapter_params_dir=)`` on a converted ``salmonn_v1.pth``,
  and ``get_model_from_checkpoint`` / ``--peft_model_path`` on a
  ``state.npy`` that JAX wrote: the same, with the checks JAX makes (a
  wrong-shape adapter raises; the CLI refuses a dir quantized at another
  width than it asks);
- ``init_salmonn(skip_llm=True)`` draws every other subtree as without it;
- ``SalmonnConfig.encode_chunk`` agrees with JAX's and with no chunks;
- ``SalmonnModel.forward`` / ``generate_output`` / ``get_speech_embeddings``
  against JAX's.

Random subtrees that neither package loads are drawn differently by the two
(a torch Generator, a JAX key): those are copied from the JAX model into the
port's before generating, so that the tokens depend on the loaded weights
alone.
"""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu import registry as jregistry
from icl_speech_text_llm_tpu.cli import convert as jcli_convert
from icl_speech_text_llm_tpu.cli import inference as jcli_inference
from icl_speech_text_llm_tpu.data import factory as jdata
from icl_speech_text_llm_tpu.data.packing import PackConfig as JPackConfig
from icl_speech_text_llm_tpu.inference import engine as jengine
from icl_speech_text_llm_tpu.models import factory as jfactory
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qformer as jqformer
from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.models import stream_convert as jstream
from icl_speech_text_llm_tpu.models import synth_ckpt as jsynth
from icl_speech_text_llm_tpu.ops.mel import log_mel_spectrogram as jlog_mel
from icl_speech_text_llm_tpu.ops.mel import pad_or_trim as jpad_or_trim
from icl_speech_text_llm_tpu.training import checkpoint as jckpt
from icl_speech_text_llm_tpu_torch import registry as tregistry
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import inference as tcli_inference
from icl_speech_text_llm_tpu_torch.data import factory as tdata
from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
from icl_speech_text_llm_tpu_torch.inference import engine as tengine
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.models import salmonn as tsalmonn
from icl_speech_text_llm_tpu_torch.models.base import BaseModel
from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

torch.set_num_threads(1)
K = 2  # speech exemplars per request
#: the subtrees each kind of load replaces
LOADED = {"llm": ("llm",), "adapter": ("qformer", "lora"), "peft": ("qformer", "lora")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pack(cls):
    return cls(seq_len=768, text_len=384, max_slots=K + 1,
               audio_tokens_per_slot=tsalmonn.salmonn_tiny().audio_tokens_per_slot)


def _dataset(factory, registry):
    return factory.create_dataset(
        registry.DatasetType.VOXCELEB, split=registry.DatasetSplit.TEST,
        input_mode="speech_only", fewshot_mode="speech", num_examples=K, max_samples=4,
        synthetic=True, synthetic_size=8, seed=3)


@pytest.fixture(scope="module")
def batch():
    packed = collate_icl_batch([_dataset(tdata, tregistry)[i] for i in range(2)],
                               get_tokenizer(), _pack(PackConfig))
    return {"text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
            "seq_lengths": packed.seq_lengths, "wavs": packed.audio["wavs"]}


def _tensor_tree_to_np(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree_to_np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _same_leaves(got, want, path=""):
    """The port's tensor tree against JAX's array tree: the same keys, and the
    same values (floats compared after the port's cast to its f32 compute
    dtype; integer leaves exact, with their dtype)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _same_leaves(got[k], want[k], f"{path}/{k}")
        return
    g, w = got.detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape, path
    if np.issubdtype(w.dtype, np.floating):
        assert g.dtype == np.float32, path
        np.testing.assert_array_equal(g, w.astype(np.float32), err_msg=path)
    else:
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _tokens_identical(jmodel, tmodel, loaded, batch):
    """Greedy tokens of the port model (its loaded subtrees, JAX's random
    others) against the JAX model's."""
    for sub in loaded:
        _same_leaves(tmodel.params[sub], jmodel.params[sub], sub)
    params = {k: v if k in loaded else params_from_numpy(_np(jmodel.params[k]), device="cpu")
              for k, v in tmodel.params.items()}
    gen_kw = dict(max_new_tokens=8, eos_token_id=2, pad_token_id=0)
    want = np.asarray(jax.jit(functools.partial(
        jengine.salmonn_generate, jmodel.cfg, jengine.GenerationConfig(**gen_kw)))(
        jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tengine.salmonn_generate(
        tmodel.cfg, tengine.GenerationConfig(**gen_kw), params,
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


# -- converted LLM dirs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_shards(tmp_path_factory):
    """HF shards of the tiny decoder (two files and an index) with distinct
    random values: ``synth_ckpt``'s tiled blocks repeat lm_head rows, whose
    tied logits would make greedy picks hang on rounding."""
    from safetensors.numpy import save_file

    cfg = jllama.DECODER_CONFIGS["tiny"]
    rng = np.random.RandomState(11)
    hd = cfg.hd
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, cfg.dim),
              "lm_head.weight": (cfg.vocab_size, cfg.dim)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (cfg.n_heads * hd, cfg.dim),
                       p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, cfg.dim),
                       p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, cfg.dim),
                       p + "self_attn.o_proj.weight": (cfg.dim, cfg.n_heads * hd),
                       p + "mlp.gate_proj.weight": (cfg.hidden_dim, cfg.dim),
                       p + "mlp.up_proj.weight": (cfg.hidden_dim, cfg.dim),
                       p + "mlp.down_proj.weight": (cfg.dim, cfg.hidden_dim)})
    sd = {k: (rng.randn(*s) * 0.05).astype(np.float16) for k, s in shapes.items()}
    for name in ["model.norm.weight"] + [f"model.layers.{i}.{n}_layernorm.weight"
                                         for i in range(cfg.n_layers)
                                         for n in ("input", "post_attention")]:
        sd[name] = (1 + 0.1 * rng.randn(cfg.dim)).astype(np.float16)
    path = str(tmp_path_factory.mktemp("hf") / "tiny")
    os.makedirs(path)
    keys = sorted(sd)
    files = {"model-00001-of-00002.safetensors": keys[::2],
             "model-00002-of-00002.safetensors": keys[1::2]}
    for fn, ks in files.items():
        save_file({k: sd[k] for k in ks}, os.path.join(path, fn))
    with open(os.path.join(path, jstream.INDEX_NAME), "w") as f:
        json.dump({"weight_map": {k: fn for fn, ks in files.items() for k in ks}}, f)
    return path


def _jax_dir(tiny_shards, root, quantize, dtype):
    dst = str(root / f"llm_{quantize}_{dtype}")
    jstream.stream_decoder_to_dir(jstream.TensorSource(tiny_shards),
                                  jllama.DECODER_CONFIGS["tiny"], dst, quantize=quantize,
                                  dtype=dtype)
    return dst


@pytest.mark.parametrize("quantize,dtype", [(False, "float32"), (False, "float16"),
                                            ("int8", "float32"), ("int4", "float32")])
def test_llm_params_dir_loads_as_in_jax_and_generates_the_same_tokens(
        tmp_path, tiny_shards, batch, quantize, dtype):
    dst = _jax_dir(tiny_shards, tmp_path, quantize, dtype)
    jmodel = jfactory.create_model("salmonn-tiny", llm_params_dir=dst)
    tmodel = tfactory.create_model("salmonn-tiny", llm_params_dir=dst, device="cpu")
    wq = tmodel.params["llm"]["layers"]["attn"]["wq"]
    # tiny widths take int8 where int4 is asked (as in JAX); scales stay f32
    assert isinstance(wq, dict) == bool(quantize)
    if quantize:
        assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    assert tmodel.engine.params is tmodel.params
    _tokens_identical(jmodel, tmodel, LOADED["llm"], batch)


def test_init_salmonn_skip_llm_leaves_the_other_draws_unchanged():
    cfg = tsalmonn.salmonn_tiny()
    full = tsalmonn.init_salmonn(cfg, torch.Generator().manual_seed(5), "cpu")
    lean = tsalmonn.init_salmonn(cfg, torch.Generator().manual_seed(5), "cpu", skip_llm=True)
    assert set(full) - set(lean) == {"llm"}
    for sub in lean:
        for a, b in zip(jax.tree_util.tree_leaves(_tensor_tree_to_np(lean[sub])),
                        jax.tree_util.tree_leaves(_tensor_tree_to_np(full[sub]))):
            np.testing.assert_array_equal(a, b)


def test_create_model_with_a_converted_llm_keeps_the_seeds_other_weights(tmp_path,
                                                                         tiny_shards):
    dst = _jax_dir(tiny_shards, tmp_path, "int8", "float32")
    loaded = tfactory.create_model("salmonn-tiny", seed=9, llm_params_dir=dst, device="cpu")
    drawn = tfactory.create_model("salmonn-tiny", seed=9, device="cpu")
    assert set(loaded.params) == set(drawn.params)
    for sub in set(drawn.params) - {"llm"}:
        for a, b in zip(jax.tree_util.tree_leaves(_tensor_tree_to_np(loaded.params[sub])),
                        jax.tree_util.tree_leaves(_tensor_tree_to_np(drawn.params[sub]))):
            np.testing.assert_array_equal(a, b)


def _cli_argv(tmp_path, *extra):
    return ["--model_type", "salmonn-tiny", "--dataset_type", "voxceleb", "--synthetic",
            "--synthetic_size", "8", "--fewshot_mode", "speech", "--num_examples", "1",
            "--batch_size", "2", "--max_samples", "2", "--seq_len", "512",
            "--text_len", "256", "--max_new_tokens", "3", "--results_dir", str(tmp_path),
            *extra]


def test_cli_refuses_a_dir_of_another_width_as_jax_does(tmp_path, tiny_shards, monkeypatch):
    int8_dir = _jax_dir(tiny_shards, tmp_path, "int8", "float32")
    with pytest.raises(SystemExit, match="already int8-quantized"):
        jcli_inference.main(_cli_argv(tmp_path / "j", "--llm_params_dir", int8_dir,
                                      "--quantize_int4"))
    with pytest.raises(SystemExit, match="already int8-quantized"):
        tcli_inference.main(_cli_argv(tmp_path / "t", "--llm_params_dir", int8_dir,
                                      "--quantize_int4", "--device", "cpu"))
    # an int4 dir with --quantize_int8 (tiny widths give no int4 dir; the
    # check reads the tree)
    int4_model = types.SimpleNamespace(params={"llm": {"layers": {"attn": {
        "wq": {"q4": torch.zeros(1, 64, 8, dtype=torch.uint8), "s": torch.ones(1, 1, 8)}}}}})
    with pytest.raises(SystemExit, match="already int4-quantized"):
        tcli_inference._quantize(int4_model, 8)
    # at the asked width the dir runs as it is, not quantized again
    models = []
    monkeypatch.setattr(tcli_inference, "create_model",
                        lambda *a, **kw: models.append(tfactory.create_model(*a, **kw))
                        or models[-1])
    paths = tcli_inference.main(_cli_argv(tmp_path / "t", "--llm_params_dir", int8_dir,
                                          "--quantize_int8", "--device", "cpu"))
    (model,) = models
    want = np.load(os.path.join(int8_dir, "layers.attn.wq.q.npy"))
    np.testing.assert_array_equal(model.params["llm"]["layers"]["attn"]["wq"]["q"].numpy(), want)
    results = json.load(open(paths["results"]))["results"]
    assert len(results) == 2 and all(len(r["tokens"]) == 3 for r in results)


# -- adapters and checkpoints ------------------------------------------------------------

def _adapter_qformer(module):
    cfg = tsalmonn.salmonn_tiny().qformer
    return module.QFormerConfig(encoder_width=cfg.encoder_width, dim=cfg.dim,
                                n_heads=cfg.n_heads, n_layers=cfg.n_layers, llm_dim=cfg.llm_dim)


def _convert_adapter(tmp_path, monkeypatch, name, qf):
    cfg = jsalmonn.salmonn_tiny()
    monkeypatch.setitem(jqformer.QFORMER_CONFIGS, name, qf)
    pth = str(tmp_path / f"{name}.pth")
    jsynth.write_salmonn_v1(pth, qf, cfg.llm, whisper_dim=cfg.whisper.dim,
                            beats_dim=cfg.beats.dim, rank=cfg.lora.rank, peft_default=True,
                            seed=4)
    dst = str(tmp_path / name)
    jcli_convert.main(["--src", pth, "--dst", dst, "--component", "salmonn",
                       "--model_type", "tiny", "--qformer_config", name])
    return dst


def test_adapter_params_dir_loads_as_in_jax_and_generates_the_same_tokens(
        tmp_path, monkeypatch, batch):
    dst = _convert_adapter(tmp_path, monkeypatch, "tiny-adapter", _adapter_qformer(jqformer))
    jmodel = jfactory.create_model("salmonn-tiny", adapter_params_dir=dst)
    tmodel = tfactory.create_model("salmonn-tiny", adapter_params_dir=dst, device="cpu")
    _tokens_identical(jmodel, tmodel, LOADED["adapter"], batch)


def test_a_wrong_shape_adapter_raises_as_in_jax(tmp_path, monkeypatch):
    good = _adapter_qformer(jqformer)
    bad = dataclasses.replace(good, dim=good.dim * 2)
    dst = _convert_adapter(tmp_path, monkeypatch, "bad-adapter", bad)
    with pytest.raises(ValueError, match="does not match") as jerr:
        jfactory.create_model("salmonn-tiny", adapter_params_dir=dst)
    with pytest.raises(ValueError, match="does not match") as terr:
        tfactory.create_model("salmonn-tiny", adapter_params_dir=dst, device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A trainable-only checkpoint that the JAX package wrote as ``state.npy``
    (its fallback format: the port has no orbax), with a non-zero LoRA B."""
    path = str(tmp_path_factory.mktemp("ckpt") / "epoch_0_loss_1.0")
    trainable = _np({k: v for k, v in jsalmonn.init_salmonn(
        jax.random.PRNGKey(8), jsalmonn.salmonn_tiny()).items() if k in ("lora", "qformer")})
    rng = np.random.RandomState(8)
    for name in trainable["lora"]:
        b = trainable["lora"][name]["b"]
        trainable["lora"][name]["b"] = (rng.randn(*b.shape) * 0.05).astype(np.float32)
    have = jckpt._HAVE_ORBAX
    jckpt._HAVE_ORBAX = False
    try:
        jckpt.save_checkpoint(path, trainable, step=3, epoch=0, loss=1.0)
    finally:
        jckpt._HAVE_ORBAX = have
    assert os.path.exists(os.path.join(path, "state.npy"))
    return path


def test_peft_checkpoint_loads_as_in_jax_and_generates_the_same_tokens(jax_checkpoint, batch):
    jmodel = jfactory.get_model_from_checkpoint(jax_checkpoint, "salmonn-tiny")
    tmodel = tfactory.get_model_from_checkpoint(jax_checkpoint, "salmonn-tiny", device="cpu")
    assert tmodel.engine.params is tmodel.params
    _tokens_identical(jmodel, tmodel, LOADED["peft"], batch)
    # the checkpoint's subtrees keep the dtype of those they replace
    bf16 = tfactory.get_model_from_checkpoint(jax_checkpoint, "salmonn-tiny", device="cpu",
                                              trainable_dtype=torch.bfloat16)
    assert bf16.params["lora"]["wq"]["b"].dtype == torch.bfloat16


def test_cli_peft_model_path_with_a_converted_llm_and_adapter(tmp_path, monkeypatch,
                                                              tiny_shards, jax_checkpoint):
    """``--peft_model_path`` over ``--llm_params_dir`` and
    ``--adapter_params_dir`` in the port's CLI, as JAX's CLI routes it: the
    checkpoint's trainable subtrees win over the adapter's."""
    llm_dir = _jax_dir(tiny_shards, tmp_path, "int8", "float32")
    adapter = _convert_adapter(tmp_path, monkeypatch, "tiny-adapter", _adapter_qformer(jqformer))
    models = []
    monkeypatch.setattr(tfactory, "create_model",
                        functools.partial(lambda f, *a, **kw: models.append(f(*a, **kw))
                                          or models[-1], tfactory.create_model))
    tcli_inference.main(_cli_argv(tmp_path, "--llm_params_dir", llm_dir,
                                  "--adapter_params_dir", adapter,
                                  "--peft_model_path", jax_checkpoint, "--device", "cpu"))
    (model,) = models
    state = np.load(os.path.join(jax_checkpoint, "state.npy"), allow_pickle=True).item()
    np.testing.assert_array_equal(model.params["lora"]["wq"]["b"].numpy(),
                                  state["trainable"]["lora"]["wq"]["b"])
    np.testing.assert_array_equal(model.params["llm"]["layers"]["attn"]["wq"]["q"].numpy(),
                                  np.load(os.path.join(llm_dir, "layers.attn.wq.q.npy")))


# -- encode_chunk and the SalmonnModel surface -------------------------------------------

@pytest.fixture(scope="module")
def jax_tiny():
    return jfactory.create_model("salmonn-tiny", seed=0, pack_cfg=_pack(JPackConfig))


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    """The port's SalmonnModel holding the JAX model's weights."""
    model = tfactory.create_model("salmonn-tiny", pack_cfg=_pack(PackConfig), device="cpu")
    model.params = params_from_numpy(_np(jax_tiny.params), device="cpu")
    model.engine.params = model.params
    return model


def test_encode_chunk_matches_jax_and_no_chunks(jax_tiny, port_tiny):
    rng = np.random.RandomState(2)
    wavs = (rng.randn(4, 16000) * 0.1).astype(np.float32)
    jwavs = jpad_or_trim(jnp.asarray(wavs))
    mels = np.asarray(jlog_mel(jwavs))
    jcfg = dataclasses.replace(jax_tiny.cfg, encode_chunk=2)
    want = np.asarray(jsalmonn.encode_speech(jcfg, jax_tiny.params, jnp.asarray(mels), jwavs))
    tm, tw = torch.from_numpy(mels.copy()), torch.from_numpy(np.array(jwavs))
    outs = {}
    for c in (0, 2, 3):  # 3 does not divide 4 clips: no chunks
        cfg = dataclasses.replace(port_tiny.cfg, encode_chunk=c)
        outs[c] = tsalmonn.encode_speech(cfg, port_tiny.params, tm, tw).numpy()
    np.testing.assert_allclose(outs[2], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(outs[3], outs[0])
    # the training loss's frozen half, the encoders alone, chunks the same way
    feats = [tsalmonn.encoder_features(dataclasses.replace(port_tiny.cfg, encode_chunk=c),
                                       port_tiny.params, tm, tw).numpy() for c in (0, 2)]
    np.testing.assert_allclose(feats[1], feats[0], rtol=1e-5, atol=1e-5)


def _samples(n=2):
    tds, jds = _dataset(tdata, tregistry), _dataset(jdata, jregistry)
    return [tds[i] for i in range(n)], [jds[i] for i in range(n)]


def test_salmonn_model_surface_matches_jax(jax_tiny, port_tiny):
    assert isinstance(port_tiny, BaseModel)
    tsamples, jsamples = _samples()
    got = port_tiny.forward(tsamples)["loss"].item()
    want = float(jax_tiny.forward(jsamples)["loss"])
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    assert port_tiny.generate_output(tsamples) == jax_tiny.generate_output(jsamples)
    wavs = (np.random.RandomState(3).randn(2, 16000) * 0.1).astype(np.float32)
    np.testing.assert_allclose(port_tiny.get_speech_embeddings(wavs).numpy(),
                               np.asarray(jax_tiny.get_speech_embeddings(wavs)),
                               rtol=1e-5, atol=1e-5)


def test_from_config_builds_through_the_factory():
    model = BaseModel.from_config({"model_type": "salmonn-tiny", "device": "cpu", "seed": 1})
    assert isinstance(model, tfactory.SalmonnModel)
    again = tfactory.from_config({"model_type": "salmonn-tiny", "device": "cpu", "seed": 1})
    np.testing.assert_array_equal(model.params["lora"]["wq"]["a"].numpy(),
                                  again.params["lora"]["wq"]["a"].numpy())
    with pytest.raises(NotImplementedError):
        tfactory.create_model("qwen2-audio", device="cpu")
