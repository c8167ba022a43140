"""The port's checkpoint readers, writers and converters against the JAX
package's and the ``safetensors`` package's, on the CPU.

- ``utils/safetensors_np.py`` against ``safetensors.numpy``: every dtype
  either one reads, both directions, single files and index dirs; the dtypes
  ``safetensors.numpy`` refuses are refused; malformed headers raise.
- ``stream_decoder_to_dir`` and ``cli/convert.py``: the port's dir and JAX's
  from the same source hold the same manifest and byte-identical ``.npy``
  files, at f32, f16, int8 and int4 (a 256-wide decoder, so that int4 emits
  ``{q4, s}``), with a QKV bias, from an index dir, an un-indexed dir, a
  single file and a torch ``.pth``; the salmonn adapter component too.
- The in-memory converters leaf for leaf, and ``synth_ckpt``'s writers.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file

from icl_speech_text_llm_tpu.cli import convert as jcli_convert
from icl_speech_text_llm_tpu.models import convert as jconvert
from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qformer as jqformer
from icl_speech_text_llm_tpu.models import stream_convert as jstream
from icl_speech_text_llm_tpu.models import synth_ckpt as jsynth
from icl_speech_text_llm_tpu.models.beats import BEATS_CONFIGS as J_BEATS_CONFIGS
from icl_speech_text_llm_tpu.models.whisper import WhisperEncoderConfig as JWhisperConfig
from icl_speech_text_llm_tpu_torch.cli import convert as tcli_convert
from icl_speech_text_llm_tpu_torch.models import convert as tconvert
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.models import qformer as tqformer
from icl_speech_text_llm_tpu_torch.models import stream_convert as tstream
from icl_speech_text_llm_tpu_torch.models import synth_ckpt as tsynth
from icl_speech_text_llm_tpu_torch.models.beats import BEATS_CONFIGS as T_BEATS_CONFIGS
from icl_speech_text_llm_tpu_torch.models.whisper import WhisperEncoderConfig as TWhisperConfig
from icl_speech_text_llm_tpu_torch.utils import safetensors_np

torch.set_num_threads(1)

#: dtypes ``safetensors.numpy`` reads, as numpy arrays
READ_DTYPES = [np.float64, np.float32, np.float16, np.int64, np.uint64, np.int32, np.uint32,
               np.int16, np.uint16, np.int8, np.uint8, np.bool_, np.complex64]

# a decoder wide enough that int4 emits {q4, s} (every input dim's half a
# multiple of 128); "tiny" dims fall back to int8
WIDE = dict(vocab_size=320, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512)


def _cfgs(**kw):
    args = {**WIDE, **kw}
    return jllama.DecoderConfig(**args), tllama.DecoderConfig(**args)


def _array(dtype, shape, rng):
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        x = rng.rand(*shape) < 0.5
    elif dtype.kind == "c":
        x = rng.randn(*shape) + 1j * rng.randn(*shape)
    elif dtype.kind in "iu":
        info = np.iinfo(dtype)
        x = rng.randint(max(info.min, -1000), min(info.max, 1000), size=shape)
    else:
        x = rng.randn(*shape)
    return np.asarray(x).astype(dtype)


def _leaves_equal(got, want, path=""):
    """Two nested dicts of arrays: the same keys, dtypes, shapes and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _dirs_identical(a, b):
    """Two converted dirs: manifest.json equal and every file byte-identical."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(b, "manifest.json")) as f:
        assert json.load(f) == manifest
    for fn in os.listdir(a):
        with open(os.path.join(a, fn), "rb") as fa, open(os.path.join(b, fn), "rb") as fb:
            assert fa.read() == fb.read(), fn
    return manifest


# -- safetensors ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", READ_DTYPES, ids=lambda d: np.dtype(d).name)
def test_safetensors_reader_and_writer_match_the_library_per_dtype(tmp_path, dtype):
    rng = np.random.RandomState(0)
    tensors = {"a": _array(dtype, (3, 5), rng), "b": _array(dtype, (7,), rng),
               "scalar": _array(dtype, (), rng), "empty": _array(dtype, (0, 4), rng),
               "c.d": _array(dtype, (2, 3, 4), rng)}
    theirs = str(tmp_path / "theirs.safetensors")
    st_save_file(tensors, theirs, metadata={"format": "np"})
    got, want = safetensors_np.load_file(theirs), st_load_file(theirs)
    _leaves_equal(got, want)
    with safetensors_np.SafetensorsFile(theirs) as f:
        assert f.metadata() == {"format": "np"}
        with safe_open(theirs, framework="numpy") as g:
            assert f.keys() == g.keys()

    mine = str(tmp_path / "mine.safetensors")
    safetensors_np.save_file(tensors, mine, metadata={"format": "np"})
    with safe_open(mine, framework="numpy") as g:
        assert g.metadata() == {"format": "np"} and sorted(g.keys()) == sorted(tensors)
        _leaves_equal({k: g.get_tensor(k) for k in g.keys()}, tensors)
    # a transposed (non-contiguous) and a big-endian input are written as their values
    odd = {"t": tensors["a"].T, "be": tensors["a"].astype(np.dtype(dtype).newbyteorder(">"))}
    safetensors_np.save_file(odd, mine)
    _leaves_equal(st_load_file(mine), {"t": np.ascontiguousarray(tensors["a"].T),
                                       "be": tensors["a"]})


def _read_or_error(load, path):
    try:
        return load(path), None
    except (TypeError, AttributeError) as e:
        return None, e


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2])
def test_safetensors_reader_reads_and_refuses_what_the_library_does(tmp_path, dtype):
    """BF16 reads where numpy knows bfloat16 (here: ml_dtypes, loaded with
    jax), the F8 types never; a refused tensor leaves the file's others
    readable."""
    from safetensors.torch import save_file as torch_save_file

    path = str(tmp_path / "x.safetensors")
    torch_save_file({"x": torch.linspace(-2, 2, 4).to(dtype), "y": torch.arange(3.0)}, path)
    want, want_err = _read_or_error(st_load_file, path)
    got, got_err = _read_or_error(safetensors_np.load_file, path)
    assert (got_err is None) == (want_err is None), (got_err, want_err)
    if want is not None:
        _leaves_equal(got, want)
        assert dtype == torch.bfloat16
        src = tstream.TensorSource(path)
        _leaves_equal(src.get("x"), jstream.TensorSource(path).get("x"))
        assert src.get("x").dtype == np.float32
    with safetensors_np.SafetensorsFile(path) as f:
        assert f.keys() == ["x", "y"]
        np.testing.assert_array_equal(f.get_tensor("y"), np.arange(3.0, dtype=np.float32))
        if want is None:
            with pytest.raises(TypeError, match="numpy"):
                f.get_tensor("x")


def test_safetensors_reader_refuses_bf16_where_numpy_has_no_bfloat16():
    """In a process without ml_dtypes (as on a machine without jax) both the
    library and the port refuse BF16."""
    child = (
        "import sys, torch, numpy as np\n"
        "from safetensors.torch import save_file\n"
        "from safetensors.numpy import load_file\n"
        "from icl_speech_text_llm_tpu_torch.utils import safetensors_np\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "p = sys.argv[1]\n"
        "save_file({'x': torch.ones(2, dtype=torch.bfloat16)}, p)\n"
        "for load in (load_file, safetensors_np.load_file):\n"
        "    try:\n"
        "        load(p)\n"
        "    except TypeError:\n"
        "        continue\n"
        "    raise SystemExit(f'{load.__module__} read BF16')\n"
        "print('refused')\n")
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([sys.executable, "-c", child, os.path.join(d, "x.safetensors")],
                             cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                             capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "refused", out.stderr[-2000:]


@pytest.mark.parametrize("case", ["short", "header_past_end", "hole", "wrong_size",
                                  "buffer_longer", "unknown_dtype"])
def test_safetensors_reader_refuses_malformed_files(tmp_path, case):
    path = str(tmp_path / "x.safetensors")
    st_save_file({"a": np.arange(4, dtype=np.float32), "b": np.arange(2, dtype=np.int8)}, path)
    raw = bytearray(open(path, "rb").read())
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])

    def rewrite(h, buf):
        blob = json.dumps(h).encode()
        return struct.pack("<Q", len(blob)) + blob + buf

    buf = bytes(raw[8 + n:])
    if case == "short":
        raw = raw[:5]
    elif case == "header_past_end":
        raw[:8] = struct.pack("<Q", len(raw))
    elif case == "hole":
        header["b"]["data_offsets"] = [17, 19]
        raw = rewrite(header, buf + b"\0")
    elif case == "wrong_size":
        header["a"]["shape"] = [5]
        raw = rewrite(header, buf)
    elif case == "buffer_longer":
        raw = rewrite(header, buf + b"\0" * 8)
    else:
        header["a"]["dtype"] = "F7"
        raw = rewrite(header, buf)
    open(path, "wb").write(bytes(raw))
    with pytest.raises(Exception):
        safe_open(path, framework="numpy").keys()
    with pytest.raises(ValueError):
        safetensors_np.SafetensorsFile(path)


# -- synthetic checkpoints --------------------------------------------------------

@pytest.fixture(scope="module")
def wide_shards(tmp_path_factory):
    """HF shards of the wide decoder written by JAX's writer (through the
    safetensors library) and by the port's (through its numpy writer), in
    three shards each; the same tensors and index."""
    root = tmp_path_factory.mktemp("shards")
    jcfg, tcfg = _cfgs()
    jdir, tdir = str(root / "jax"), str(root / "port")
    shard_bytes = 200_000
    want = jsynth.write_hf_decoder_shards(jdir, jcfg, seed=3, shard_bytes=shard_bytes)
    got = tsynth.write_hf_decoder_shards(tdir, tcfg, seed=3, shard_bytes=shard_bytes)
    return jdir, tdir, got, want


def test_write_hf_decoder_shards_matches_jax(wide_shards):
    jdir, tdir, got, want = wide_shards
    assert got == want
    index = tstream.INDEX_NAME
    with open(os.path.join(jdir, index)) as f, open(os.path.join(tdir, index)) as g:
        jindex, tindex = json.load(f), json.load(g)
    assert jindex == tindex and len(set(tindex["weight_map"].values())) >= 3
    for fn in sorted(set(tindex["weight_map"].values())):
        with safe_open(os.path.join(tdir, fn), framework="numpy") as g:
            _leaves_equal({k: g.get_tensor(k) for k in g.keys()},
                          st_load_file(os.path.join(jdir, fn)))


@pytest.mark.parametrize("peft_default", [False, True])
def test_salmonn_v1_state_dict_matches_jax(peft_default):
    jcfg = jllama.DECODER_CONFIGS["tiny"]
    tcfg = tllama.DECODER_CONFIGS["tiny"]
    jqf = jqformer.QFORMER_CONFIGS["tiny-test"]
    tqf = tqformer.QFORMER_CONFIGS["tiny-test"]
    want = jsynth.salmonn_v1_state_dict(jqf, jcfg, 64, 32, rank=4, seed=2,
                                        peft_default=peft_default)
    got = tsynth.salmonn_v1_state_dict(tqf, tcfg, 64, 32, rank=4, seed=2,
                                       peft_default=peft_default)
    _leaves_equal(got, want)
    with pytest.raises(ValueError, match="encoder_width"):
        tsynth.salmonn_v1_state_dict(tqf, tcfg, 64, 64)


# -- streamed decoder dirs --------------------------------------------------------

@pytest.mark.parametrize("quantize,dtype", [(False, "float32"), (False, "float16"),
                                            ("int8", "float32"), ("int4", "float32")])
def test_stream_decoder_to_dir_is_byte_identical_to_jax(tmp_path, wide_shards, quantize, dtype):
    jdir, tdir, _, _ = wide_shards
    jcfg, tcfg = _cfgs()
    want = jstream.stream_decoder_to_dir(jstream.TensorSource(jdir), jcfg, str(tmp_path / "j"),
                                         quantize=quantize, dtype=dtype)
    got = tstream.stream_decoder_to_dir(tstream.TensorSource(tdir), tcfg, str(tmp_path / "t"),
                                        quantize=quantize, dtype=dtype)
    assert got == want
    manifest = _dirs_identical(str(tmp_path / "j"), str(tmp_path / "t"))
    if quantize == "int4":
        assert {"layers/attn/wq/q4", "layers/mlp/w_down/q4", "lm_head/q"} <= set(manifest)
    # the dir loads back to the same tree in both packages
    _leaves_equal(tstream.load_params_dir(str(tmp_path / "t")),
                  jstream.load_params_dir(str(tmp_path / "j")))
    assert dict(tstream.iter_params_dir(str(tmp_path / "t"))).keys() == manifest.keys()


def _hf_decoder_sd(cfg, seed=0, qkv_bias=False):
    """A float32 HF decoder state dict (the JAX package's test layout)."""
    rng = np.random.RandomState(seed)
    hd = cfg.hd
    sd = {"model.embed_tokens.weight": rng.randn(cfg.vocab_size, cfg.dim),
          "model.norm.weight": rng.randn(cfg.dim),
          "lm_head.weight": rng.randn(cfg.vocab_size, cfg.dim)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "self_attn.q_proj.weight"] = rng.randn(cfg.n_heads * hd, cfg.dim)
        sd[p + "self_attn.k_proj.weight"] = rng.randn(cfg.n_kv_heads * hd, cfg.dim)
        sd[p + "self_attn.v_proj.weight"] = rng.randn(cfg.n_kv_heads * hd, cfg.dim)
        sd[p + "self_attn.o_proj.weight"] = rng.randn(cfg.dim, cfg.n_heads * hd)
        sd[p + "mlp.gate_proj.weight"] = rng.randn(cfg.hidden_dim, cfg.dim)
        sd[p + "mlp.up_proj.weight"] = rng.randn(cfg.hidden_dim, cfg.dim)
        sd[p + "mlp.down_proj.weight"] = rng.randn(cfg.dim, cfg.hidden_dim)
        sd[p + "input_layernorm.weight"] = rng.randn(cfg.dim)
        sd[p + "post_attention_layernorm.weight"] = rng.randn(cfg.dim)
        if qkv_bias:
            sd[p + "self_attn.q_proj.bias"] = rng.randn(cfg.n_heads * hd)
            sd[p + "self_attn.k_proj.bias"] = rng.randn(cfg.n_kv_heads * hd)
            sd[p + "self_attn.v_proj.bias"] = rng.randn(cfg.n_kv_heads * hd)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("source", ["single_file", "unindexed_dir", "torch_pth",
                                    "torch_pth_wrapped", "qkv_bias_index_dir"])
@pytest.mark.parametrize("quantize", [False, "int4"])
def test_stream_decoder_sources_match_jax(tmp_path, source, quantize):
    qkv_bias = source.startswith("qkv_bias")
    jcfg, tcfg = _cfgs(qkv_bias=qkv_bias, tie_embeddings=False)
    sd = _hf_decoder_sd(jcfg, seed=5, qkv_bias=qkv_bias)
    if source == "single_file":
        src = str(tmp_path / "model.safetensors")
        st_save_file(sd, src)
    elif source in ("unindexed_dir", "qkv_bias_index_dir"):
        src = str(tmp_path / "hf")
        os.makedirs(src)
        keys = sorted(sd)
        parts = {"a.safetensors": keys[::2], "b.safetensors": keys[1::2]}
        for fn, ks in parts.items():
            st_save_file({k: sd[k] for k in ks}, os.path.join(src, fn))
        if source == "qkv_bias_index_dir":
            with open(os.path.join(src, tstream.INDEX_NAME), "w") as f:
                json.dump({"weight_map": {k: fn for fn, ks in parts.items() for k in ks}}, f)
    else:
        src = str(tmp_path / "model.pth")
        tsd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
        torch.save({"state_dict": tsd} if source == "torch_pth_wrapped" else tsd, src)
    jsrc, tsrc = jstream.TensorSource(src), tstream.TensorSource(src)
    assert sorted(tsrc.keys()) == sorted(jsrc.keys()) == sorted(sd)
    for k in ("model.norm.weight", "lm_head.weight"):
        _leaves_equal(tsrc.get(k), jsrc.get(k))
    jstream.stream_decoder_to_dir(jsrc, jcfg, str(tmp_path / "j"), quantize=quantize)
    tstream.stream_decoder_to_dir(tsrc, tcfg, str(tmp_path / "t"), quantize=quantize)
    manifest = _dirs_identical(str(tmp_path / "j"), str(tmp_path / "t"))
    assert ("layers/attn/bq" in manifest) == qkv_bias


def test_stream_decoder_missing_weight_raises_as_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    sd = _hf_decoder_sd(jcfg)
    del sd["lm_head.weight"]
    src = str(tmp_path / "model.safetensors")
    st_save_file(sd, src)
    for stream, cfg, dst in ((jstream, jcfg, "j"), (tstream, tcfg, "t")):
        with pytest.raises(KeyError, match="lm_head.weight"):
            stream.stream_decoder_to_dir(stream.TensorSource(src), cfg, str(tmp_path / dst))


# -- the convert CLI ----------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--quantize_int8"], ["--quantize_int4"],
                                   ["--dtype", "float16"]])
def test_convert_cli_decoder_matches_jax(tmp_path, wide_shards, monkeypatch, capsys, flags):
    jdir, tdir, _, _ = wide_shards
    jcfg, tcfg = _cfgs()
    monkeypatch.setitem(jllama.DECODER_CONFIGS, "wide-test", jcfg)
    monkeypatch.setitem(tllama.DECODER_CONFIGS, "wide-test", tcfg)
    printed = []
    for cli, src, dst in ((jcli_convert, jdir, "j"), (tcli_convert, tdir, "t")):
        cli.main(["--src", src, "--dst", str(tmp_path / dst), "--model_type", "wide-test",
                  *flags])
        printed.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert {k: v for k, v in printed[0].items() if k != "dst"} == \
        {k: v for k, v in printed[1].items() if k != "dst"}
    assert printed[1]["dst"] == str(tmp_path / "t")
    _dirs_identical(str(tmp_path / "j"), str(tmp_path / "t"))


@pytest.mark.parametrize("wrapper,peft_default", [("model", False), ("model", True),
                                                  ("state_dict", True),
                                                  ("model_state_dict", False),
                                                  ("ckpt", True), ("", False)])
def test_convert_cli_salmonn_adapter_matches_jax(tmp_path, monkeypatch, capsys, wrapper,
                                                 peft_default):
    jcfg, tcfg = jllama.DECODER_CONFIGS["tiny"], tllama.DECODER_CONFIGS["tiny"]
    jqf = jqformer.QFormerConfig(encoder_width=128, dim=32, n_heads=4, n_layers=2,
                                 llm_dim=128)
    tqf = tqformer.QFormerConfig(encoder_width=128, dim=32, n_heads=4, n_layers=2,
                                 llm_dim=128)
    monkeypatch.setitem(jqformer.QFORMER_CONFIGS, "tiny-adapter", jqf)
    monkeypatch.setitem(tqformer.QFORMER_CONFIGS, "tiny-adapter", tqf)
    pth = str(tmp_path / "salmonn_v1.pth")
    n = tsynth.write_salmonn_v1(pth, tqf, tcfg, whisper_dim=64, beats_dim=64, rank=4,
                                peft_default=peft_default, wrapper=wrapper)
    assert n == len(jsynth.salmonn_v1_state_dict(jqf, jcfg, 64, 64, rank=4))
    # the port's and JAX's loaders and in-memory converters agree leaf for leaf
    tsd, jsd = tconvert.load_torch_state_dict(pth), jconvert.load_torch_state_dict(pth)
    _leaves_equal(tsd, jsd)
    tree = tconvert.convert_salmonn_checkpoint(tsd, tqf, tcfg)
    _leaves_equal(tree, jconvert.convert_salmonn_checkpoint(jsd, jqf, jcfg))
    assert set(tree) == {"qformer", "lora"} and set(tree["lora"]) == {"wq", "wv"}
    printed = []
    for cli, dst in ((jcli_convert, "j"), (tcli_convert, "t")):
        cli.main(["--src", pth, "--dst", str(tmp_path / dst), "--component", "salmonn",
                  "--model_type", "tiny", "--qformer_config", "tiny-adapter"])
        printed.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert printed[0]["tensors"] == printed[1]["tensors"] > 20
    _dirs_identical(str(tmp_path / "j"), str(tmp_path / "t"))


# -- in-memory converters -------------------------------------------------------------

def _rand_sd(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("nesting", ["", "base_model.model.", "base_model.model.base_model.model."])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_convert_hf_decoder_matches_jax(nesting, qkv_bias):
    jcfg, tcfg = _cfgs(qkv_bias=qkv_bias)
    sd = _hf_decoder_sd(jcfg, seed=1, qkv_bias=qkv_bias)
    sd = {(nesting + k if k != "lm_head.weight" else k): v for k, v in sd.items()}
    got = tconvert.convert_hf_decoder(sd, tcfg)
    _leaves_equal(got, jconvert.convert_hf_decoder(sd, jcfg))
    assert got["layers"]["attn"]["wq"].shape == (2, 256, 256)


@pytest.mark.parametrize("prefix", ["model.encoder.", "encoder.", ""])
def test_convert_hf_whisper_encoder_matches_jax(prefix):
    d, L, ff = 16, 2, 32
    shapes = {"conv1.weight": (d, 80, 3), "conv1.bias": (d,), "conv2.weight": (d, d, 3),
              "conv2.bias": (d,), "embed_positions.weight": (1500, d),
              "layer_norm.weight": (d,), "layer_norm.bias": (d,)}
    for i in range(L):
        p = f"layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[p + f"self_attn.{name}.weight"] = (d, d)
            if name != "k_proj":
                shapes[p + f"self_attn.{name}.bias"] = (d,)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[p + f"{ln}.weight"] = (d,)
            shapes[p + f"{ln}.bias"] = (d,)
        shapes.update({p + "fc1.weight": (ff, d), p + "fc1.bias": (ff,),
                       p + "fc2.weight": (d, ff), p + "fc2.bias": (d,)})
    sd = {prefix + k: v for k, v in _rand_sd(shapes, 4).items()}
    got = tconvert.convert_hf_whisper_encoder(sd, TWhisperConfig(dim=d, n_heads=4, n_layers=L))
    _leaves_equal(got, jconvert.convert_hf_whisper_encoder(
        sd, JWhisperConfig(dim=d, n_heads=4, n_layers=L)))
    assert got["conv1"]["w"].shape == (3, 80, d)


@pytest.mark.parametrize("nested", [False, True])
def test_convert_beats_matches_jax(nested):
    tcfg, jcfg = T_BEATS_CONFIGS["tiny-test"], J_BEATS_CONFIGS["tiny-test"]
    assert tcfg.gated_rel_pos and jcfg.gated_rel_pos
    d, e, H = tcfg.dim, tcfg.embed_dim, tcfg.n_heads
    inner = tcfg.mlp_ratio * d
    cg = d // tcfg.conv_pos_groups
    shapes = {"patch_embedding.weight": (e, 1, tcfg.patch, tcfg.patch),
              "patch_embedding.bias": (e,), "layer_norm.weight": (e,), "layer_norm.bias": (e,),
              "post_extract_proj.weight": (d, e), "post_extract_proj.bias": (d,),
              "encoder.pos_conv.0.weight_v": (d, cg, tcfg.conv_pos),
              "encoder.pos_conv.0.weight_g": (1, 1, tcfg.conv_pos),
              "encoder.pos_conv.0.bias": (d,), "encoder.layer_norm.weight": (d,),
              "encoder.layer_norm.bias": (d,),
              "encoder.layers.0.self_attn.relative_attention_bias.weight":
                  (tcfg.rel_pos_buckets, H)}
    for i in range(tcfg.n_layers):
        p = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[p + f"self_attn.{name}.weight"] = (d, d)
            shapes[p + f"self_attn.{name}.bias"] = (d,)
        shapes.update({p + "self_attn.grep_linear.weight": (8, tcfg.head_dim),
                       p + "self_attn.grep_linear.bias": (8,),
                       p + "self_attn.grep_a": (1, H, 1, 1),
                       p + "fc1.weight": (inner, d), p + "fc1.bias": (inner,),
                       p + "fc2.weight": (d, inner), p + "fc2.bias": (d,)})
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[p + f"{ln}.weight"] = (d,)
            shapes[p + f"{ln}.bias"] = (d,)
    sd = {("beats." if nested else "") + k: v for k, v in _rand_sd(shapes, 6).items()}
    got = tconvert.convert_beats(sd, tcfg)
    _leaves_equal(got, jconvert.convert_beats(sd, jcfg))
    assert got["layers"]["attn"]["grep_a"].shape == (tcfg.n_layers, H)


def test_stack_nests_like_the_tree_map_it_replaces():
    layers = [{"a": {"w": np.full((2, 3), i, np.float32)}, "b": np.arange(4) + i}
              for i in range(3)]
    got = tconvert._stack(layers)
    assert got["a"]["w"].shape == (3, 2, 3) and got["b"].shape == (3, 4)
    _leaves_equal(got, jconvert._stack(layers))
