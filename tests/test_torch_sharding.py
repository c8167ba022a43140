"""The port's sharding rules (``parallel/sharding.py``) against the JAX
package's: the rule table itself, ``spec_for_path`` on every leaf path of
the model trees, each rank's block shapes against JAX's
``NamedSharding.shard_shape``, the bit-exact ``shard_params`` →
``gather_params`` round trip over gloo ranks, the divisibility error (the
JAX package's ``shard_params`` raises on the same tree and mesh) and the
serving engines' refusal of a tp that does not divide the KV heads.
"""

import contextlib
import os
import sys
import types
import weakref

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.models import qwen_audio as jqwen
from icl_speech_text_llm_tpu.models import salmonn as jsalmonn
from icl_speech_text_llm_tpu.ops.quant import quantize_decoder
from icl_speech_text_llm_tpu.parallel import mesh as jmesh
from icl_speech_text_llm_tpu.parallel import sharding as jsharding
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.parallel import sharding as tsharding

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _salmonn():
    return _np(jsalmonn.init_salmonn(jax.random.PRNGKey(0), jsalmonn.salmonn_tiny()))


def _trees():
    """name → a JAX-initialised tree whose paths the rules must cut as JAX's."""
    salmonn = _salmonn()
    qwen = _np(jqwen.init_qwen_audio(jax.random.PRNGKey(0), jqwen.qwen2_audio_tiny()))
    int8 = {**salmonn, "llm": _np(quantize_decoder(salmonn["llm"], bits=8))}
    int4 = {**salmonn, "llm": _np(quantize_decoder(salmonn["llm"], bits=4))}
    bank = {"llm": salmonn["llm"],
            "lora": _np(jllama.stack_lora_bank([salmonn["lora"], salmonn["lora"]]))}
    return {"salmonn-tiny": salmonn, "qwen2-audio-tiny": qwen, "int8": int8, "int4": int4,
            "lora-bank": bank}


TREES = ("salmonn-tiny", "qwen2-audio-tiny", "int8", "int4", "lora-bank")


@pytest.fixture(scope="module")
def trees():
    return _trees()


def test_rule_table_is_jaxs():
    assert [p for p, _ in tsharding._RULES] == [p for p, _ in jsharding._RULES]
    assert [tuple(s) for _, s in jsharding._RULES] == [s for _, s in tsharding._RULES]


@pytest.mark.parametrize("name", TREES)
def test_spec_for_path_equals_jax_on_every_leaf(trees, name):
    paths = list(tsharding.tree_paths(trees[name]))
    assert len(paths) > 10
    cut = 0
    for path, leaf in paths:
        want = tuple(jsharding.spec_for_path(path, leaf.ndim))
        assert tsharding.spec_for_path(path, leaf.ndim) == want, path
        cut += any(a is not None for a in want)
    # the quantized leaves match no rule: only the vocabulary and LoRA stay cut
    if name in ("int8", "int4"):
        assert all(tsharding.spec_for_path(p, leaf.ndim) == ()
                   for p, leaf in paths if p.startswith("llm/layers/attn/w"))
    assert cut > 0


def _fake_mesh(sizes, coords):
    """A stand-in mesh whose shard context is one rank's place in it (no
    process group: ``shard_params`` cuts without collectives)."""
    axes = ("dp", "fsdp", "tp")
    ctx = tsharding.ShardContext(dict(zip(axes, sizes)), dict(zip(axes, coords)), {})
    return types.SimpleNamespace(_icl_shard_context=ctx)


#: salmonn-tiny with Whisper and BEATs at 2 heads: tp = 4 cuts each head in
#: two (the split-head path), every column width still divides
VARIANT = {"whisper": {"n_heads": 2}, "beats": {"n_heads": 2}}


@pytest.mark.parametrize("sizes", [(1, 1, 2), (1, 2, 1), (2, 2, 2), (1, 1, 4)], ids=str)
def test_each_ranks_block_shapes_equal_jax_shard_shape(sizes):
    """At (1, 1, 4) the tree is the 2-head variant's: its ranks' blocks are
    JAX's too, though tp does not divide a head count."""
    params = _salmonn() if sizes != (1, 1, 4) else _np(jsalmonn.init_salmonn(
        jax.random.PRNGKey(0), chip_smoke._salmonn_variant(VARIANT, jsalmonn)))
    dp, fsdp, tp = sizes
    mesh = jmesh.make_mesh(dp=dp, fsdp=fsdp, tp=tp, devices=jax.devices()[:dp * fsdp * tp])
    want = {p: NamedSharding(mesh, jsharding.spec_for_path(p, leaf.ndim)).shard_shape(leaf.shape)
            for p, leaf in tsharding.tree_paths(params)}
    full = params_from_numpy(params, device="cpu")
    for coords in np.ndindex(*sizes):
        local = tsharding.shard_params(full, _fake_mesh(sizes, coords))
        got = {p: tuple(t.shape) for p, t in tsharding.tree_paths(local)}
        assert got == want, coords
    # a rank's block is its slice of the leaf (tp coordinate 1 of wq's columns)
    local = tsharding.shard_params(full, _fake_mesh(sizes, (0, 0, tp - 1)))
    wq = full["llm"]["layers"]["attn"]["wq"]
    n = wq.shape[-1] // tp
    assert torch.equal(local["llm"]["layers"]["attn"]["wq"],
                       wq[:, :wq.shape[1] // fsdp, (tp - 1) * n:tp * n])


def test_batch_rows_follow_dp_then_fsdp():
    batch = {"x": np.arange(8)}
    rows = {c: tsharding.batch_rows(batch, _fake_mesh((2, 2, 2), c))["x"].tolist()
            for c in np.ndindex(2, 2, 2)}
    assert rows[(0, 0, 0)] == rows[(0, 0, 1)] == [0, 1]
    assert rows[(0, 1, 0)] == [2, 3] and rows[(1, 0, 1)] == [4, 5] and rows[(1, 1, 1)] == [6, 7]
    with pytest.raises(ValueError, match="does not split"):
        tsharding.batch_rows({"x": np.arange(6)}, _fake_mesh((2, 2, 1), (0, 0, 0)))


def test_a_dim_the_axis_does_not_divide_raises():
    """A dim its axis does not divide: the JAX package's ``shard_params``
    (a ``jax.device_put``) raises ``ValueError`` on the tree and mesh, and
    the port refuses it the same way, naming leaf and axis."""
    params = _salmonn()
    jm = jmesh.make_mesh(dp=1, fsdp=1, tp=3, devices=jax.devices()[:3])
    for tree in (params, {"llm": params["llm"]}):
        with pytest.raises(ValueError, match="divisible by 3"):
            jsharding.shard_params(tree, jm)
    full = params_from_numpy(params, device="cpu")
    with pytest.raises(ValueError, match=r"beats/layers/attn/w[kqv]: .* tp axis of size 3"):
        tsharding.shard_params(full, _fake_mesh((1, 1, 3), (0, 0, 0)))
    with pytest.raises(ValueError, match=r"llm/layers/attn/w[kqv]: dim 2 .* tp axis of size 3"):
        tsharding.shard_params({"llm": full["llm"]}, _fake_mesh((1, 1, 3), (0, 0, 0)))


def test_serving_engines_refuse_a_tp_that_does_not_divide_the_kv_heads():
    """The tiny decoder's 2 KV heads at tp = 4: JAX's engine raises placing
    its KV-head-sharded pool, the port's in its constructor; at tp = 2 both
    build."""
    from icl_speech_text_llm_tpu.inference import serving as jserving
    from icl_speech_text_llm_tpu_torch.inference import serving as tserving
    from icl_speech_text_llm_tpu_torch.models import llama as tllama

    jcfg = jllama.DECODER_CONFIGS["tiny"]
    params = _np(jllama.init_decoder(jax.random.PRNGKey(0), jcfg))
    serving = dict(num_slots=2, max_new_tokens=2, prompt_buckets=(16,))
    for tp, refused in ((4, True), (2, False)):
        jm = jmesh.make_mesh(dp=1, fsdp=1, tp=tp, devices=jax.devices()[:tp])
        build = lambda: jserving.ContinuousBatchingEngine(  # noqa: E731
            jcfg, jsharding.shard_params(jax.tree_util.tree_map(jax.numpy.asarray, params), jm),
            jserving.ServingConfig(**serving), mesh=jm)
        if refused:
            with pytest.raises(ValueError, match="divisible by 4"):
                build()
        else:
            build()
    tcfg = tllama.DECODER_CONFIGS["tiny"]
    tparams = params_from_numpy(params, device="cpu")
    with pytest.raises(ValueError, match="tp=4 does not divide the 2 KV heads"):
        tserving.ContinuousBatchingEngine(tcfg, tparams, tserving.ServingConfig(**serving),
                                          mesh=_fake_mesh((1, 1, 4), (0, 0, 1)), device="cpu")


@pytest.mark.parametrize("mesh", ["1,2,2"])
def test_gather_params_round_trips_bit_exactly(tmp_path, mesh):
    """Four gloo ranks cut salmonn-tiny by the rules and gather it back: every
    leaf bit for bit; each rank's shapes JAX's shard_shape."""
    params = _salmonn()
    ranks = chip_smoke._dp_spawn(str(tmp_path), "file", params, None, "cpu", world=4,
                                 timeout=60, mesh=mesh, tasks=("roundtrip",))
    jm = jmesh.make_mesh(dp=1, fsdp=2, tp=2, devices=jax.devices()[:4])
    want = {p: list(NamedSharding(jm, jsharding.spec_for_path(p, leaf.ndim)).shard_shape(
        leaf.shape)) for p, leaf in tsharding.tree_paths(params)}
    for res, _ in ranks:
        assert res["roundtrip"]["exact"]
        assert res["roundtrip"]["shapes"] == want


@pytest.mark.parametrize("keep", [False, True], ids=["plain", "keep_shards"])
def test_keep_shards_saves_the_shard_and_gathers_again(monkeypatch, keep):
    """A product with an FSDP-gathered frozen weight saves the weight for its
    input's gradient: inside ``keep_shards`` the graph holds the shard, the
    gathered weight is freed after the forward and gathered again in the
    backward, and the gradient is the same."""
    from icl_speech_text_llm_tpu_torch.parallel import collectives

    calls = []

    def fake_gather(t, dim, group):  # fsdp rank 0 of 2; rank 1 holds t + 1
        calls.append(dim)
        return torch.cat([t, t + 1], dim)

    monkeypatch.setattr(collectives, "all_gather", fake_gather)
    ctx = tsharding.ShardContext({"dp": 1, "fsdp": 2, "tp": 1}, {"dp": 0, "fsdp": 0, "tp": 0},
                                 {"fsdp": None})
    shard = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1), requires_grad=True)
    with ctx.keep_shards() if keep else contextlib.nullcontext():
        layer = ctx.gather_fsdp({"attn": {"wq": shard}}, "llm/layers")
        whole = weakref.ref(layer["attn"]["wq"])
        y = torch.matmul(x, layer["attn"]["wq"]).square().sum()
    del layer
    assert (whole() is None) == keep
    assert len(calls) == 1
    (g,) = torch.autograd.grad(y, x)
    w = torch.cat([shard, shard + 1])
    torch.testing.assert_close(g, 2 * (x.detach() @ w) @ w.T, rtol=0, atol=0)
    assert len(calls) == 1 + keep and ctx._kept is None


def test_one_is_the_identity_context():
    """``ONE`` (one process): whole slices, the row bias kept, no collective."""
    x = torch.randn(2, 6, requires_grad=True)
    one = tsharding.ONE
    assert one.cols(6) == slice(0, 6) and one.local_heads(6) == 6
    assert one.reduce_from_tp(x) is x and one.copy_to_tp(x) is x
    assert one.row_bias(x) is x and one.gather_fsdp({"w": x}, "llm/layers") == {"w": x}
