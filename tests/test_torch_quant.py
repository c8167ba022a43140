"""The port's weight quantization and its int4 / int8 matmuls against the JAX
package's ``ops/quant.py`` and its Pallas int4 kernel (interpret mode).

Quantized bytes must be bit-identical to JAX's on the same seeded input,
scales within 1 f32 ulp; ``int4_matmul_plain`` (the K10 kernel's zero-fold
math) matches the Pallas kernel within 2e-5 in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.models import llama as jllama
from icl_speech_text_llm_tpu.ops import int4_matmul as jint4
from icl_speech_text_llm_tpu.ops import quant as jquant
from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.models import llama as tllama
from icl_speech_text_llm_tpu_torch.ops import int4_matmul as tint4
from icl_speech_text_llm_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _w(shape, seed, scale=0.05):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40)])
def test_quantize_tensor_bit_identical_to_jax(shape):
    w = _w(shape, 0)
    w[..., 5] = 0.0  # an all-zero column: scale 1.0
    want = _np(jquant.quantize_tensor(jnp.asarray(w)))
    got = tquant.quantize_tensor(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_max_ulp(got["s"].numpy(), want["s"], maxulp=1)
    assert np.all(got["s"].numpy()[..., 5] == 1.0)


@pytest.mark.parametrize("shape,group", [((256, 48), 128), ((2, 128, 40), 64), ((176, 24), 88)])
def test_quantize_tensor_int4_bit_identical_to_jax(shape, group):
    w = _w(shape, 1)
    w[..., :group, 3] = 0.0  # an all-zero group: scale 1.0
    want = _np(jquant.quantize_tensor_int4(jnp.asarray(w), group=group))
    got = tquant.quantize_tensor_int4(torch.from_numpy(w), group=group)
    assert got["q4"].dtype == torch.uint8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), want["q4"])
    np.testing.assert_array_max_ulp(got["s"].numpy(), want["s"], maxulp=1)


def test_quantize_tensor_int4_refuses_groups_that_do_not_split():
    with pytest.raises(ValueError):
        tquant.quantize_tensor_int4(torch.zeros(96, 8), group=64)


def test_quantize_kv_bit_identical_to_jax():
    kv = _w((2, 3, 17, 32), 2, scale=3.0)
    kv[0, 1, 4] = 0.0  # an all-zero row (cache padding): scale 0, bytes 0
    qj, sj = jquant.quantize_kv(jnp.asarray(kv))
    qt, st = tquant.quantize_kv(torch.from_numpy(kv))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_max_ulp(st.numpy(), np.asarray(sj), maxulp=1)
    assert st[0, 1, 4] == 0 and torch.all(qt[0, 1, 4] == 0)


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 0.0),
                                         (jnp.bfloat16, torch.bfloat16, 0.0)])
def test_dequant_int4_matches_jax(jdt, tdt, tol):
    qt = jquant.quantize_tensor_int4(jnp.asarray(_w((2, 256, 40), 3)), group=64)
    want = np.asarray(jquant._dequant_int4(qt, jdt).astype(jnp.float32))
    got = tquant._dequant_int4(params_from_numpy(_np(qt), device="cpu"), tdt).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 2e-5),
                                         (jnp.bfloat16, torch.bfloat16, 2e-2)])
def test_dequant_matmul_matches_jax(kind, jdt, tdt, tol):
    """The plain routes every CPU product takes (and CUDA products above
    1024 rows): x @ w, (x @ q)·s, and x @ the unpacked int4 weight."""
    x = _w((2, 5, 256), 4, scale=1.0)
    w = _w((256, 48), 5)
    wj = {"plain": jnp.asarray(w), "int8": jquant.quantize_tensor(jnp.asarray(w)),
          "int4": jquant.quantize_tensor_int4(jnp.asarray(w), group=128)}[kind]
    want = np.asarray(jquant.dequant_matmul(jnp.asarray(x).astype(jdt), wj).astype(jnp.float32))
    got = tquant.dequant_matmul(torch.from_numpy(x).to(tdt),
                                params_from_numpy(_np(wj), device="cpu"))
    assert got.dtype == tdt and got.shape == (2, 5, 48)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("M,K,N,group,block_n", [
    (4, 512, 256, 128, None), (2, 1024, 1024, 128, 256), (256, 512, 512, 128, None),
    (3, 1024, 384, 256, 128)])
def test_int4_matmul_plain_matches_pallas_kernel(interpret_mode, M, K, N, group, block_n):
    """K10's zero-fold math against the Pallas kernel: several groups and N
    tiles, decode M and the M = 256 prefill."""
    x = _w((M, K), 6, scale=0.5)
    qt = jquant.quantize_tensor_int4(jnp.asarray(_w((K, N), 7)), group=group)
    want = np.asarray(jint4.int4_matmul(jnp.asarray(x), qt["q4"], qt["s"], block_n=block_n))
    t = params_from_numpy(_np(qt), device="cpu")
    got = tint4.int4_matmul_plain(torch.from_numpy(x), t["q4"], t["s"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_int4_matmul_plain_on_a_stacked_view_matches_the_pallas_layer_form(interpret_mode):
    """The Pallas kernel's stacked ``layer=`` form reads layer l of an
    (L, K/2, N) buffer; the port reads the contiguous view ``packed[l]``."""
    L, M, K, N, layer = 3, 4, 512, 256, 2
    x = _w((M, K), 8, scale=0.5)
    qt = jquant.quantize_tensor_int4(jnp.asarray(_w((L, K, N), 9)), group=128)
    want = np.asarray(jint4.int4_matmul(jnp.asarray(x), qt["q4"], qt["s"][layer],
                                        layer=jnp.asarray([layer], jnp.int32)))
    t = params_from_numpy(_np(qt), device="cpu")
    view = t["q4"][layer]
    assert view.is_contiguous() and view.data_ptr() == t["q4"].data_ptr() + layer * view.numel()
    got = tint4.int4_matmul_plain(torch.from_numpy(x), view, t["s"][layer])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_int8_matmul_plain_is_the_jax_int8_product():
    x = _w((4, 256), 10, scale=1.0)
    qt = jquant.quantize_tensor(jnp.asarray(_w((256, 128), 11)))
    want = np.asarray(jquant.dequant_matmul(jnp.asarray(x), qt))
    t = params_from_numpy(_np(qt), device="cpu")
    got = tint4.int8_matmul_plain(torch.from_numpy(x), t["q"], t["s"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_w((4, 256), 12, scale=1.0))
    q4 = params_from_numpy(_np(jquant.quantize_tensor_int4(jnp.asarray(_w((256, 128), 13)))),
                           device="cpu")
    q8 = params_from_numpy(_np(jquant.quantize_tensor(jnp.asarray(_w((256, 128), 14)))),
                           device="cpu")
    assert torch.equal(tint4.int4_matmul(x, q4["q4"], q4["s"]),
                       tint4.int4_matmul_plain(x, q4["q4"], q4["s"]))
    assert torch.equal(tint4.int8_matmul(x, q8["q"], q8["s"]),
                       tint4.int8_matmul_plain(x, q8["q"], q8["s"]))
    tquant.dequant_matmul(x, q4)
    tquant.dequant_matmul(x, q8)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert {"int4_matmul", "int8_matmul"} <= set(kernels.WRAPPERS)
    with pytest.raises(ValueError):
        tint4.int4_matmul(x.to("meta"), q4["q4"], q4["s"])


@pytest.mark.parametrize("x_shape,packed_shape,scales_shape,ok", [
    ((4, 5120), (2560, 13824), (40, 13824), True),     # 13B w_gate decode
    ((4, 13824), (6912, 5120), (108, 5120), True),     # 13B w_down decode
    ((1024, 5120), (2560, 5120), (40, 5120), True),    # the largest M
    ((1025, 5120), (2560, 5120), (40, 5120), False),   # prefill past 1024 rows
    ((4, 128), (64, 128), (2, 128), False),            # group 64 (salmonn-tiny)
    ((4, 5120), (2560, 5000), (40, 5000), False),      # N not in 128-column tiles
    ((4, 5120), (2560, 5120), (20, 5120), True),       # group 256
    ((4, 5120), (2560, 5120), (41, 5120), False),
])
def test_int4_gate(x_shape, packed_shape, scales_shape, ok):
    assert tint4.int4_matmul_usable(x_shape, packed_shape, scales_shape) is ok


@pytest.mark.parametrize("x_shape,q_shape,ok", [
    ((4, 5120), (5120, 32000), True), ((4, 11008), (11008, 4096), True),
    ((2048, 4096), (4096, 4096), False), ((4, 352), (352, 128), False),
    ((4, 128), (128, 36764), False)])
def test_int8_gate(x_shape, q_shape, ok):
    assert tint4.int8_matmul_usable(x_shape, q_shape) is ok


@pytest.mark.parametrize("M,w_rows,N", [
    (4, 2560, 13824),    # 13B w_gate / w_up decode (int4: K / 2 packed rows)
    (4, 6912, 5120),     # 13B w_down
    (4, 2560, 5120),     # 13B wq / wk / wv / wo
    (4, 5120, 32000),    # K12 13B lm_head (int8: K rows)
    (4, 11008, 4096),    # K12 7B w_down
    (4, 128, 128),       # one 128-column tile, one 128-row k step
    (1, 2560, 13824), (17, 2560, 13824), (256, 2560, 13824)])
def test_partition_covers_every_tile_step_once_and_balances_132_sms(M, w_rows, N):
    """The column tile and cluster split of ``partition``: every (column
    tile, k step) of the grid is some rank's exactly once, the split divides
    the grid's x axis and is at most 8, no split is empty, and the busiest
    of 132 SMs streams at most 1.1× the mean (a product of fewer (tile,
    step) units than SMs: at most one unit an SM)."""
    n_steps = w_rows // tint4.STEP_ROWS
    tile_n, splits = tint4.partition(M, N, n_steps, 132)
    assert tile_n in tint4.TILES_N and N % tile_n == 0
    assert 1 <= splits <= min(tint4.MAX_SPLITS, n_steps)
    bounds = tint4.split_bounds(n_steps, splits)  # the grid's x axis: one cluster
    assert len(bounds) == splits
    assert all(end > begin for begin, end in bounds)
    covered = np.zeros((N // tile_n, n_steps), np.int64)
    for tile in range(N // tile_n):
        for begin, end in bounds:
            covered[tile, begin:end] += 1
    assert np.all(covered == 1)
    work = tint4.sm_work(M, N, n_steps, tile_n, splits, 132)
    units = (N // tile_n) * -(-M // (16 if M <= 16 else 64)) * n_steps
    assert len(work) == 132 and sum(work) == units
    if units >= 132:
        assert tint4.balanced(work), (tile_n, splits, max(work), units / 132)
    else:
        assert max(work) == 1


def _tiny_decoder(seed=0):
    cfg = jllama.DECODER_CONFIGS["tiny"]
    return cfg, _np(jllama.init_decoder(jax.random.PRNGKey(seed), cfg))


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
        return
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, path
    if g.dtype == np.float32 and path.endswith(".s"):
        np.testing.assert_array_max_ulp(g, want, maxulp=1)
    else:
        np.testing.assert_array_equal(g, want, err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_decoder_tree_matches_jax_at_salmonn_tiny(bits):
    """Same tree as JAX's: at bits=4 salmonn-tiny's dim 128 gets group 64 and
    hidden 352 group 88, the lm_head stays int8; quantized in place."""
    _, params = _tiny_decoder()
    want = _np(jquant.quantize_decoder(jax.tree_util.tree_map(jnp.asarray, params), bits=bits))
    tree = params_from_numpy(params, device="cpu")
    got = tquant.quantize_decoder(tree, bits=bits)
    assert got is tree
    _assert_trees_equal(got, want)
    if bits == 4:
        assert got["layers"]["attn"]["wq"]["s"].shape == (2, 128 // 64, 128)
        assert got["layers"]["mlp"]["w_down"]["s"].shape == (2, 352 // 88, 128)
        assert set(got["lm_head"]) == {"q", "s"}


def test_quantize_decoder_falls_back_to_int8_where_int4_cannot_split():
    w = torch.from_numpy(_w((2, 7, 16), 15))  # odd input dim
    params = {"layers": {"attn": {n: w.clone() for n in ("wq", "wk", "wv", "wo")},
                         "mlp": {n: w.clone() for n in ("w_gate", "w_up", "w_down")}}}
    out = tquant.quantize_decoder(params, bits=4)
    want = _np(jquant.quantize_tensor(jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(out["layers"]["mlp"]["w_down"]["q"].numpy(), want["q"])
    with pytest.raises(ValueError):
        tquant.quantize_decoder(params, bits=6)


@pytest.mark.parametrize("bits", [8, 4])
def test_init_decoder_quantized_layout_matches_jax(bits):
    cfg = jllama.DECODER_CONFIGS["tiny"]
    tcfg = tllama.DECODER_CONFIGS["tiny"]
    want = _np(jllama.init_decoder_quantized(jax.random.PRNGKey(0), cfg, bits=bits, group=64))
    got = tllama.init_decoder_quantized(tcfg, torch.Generator().manual_seed(0), "cpu",
                                        torch.bfloat16, bits=bits, group=64)

    def walk(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
            return
        assert tuple(g.shape) == w.shape, path
        want_dt = (torch.bfloat16 if w.dtype == jnp.bfloat16
                   else torch.from_numpy(np.empty(0, w.dtype)).dtype)
        assert g.dtype == want_dt, (path, g.dtype, w.dtype)
        if path.endswith(".s") or "norm" in path or "ln_" in path:
            np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=1)  # the same constants
    walk(got, want)
    packed = got["layers"]["mlp"]["w_up"]["q4" if bits == 4 else "q"]
    assert packed.float().std() > 10  # random bytes, not zeros


def test_bridge_keeps_quantized_scales_f32():
    """A JAX quantize_decoder tree bridged at bf16: weights keep uint8/int8
    bytes unchanged and the scales stay f32; other floats become bf16."""
    _, params = _tiny_decoder(1)
    jq = _np(jquant.quantize_decoder(jax.tree_util.tree_map(jnp.asarray, params), bits=4))
    t = params_from_numpy(jq, dtype=torch.bfloat16, device="cpu")
    wq = t["layers"]["attn"]["wq"]
    assert wq["q4"].dtype == torch.uint8 and wq["s"].dtype == torch.float32
    np.testing.assert_array_equal(wq["q4"].numpy(), jq["layers"]["attn"]["wq"]["q4"])
    np.testing.assert_array_equal(wq["s"].numpy(), jq["layers"]["attn"]["wq"]["s"])
    assert t["lm_head"]["q"].dtype == torch.int8 and t["lm_head"]["s"].dtype == torch.float32
    assert t["tok_embed"].dtype == torch.bfloat16
    assert t["layers"]["ln_attn"].dtype == torch.bfloat16
    cache = _np(jllama.init_kv_cache(jllama.DECODER_CONFIGS["tiny"], 1, 8, quant=True))
    tc = params_from_numpy(cache, dtype=torch.bfloat16, device="cpu")
    assert tc["k"].dtype == torch.int8 and tc["k_s"].dtype == torch.float32


def test_init_kv_cache_quant_layout_matches_jax():
    cfg = jllama.DECODER_CONFIGS["tiny"]
    want = _np(jllama.init_kv_cache(cfg, 2, 128, quant=True))
    got = tllama.init_kv_cache(tllama.DECODER_CONFIGS["tiny"], 2, 128, quant=True, device="cpu")
    _assert_trees_equal(got, want)
