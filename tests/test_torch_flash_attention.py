"""The port's attention ops (icl_speech_text_llm_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

Same inputs (numpy, seeded) through both; f32; the bound is 3e-5 on valid rows
(the Pallas kernels' own bound against their XLA oracle) and exact equality
for the KV append. The Hopper kernels themselves are checked against these
plain versions on the card in ``tests/test_torch_cuda_kernels.py``.
"""

import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax.numpy as jnp

from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 3e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _arrays(shapes, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _valid_rows_max(a, b, lengths):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return max(d[i, :, :n].max() for i, n in enumerate(lengths))


def test_causal_flash_plain_matches_pallas_kernel():
    """K1: causal flash forward with ragged lengths — o, m and l."""
    B, H, S, D = 2, 2, 256, 128
    q, k, v = _arrays([(B, H, S, D)] * 3)
    lengths = [256, 130]
    o_j, m_j, l_j = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lengths, jnp.int32), True, D ** -0.5,
                                       128, 128)
    o_t, m_t, l_t = tfa.flash_attention_plain(*_t(q, k, v), torch.tensor(lengths), causal=True)
    assert _valid_rows_max(o_t, o_j, lengths) < TOL
    assert _valid_rows_max(m_t[..., None], np.asarray(m_j)[:, :, 0, :, None], lengths) < TOL
    rel = np.asarray(l_t) / np.asarray(l_j)[:, :, 0]
    assert _valid_rows_max(rel[..., None], np.ones_like(rel)[..., None], lengths) < TOL


def test_noncausal_flash_plain_matches_pallas_kernel():
    """K2: non-causal flash forward with a per-sample key length."""
    B, H, S, D = 2, 2, 256, 64
    q, k, v = _arrays([(B, H, S, D)] * 3, seed=1)
    lengths = [256, 70]
    o_j, m_j, l_j = jfa._flash_forward_noncausal(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths, jnp.int32),
        D ** -0.5, 128, 128)
    o_t, m_t, l_t = tfa.flash_attention_plain(*_t(q, k, v), torch.tensor(lengths), causal=False)
    rows = [S, S]  # every query row attends the valid keys
    assert _valid_rows_max(o_t, o_j, rows) < TOL
    assert _valid_rows_max(m_t[..., None], np.asarray(m_j)[:, :, 0, :, None], rows) < TOL
    rel = np.asarray(l_t) / np.asarray(l_j)[:, :, 0]
    assert _valid_rows_max(rel[..., None], np.ones_like(rel)[..., None], rows) < TOL


def test_gated_bias_plain_matches_pallas_kernel():
    """K3: BEATs gated relative-position bias attention (bias read as bf16)."""
    B, H, S, D = 2, 2, 256, 64
    q, k, v, xh = _arrays([(B, H, S, D)] * 4, seed=2, scale=0.3)
    (bias,) = _arrays([(H, S, S)], seed=3)
    grep_w, grep_b = _arrays([(D, 8), (8,)], seed=4, scale=0.2)
    grep_a = 1.0 + _arrays([(H,)], seed=5, scale=0.1)[0]
    lengths = [256, 131]
    o_j = jfa.flash_attention_gated_bias(
        *map(jnp.asarray, (q, k, v, xh, bias, grep_w, grep_b, grep_a)),
        jnp.asarray(lengths, jnp.int32), block_q=128, block_k=128)
    o_t = tfa.gated_bias_attention_plain(*_t(q, k, v, xh, bias, grep_w, grep_b, grep_a),
                                         torch.tensor(lengths))
    assert _valid_rows_max(o_t, o_j, lengths) < TOL


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_append_kv_plain_matches_pallas_kernel_exactly(dtype):
    """K4: one decode step's k/v for all layers written at positions[b]; an
    int8 cache takes rows the caller has already quantized."""
    L, B, Hkv, S, D = 2, 2, 2, 64, 128
    ck, cv = (a.astype(dtype) for a in _arrays([(L, B, Hkv, S, D)] * 2, seed=6, scale=50))
    nk, nv = (a.astype(dtype) for a in _arrays([(L, B, Hkv, 1, D)] * 2, seed=7, scale=50))
    pos = np.array([37, 5], np.int32)
    jk, jv = jfa.append_kv(*map(jnp.asarray, (ck, cv, nk, nv, pos)))
    tk, tv = tfa.append_kv_plain(*_t(ck.copy(), cv.copy(), nk, nv, pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gqa_plain_reads_kv_head_h_over_rep():
    """GQA: query head h attends kv head h // (H / Hkv), as repeat_kv gives."""
    q, = _arrays([(1, 4, 128, 64)], seed=8)
    k, v = _arrays([(1, 2, 128, 64)] * 2, seed=9)
    kk, vv = (np.repeat(a, 2, axis=1) for a in (k, v))
    lengths = torch.tensor([100])
    got = tfa.flash_attention_plain(*_t(q, k, v), lengths, causal=True)[0]
    want = tfa.flash_attention_plain(*_t(q, kk, vv), lengths, causal=True)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_row_without_valid_key_is_zero():
    """A sample with length 0: l == 0 and o == 0 (the kernels' rule)."""
    q, k, v = _t(*_arrays([(2, 1, 64, 64)] * 3, seed=10))
    o, m, l = tfa.flash_attention_plain(q, k, v, torch.tensor([64, 0]), causal=False)
    assert torch.all(l[1] == 0) and torch.all(o[1] == 0)
    assert torch.all(torch.isinf(m[1])) and torch.all(l[0] > 0)


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    kernels.reset_launch_counts()
    q, k, v = _t(*_arrays([(1, 2, 128, 64)] * 3, seed=11))
    lengths = torch.tensor([90])
    o = tfa.flash_attention(q, k, v, lengths, causal=True)
    np.testing.assert_array_equal(
        o.numpy(), tfa.flash_attention_plain(q, k, v, lengths, True)[0].numpy())
    tfa.flash_attention(q, k, v, lengths, causal=False)
    xh, = _t(*_arrays([(1, 2, 128, 64)], seed=12))
    bias = torch.zeros(2, 128, 128)
    tfa.gated_bias_attention(q, k, v, xh, bias, torch.zeros(64, 8), torch.zeros(8),
                             torch.ones(2))
    ck = torch.zeros(1, 1, 2, 8, 4)
    tfa.append_kv(ck, ck.clone(), torch.ones(1, 1, 2, 1, 4), torch.ones(1, 1, 2, 1, 4),
                  torch.tensor([3]))
    q8, sc = torch.zeros(1, 1, 2, 8, 4, dtype=torch.int8), torch.zeros(1, 1, 2, 8)
    tfa.append_kv_q8(q8, q8.clone(), sc, sc.clone(), torch.ones(1, 1, 2, 1, 4),
                     torch.ones(1, 1, 2, 1, 4), torch.tensor([3], dtype=torch.int32))
    assert torch.all(q8[:, :, :, 3] == 127) and torch.all(sc[:, :, :, 3] == 1 / 127)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 1, 64, 64), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, None, causal=True)
