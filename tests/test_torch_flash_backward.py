"""The port's flash backward (icl_speech_text_llm_tpu_torch/ops/flash_attention.py)
against the JAX package's, on the CPU.

``flash_attention_bwd_plain`` is the explicit math the K5/K6 kernels compute;
it is held against the JAX Pallas backward kernels (``_flash_bwd_rule``, run
in interpret mode as ``tests/test_flash_attention.py`` runs them) and the
JAX scan-rule oracle (``_flash_bwd_scan_rule``) within 1e-4 at f32, the bound
of the JAX package's own multiblock backward test. ``FlashAttention`` is
held against autograd through the plain forward at f64 (gradcheck-level
agreement), and GQA against ``jax.vjp`` of ``repeat_kv`` → JAX
``flash_attention``. The kernels themselves are checked against the plain
version on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu.ops.attention import repeat_kv as jrepeat_kv
from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _arrays(shapes, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _masked_do(shape, lengths, seed):
    """Upstream gradient, zero past each sample's length (as a masked loss)."""
    (do,) = _arrays([shape], seed, 0.1)
    rows = np.arange(shape[2])[None, None, :, None] < np.asarray(lengths)[:, None, None, None]
    return (do * rows).astype(np.float32)


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("causal,D,H,Hkv,S,lengths", [
    pytest.param(True, 128, 2, 2, 256, [256, 147], id="True"),
    pytest.param(False, 128, 2, 2, 256, [256, 147], id="False"),
    # the Hopper kernels' 64-row tiles: lengths that straddle one, and 0
    pytest.param(True, 64, 2, 2, 256, [256, 65], id="causal-D64-straddle"),
    pytest.param(False, 64, 2, 2, 256, [200, 0], id="noncausal-D64-empty"),
    pytest.param(True, 128, 2, 2, 256, [200, 0], id="causal-D128-empty"),
    # GQA n_rep 8: dk/dv summed over the eight query heads of a kv head
    pytest.param(True, 64, 8, 1, 128, [128, 65], id="causal-D64-gqa8"),
    pytest.param(False, 128, 8, 1, 128, [100, 0], id="noncausal-D128-gqa8-empty"),
])
def test_plain_backward_matches_pallas_kernels_and_scan_oracle(causal, D, H, Hkv, S, lengths):
    """K5/K6 math, B=2: the plain backward against JAX's Pallas backward
    (interpret mode) and its scan oracle. JAX's kernels take H == Hkv, so
    with GQA they get repeat_kv'd k/v and their dk/dv are summed over each
    group, as autodiff through repeat_kv does."""
    B, n_rep = 2, H // Hkv
    q, = _arrays([(B, H, S, D)], seed=1)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed=12)
    do = _masked_do((B, H, S, D), lengths, seed=2)
    sm = D ** -0.5
    jl = jnp.asarray(lengths, jnp.int32)
    jq, jk, jv = jnp.asarray(q), jrepeat_kv(jnp.asarray(k), n_rep), jrepeat_kv(jnp.asarray(v), n_rep)
    if causal:
        o, m, l = jfa._flash_forward(jq, jk, jv, jl, True, sm, 128, 128)
    else:
        o, m, l = jfa._flash_forward_noncausal(jq, jk, jv, jl, sm, 128, 128)
    res = (jq, jk, jv, jl, o, m[:, :, 0], l[:, :, 0])
    want_kern = jfa._flash_bwd_rule(causal, sm, 128, 128, 128, 128, res, jnp.asarray(do))[:3]
    want_scan = jfa._flash_bwd_scan_rule(causal, sm, 128, 128, res, jnp.asarray(do))[:3]

    def group_sum(g, i):  # dk, dv of the repeated heads → of the kv heads
        g = np.asarray(g, np.float64)
        return g if i == 0 else g.reshape(B, Hkv, n_rep, S, D).sum(2)

    t = torch.from_numpy
    o_t, m_t, l_t = tfa.flash_attention_plain(t(q), t(k), t(v), torch.tensor(lengths), causal)
    got = tfa.flash_attention_bwd_plain(t(q), t(k), t(v), o_t, m_t, l_t, t(do),
                                        torch.tensor(lengths), causal)
    for i, (name, g, wk, ws) in enumerate(zip(("dq", "dk", "dv"), got, want_kern, want_scan)):
        wk, ws = group_sum(wk, i), group_sum(ws, i)
        assert g.shape == wk.shape, (name, g.shape, wk.shape)
        assert np.isfinite(g.numpy()).all(), name
        assert _max_err(g.numpy(), wk) < TOL, (causal, name, "pallas", _max_err(g.numpy(), wk))
        assert _max_err(g.numpy(), ws) < TOL, (causal, name, "scan", _max_err(g.numpy(), ws))
    for i, n in enumerate(lengths):
        if n == 0:  # no valid key: every gradient of the sample is 0
            assert all(torch.all(g[i] == 0) for g in got)


def test_wrapper_parts_equal_the_plain_backward_on_cpu():
    """The K5 and K6 wrappers take their plain parts on the CPU, launch
    nothing, and together give flash_attention_bwd_plain."""
    B, H, Hkv, S, D = 2, 4, 2, 128, 64
    q, = _arrays([(B, H, S, D)], seed=3)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed=4)
    lengths = torch.tensor([128, 50])
    do = torch.from_numpy(_masked_do((B, H, S, D), [128, 50], seed=5))
    t = torch.from_numpy
    o, m, l = tfa.flash_attention_plain(t(q), t(k), t(v), lengths, True)
    kernels.reset_launch_counts()
    dq, delta = tfa.flash_attention_bwd_dq(t(q), t(k), t(v), o, m, l, do, lengths, True)
    dk, dv = tfa.flash_attention_bwd_dkv(t(q), t(k), t(v), m, l, delta, do, lengths, True)
    want = tfa.flash_attention_bwd_plain(t(q), t(k), t(v), o, m, l, do, lengths, True)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert torch.allclose(delta, (do * o).sum(-1))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_backward_matches_jax_vjp_of_repeat_kv(causal):
    """H=4 over Hkv=2: dk/dv are the sums over the two query heads of a group,
    as jax.vjp of repeat_kv → flash_attention gives."""
    B, H, Hkv, S, D = 2, 4, 2, 256, 128
    lengths = [256, 147]
    q, = _arrays([(B, H, S, D)], seed=6)
    k, v = _arrays([(B, Hkv, S, D)] * 2, seed=7)
    do = _masked_do((B, H, S, D), lengths, seed=8)
    jl = jnp.asarray(lengths, jnp.int32)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, jrepeat_kv(k_, H // Hkv), jrepeat_kv(v_, H // Hkv),
                                   lengths=jl, causal=causal, block_q=128, block_k=128,
                                   bwd_block_q=128, bwd_block_k=128)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, torch.tensor(lengths), causal=causal)
    o.backward(torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        assert g.shape == w.shape, name
        assert _max_err(g.numpy(), w) < TOL, (causal, name, _max_err(g.numpy(), w))


@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 1)])
def test_flash_attention_function_matches_autograd_of_plain_forward(causal, Hkv):
    """FlashAttention's explicit backward against autograd through
    flash_attention_plain, f64, tiny shape, GQA, ragged lengths."""
    B, H, S, D = 2, 2, 24, 8
    rng = np.random.RandomState(9)
    q = torch.from_numpy(rng.randn(B, H, S, D)).requires_grad_()
    k = torch.from_numpy(rng.randn(B, Hkv, S, D)).requires_grad_()
    v = torch.from_numpy(rng.randn(B, Hkv, S, D)).requires_grad_()
    lengths = torch.tensor([24, 13])
    w = torch.from_numpy(rng.randn(B, H, S, D))
    got = torch.autograd.grad((tfa.FlashAttention.apply(q, k, v, lengths, causal) * w).sum(),
                              (q, k, v))
    want = torch.autograd.grad((tfa.flash_attention_plain(q, k, v, lengths, causal)[0] * w).sum(),
                               (q, k, v))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-7, atol=1e-9)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.FlashAttention.apply(a, b, c, lengths, causal), (q, k, v),
        eps=1e-6, atol=1e-6)


def test_length_zero_sample_gives_zero_finite_gradients():
    B, H, S, D = 2, 2, 32, 16
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays([(B, H, S, D)] * 3, 10))
    o = tfa.flash_attention(q, k, v, torch.tensor([32, 0]), causal=True)
    assert torch.all(o[1] == 0)
    o.sum().backward()
    for g in (q.grad, k.grad, v.grad):
        assert torch.isfinite(g).all()
        assert torch.all(g[1] == 0)
        assert g[0].abs().sum() > 0


def test_flash_attention_is_differentiable_only_when_asked():
    """Forward-only calls (no grad, or inputs without grad) stay on the
    plain forward and build no graph."""
    q, k, v = (torch.from_numpy(a) for a in _arrays([(1, 2, 64, 16)] * 3, 11))
    assert tfa.flash_attention(q, k, v, None, causal=True).grad_fn is None
    qg = q.clone().requires_grad_()
    assert tfa.flash_attention(qg, k, v, None, causal=True).grad_fn is not None
    with torch.no_grad():
        assert tfa.flash_attention(qg, k, v, None, causal=True).grad_fn is None
