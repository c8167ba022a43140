"""K8 and K9, the batched and row schedules of the BEATs gated-bias
attention: their plain PyTorch versions against the JAX package's Pallas
kernels in interpret mode (``flash_attention_gated_bias(batch_block=True)``
and ``flash_attention_gated_bias_rows``), and BEATs with ``lean_bias_flash``
against JAX's BEATs with it, on the CPU.

Same inputs (numpy, seeded) through both, at S = 256 (the JAX kernels need
S % 128 == 0) with ragged lengths. Bounds on valid rows: 3e-5 at f32 (the
K3 test's bound); 2e-2 at bf16, where both sides round q·D^-½·log2e and
s − max to bf16 and the exp2 runs in bf16, but the f32 sums run in other
orders.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from icl_speech_text_llm_tpu.models import beats as jbeats
from icl_speech_text_llm_tpu.ops import flash_attention as jfa
from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.models import beats as tbeats
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
B, H, S, D = 2, 2, 256, 64
LENGTHS = [256, 131]
TOL = {"f32": 3e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _arrays(shapes, seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _inputs(seed):
    q, k, v, xh = _arrays([(B, H, S, D)] * 4, seed, 0.3)
    bias, = _arrays([(H, S, S)], seed + 1, 0.5)
    grep_w, grep_b = _arrays([(D, 8), (8,)], seed + 2, 0.2)
    grep_a = 1.0 + _arrays([(H,)], seed + 3, 0.1)[0]
    return q, k, v, xh, bias, grep_w, grep_b, grep_a


def _cast(dtype):
    if dtype == "bf16":
        return (lambda a: jnp.asarray(a, jnp.bfloat16),
                lambda a: torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray, torch.from_numpy


def _valid_rows_max(a, b, lengths):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return max(d[i, :, :n].max() for i, n in enumerate(lengths))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_schedule_plain_matches_pallas_kernel(dtype):
    """K8: the gate in the kernel, one program per (head, q-tile, kv-tile)
    over the whole batch in JAX; ``gated_bias_attention(batch_block=True)``."""
    q, k, v, xh, bias, gw, gb, ga = _inputs(10)
    cj, ct = _cast(dtype)
    want = jfa.flash_attention_gated_bias(
        *map(cj, (q, k, v, xh)), jnp.asarray(bias), *map(jnp.asarray, (gw, gb, ga)),
        jnp.asarray(LENGTHS, jnp.int32), batch_block=True)
    got = tfa.gated_bias_attention(*map(ct, (q, k, v, xh)), torch.from_numpy(bias),
                                   *map(torch.from_numpy, (gw, gb, ga)),
                                   torch.tensor(LENGTHS), batch_block=True)
    assert got.dtype == ct(q).dtype
    assert _valid_rows_max(got.float(), want, LENGTHS) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rows_schedule_plain_matches_pallas_kernel(dtype):
    """K9: the gate rows precomputed (B, H, S) f32, the exp2 in v's dtype."""
    q, k, v, xh, bias, gw, gb, ga = _inputs(20)
    rows = tfa.gate_rows(*map(torch.from_numpy, (xh, gw, gb, ga))).numpy()
    cj, ct = _cast(dtype)
    want = jfa.flash_attention_gated_bias_rows(
        *map(cj, (q, k, v)), jnp.asarray(rows), jnp.asarray(bias),
        jnp.asarray(LENGTHS, jnp.int32), block_q=128)
    got = tfa.gated_bias_attention_rows(*map(ct, (q, k, v)), torch.from_numpy(rows),
                                        torch.from_numpy(bias), torch.tensor(LENGTHS))
    assert _valid_rows_max(got.float(), want, LENGTHS) < TOL[dtype]


def test_schedules_agree_with_k3_at_f32_and_count_no_cpu_launch():
    """K3, K8 and K9 compute one function: at f32 on a ragged, untiled
    length (T = 150) the three plain versions agree to 1e-5; CPU tensors
    launch nothing."""
    rng = np.random.RandomState(30)
    q, k, v, xh = (torch.from_numpy((rng.randn(2, 3, 150, 64) * 0.3).astype(np.float32))
                   for _ in range(4))
    bias = torch.from_numpy(rng.randn(3, 150, 150).astype(np.float32))
    gw, gb = torch.randn(64, 8) * 0.2, torch.randn(8) * 0.1
    ga = 1 + 0.1 * torch.randn(3)
    lens = torch.tensor([150, 77])
    kernels.reset_launch_counts()
    k3 = tfa.gated_bias_attention(q, k, v, xh, bias, gw, gb, ga, lens)
    k8 = tfa.gated_bias_attention(q, k, v, xh, bias, gw, gb, ga, lens, batch_block=True)
    k9 = tfa.gated_bias_attention_rows(q, k, v, tfa.gate_rows(xh, gw, gb, ga), bias, lens)
    for got in (k8, k9):
        assert _valid_rows_max(got, k3, [150, 77]) < 1e-5
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert tfa.flash_bias_rows_usable(24, 12, 1496, 64)
    assert not tfa.flash_bias_rows_usable(24, 12, 1496, 128)


def _beats_cfgs(**kw):
    shape = dict(dim=128, embed_dim=32, n_heads=2, n_layers=2, conv_pos=16,
                 conv_pos_groups=4, rel_pos_buckets=32, rel_pos_max_distance=16)
    return jbeats.BeatsConfig(**shape, **kw), tbeats.BeatsConfig(**shape, **kw)


def _wav(seed):
    return (np.random.RandomState(seed).randn(2, 32000) * 0.05).astype(np.float32)


def test_beats_lean_bias_flash_matches_jax(monkeypatch):
    """BEATs with ``lean_bias_flash``: JAX pads 96 tokens to 128 and takes its
    rows kernel (the TPU route, Pallas in interpret mode); the port keeps 96
    tokens and takes K9's plain version. f32, bound 1e-4 (the BEATs module
    test's)."""
    jcfg, tcfg = _beats_cfgs(lean_bias_flash=True)
    jp = jbeats.init_beats(jax.random.PRNGKey(0), jcfg)
    wav = _wav(4)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jbeats.beats_encode(dataclasses.replace(jcfg, use_flash=True), jp, jnp.asarray(wav))
    calls = []
    plain = tfa.gated_bias_rows_plain
    monkeypatch.setattr(tfa, "gated_bias_rows_plain",
                        lambda *a: calls.append(1) or plain(*a))
    got = tbeats.beats_encode(tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                                      device="cpu"), torch.from_numpy(wav))
    assert len(calls) == tcfg.n_layers and got.shape == want.shape == (2, 96, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["lean, gate closed", "lean, gate open"])
def test_beats_schedule_routes(monkeypatch, route):
    """``lean_bias_flash`` takes K9 where ``flash_bias_rows_usable`` holds
    and K3 where it does not, as in JAX. Both match the default encoder at
    f32 to 1e-5."""
    _, base = _beats_cfgs()
    params = tbeats.init_beats(base, torch.Generator().manual_seed(0), "cpu", torch.float32)
    wav = torch.from_numpy(_wav(5))
    want = tbeats.beats_encode(base, params, wav)
    calls = []
    cfg = dataclasses.replace(base, lean_bias_flash=True)
    if route == "lean, gate open":
        spied = "gated_bias_rows_plain"
    else:
        monkeypatch.setattr(tbeats, "flash_bias_rows_usable", lambda *a: False)
        spied = "gated_bias_attention_plain"
    plain = getattr(tfa, spied)
    monkeypatch.setattr(tfa, spied, lambda *a: calls.append(1) or plain(*a))
    got = tbeats.beats_encode(cfg, params, wav)
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_f32_exp2_form_is_k3s_arithmetic_at_bf16():
    """``pallas_rounding=False`` (the form the card's check holds K8 and K9
    to) keeps q's scale and the exp2 in f32 as the CUDA kernels do: at bf16
    it equals K3's plain version, whose kernel shares that arithmetic, to
    one bf16 step of the output (2^-7 × max |o|), with a mean difference
    below 1e-6; the Pallas rounding moves the mean by more than 1e-5."""
    q, k, v, xh, bias, gw, gb, ga = _inputs(40)
    _, ct = _cast("bf16")
    args = (*map(ct, (q, k, v, xh)), torch.from_numpy(bias), *map(torch.from_numpy, (gw, gb, ga)),
            torch.tensor(LENGTHS))
    k3 = tfa.gated_bias_attention_plain(*args).float()
    step = 2 ** -7 * k3.abs().max().item()
    f32_form = tfa.gated_bias_batched_plain(*args, pallas_rounding=False)
    rows_form = tfa.gated_bias_rows_plain(*args[:3], tfa.gate_rows(*args[3:4], *args[5:8]),
                                          args[4], args[8], pallas_rounding=False)
    pallas_form = tfa.gated_bias_batched_plain(*args)
    for got in (f32_form, rows_form):
        assert got.dtype == torch.bfloat16
        assert _valid_rows_max(got.float(), k3, LENGTHS) <= step
        assert (got.float() - k3).abs().mean() < 1e-6
    assert (pallas_form.float() - k3).abs().mean() > 1e-5


@pytest.mark.parametrize("S_", [300, 1496])
def test_tma_bias_rows_pads_rows_to_16_bytes(S_):
    """K3/K8 read the bias table by TMA, whose row strides must be 16-byte
    multiples: BEATs' S (a multiple of 8) passes the table in place; another
    S gets a copy padded with zeros to the next multiple of 8 keys."""
    bias = torch.randn(3, S_, S_).to(torch.bfloat16)
    table, row = tfa.tma_bias_rows(bias)
    assert row % 8 == 0 and row - S_ < 8 and table.stride(1) == row
    torch.testing.assert_close(table[..., :S_], bias, rtol=0, atol=0)
    if row == S_:
        assert table.data_ptr() == bias.data_ptr()
    else:
        assert torch.count_nonzero(table[..., S_:]) == 0
