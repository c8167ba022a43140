"""Each Hopper kernel of the port against its plain PyTorch version, on an
NVIDIA GPU. The tests carry the ``cuda`` marker and skip without a card.

This file imports no jax, so it also runs on the machine with the card:
    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
(``--noconftest`` because ``tests/conftest.py`` sets up jax). Bounds: bf16
outputs within 2e-2 of the f32-softmax plain version on valid rows, row
max m within 1e-3 and row sum l within 1e-3 relative (the flash forward),
the KV append (K4) bit-exact, and the quantizing append (K4 q8) bit for
bit to its plain version at the 13B int8 cache and small shapes, one
launch each; the decode step over an int8 cache K7 q8 cannot read (S =
1001) takes the plain attention math and does not raise; the backward kernels' bf16
gradients within 2e-2 × max |plain gradient| per tensor over valid rows, and
the int4 (K10) and int8 (W8A16) matmuls within 1e-2 × max |plain| of their
f32 plain versions on the same bf16 x. The flash-decode kernel (K7, bf16
and int8 cache) and the batched and row schedules of the gated-bias kernel
(K8, K9) are held to their plain versions within 2e-2, as the other
attention kernels are; the int8-cache instance also at every cluster size it
takes, and to the same bits on two calls. The streaming probe (K11) is held to its plain
version within 1e-5 × the largest block's Σ|x| (f32 sums in another order).
K10 also runs at forced partitions (column tile, cluster split) and must
give the same bits on two calls, in one kernel launch. The symbol
adapter's loss at salmonn-bench widths (one layer a stack) runs the
encoders and the decoder through the kernels, K5 and K6 included, and is
held to the f32 CPU path: the loss within 1e-2 relative, the LoRA and
``input_mlp`` gradients within 5e-2 × max |plain gradient|. Qwen2-Audio-7B's
tower run to its batch's longest clip is held to the same tower over the
30-s mel within 2e-2 × max |30-s tower| at every spliced position.
"""

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa
from icl_speech_text_llm_tpu_torch.ops import int4_matmul as tint4
from icl_speech_text_llm_tpu_torch.ops import quant as tquant


def _arrays(shapes, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _valid_rows_max(a, b, lengths):
    """max |a − b| over the first lengths[i] rows of each sample (0 when
    no row is valid)."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    return max([d[i, :, :n].max() for i, n in enumerate(lengths) if n] + [0.0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_inputs(shapes, dev, seed):
    return [torch.from_numpy(a).to(dev, torch.bfloat16) for a in _arrays(shapes, seed, 1.0)]


def _check_flash(o, m, l, o_p, m_p, l_p, rows):
    """o within 2e-2, m within 1e-3 and l within 1e-3 relative of the plain
    version over valid rows; a row without a valid key has l = 0, o = 0
    and m = -inf, as the plain version's."""
    assert _valid_rows_max(o.float().cpu(), o_p.float().cpu(), rows) < 2e-2
    m, m_p, l, l_p = (t.cpu() for t in (m, m_p, l, l_p))
    empty = l_p == 0
    assert torch.equal(l == 0, empty) and torch.all(o.cpu()[empty] == 0)
    assert torch.all(m[empty] == -np.inf)
    m = torch.where(empty, torch.zeros_like(m), m)
    m_p = torch.where(empty, torch.zeros_like(m_p), m_p)
    assert _valid_rows_max(m[..., None], m_p[..., None], rows) < 1e-3
    rel = torch.where(empty, torch.ones_like(l), l / torch.where(empty, torch.ones_like(l_p), l_p))
    assert _valid_rows_max(rel[..., None], torch.ones_like(rel)[..., None], rows) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("causal,D,H,Hkv,S,lengths", [
    (True, 128, 4, 4, 200, [200, 77]), (True, 128, 4, 2, 200, [200, 1]),
    (False, 64, 4, 4, 200, [200, 130]), (False, 64, 4, 4, 200, None),
    (False, 64, 4, 4, 1500, None),            # Whisper's ragged last key tile (92 rows)
    (False, 128, 4, 4, 300, [300, 0]),        # a sample with no key
    (True, 128, 4, 4, 300, [0, 1]),           # lengths 0 and 1
    (True, 128, 8, 2, 256, [256, 100]),       # GQA n_rep 4
    (False, 64, 8, 1, 300, [1, 300]),         # GQA n_rep 8
    (True, 64, 6, 3, 333, [333, 200]),        # causal at D = 64 (192-row blocks)
    (True, 128, 7, 1, 256, [256, 100]),       # Qwen2-7B's n_rep 7
    (True, 128, 14, 2, 300, [300, 131]),      # n_rep 7 over two kv heads
    (False, 64, 4, 4, 1500, [250, 1500]),     # Qwen2-Audio's tower: 5 s and 30 s clips
])
def test_cuda_flash_kernel_matches_plain(cuda_device, causal, D, H, Hkv, S, lengths):
    B = 2
    q, = _cuda_inputs([(B, H, S, D)], cuda_device, 20)
    k, v = _cuda_inputs([(B, Hkv, S, D)] * 2, cuda_device, 21)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda_device)
    fn = tfa.flash_attention_causal if causal else tfa.flash_attention_noncausal
    before = fn.launches
    o, m, l = fn(q, k, v, lens)
    assert fn.launches == before + 1
    o_p, m_p, l_p = tfa.flash_attention_plain(q, k, v, lens, causal)
    _check_flash(o, m, l, o_p, m_p, l_p, [S] * B)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,D", [(True, 128), (False, 64)])
def test_cuda_flash_kernel_reads_fused_qkv_views(cuda_device, causal, D):
    """q, k, v as strided views of one (B, S, 3, H, D) tensor, the output
    written into a view of the same layout's strides: the tensor maps take
    the strides as they come."""
    B, S, H = 2, 300, 4
    qkv, = _cuda_inputs([(B, S, 3, H, D)], cuda_device, 33)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    lens = torch.tensor([300, 151], device=cuda_device)
    fn = tfa.flash_attention_causal if causal else tfa.flash_attention_noncausal
    o, m, l = fn(q, k, v, lens)
    o_p, m_p, l_p = tfa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                              lens, causal)
    _check_flash(o, m, l, o_p, m_p, l_p, [S] * B)


@pytest.mark.cuda
def test_cuda_gated_bias_kernel_matches_plain(cuda_device):
    B, H, S, D = 2, 3, 300, 64
    q, k, v, xh = _cuda_inputs([(B, H, S, D)] * 4, cuda_device, 22)
    bias, = _cuda_inputs([(H, S, S)], cuda_device, 23)
    grep_w = torch.randn(D, 8, device=cuda_device) * 0.2
    grep_b = torch.randn(8, device=cuda_device) * 0.1
    grep_a = 1 + 0.1 * torch.randn(H, device=cuda_device)
    lens = torch.tensor([300, 111], device=cuda_device)
    args = (q, k, v, xh, bias, grep_w, grep_b, grep_a, lens)
    o = tfa.gated_bias_attention(*args)
    o_p = tfa.gated_bias_attention_plain(*args)
    assert _valid_rows_max(o.float().cpu(), o_p.float().cpu(), [300, 111]) < 2e-2


#: append positions: the first row, the last, inside, and −1 and S (outside
#: the cache: nothing is written)
def _append_positions(B, S):
    return torch.tensor([[0, S - 1, -1, S, 17, S // 2][i % 6] for i in range(B)],
                        dtype=torch.int32)


def _past_one_wave(threads, dev):
    """True when an append kernel's grid-stride loop takes a second pass:
    its ``threads`` (one a 16-byte vector for K4, D / 8 lanes, rounded up to
    a power of two, a row for K4 q8) outnumber the most one wave of the
    card holds (2048 resident threads an SM)."""
    return threads > kernels.sm_count(dev.index or 0) * 2048


#: an append case with more rows than one wave holds: 36,864 rows
WAVE_CASE = (48, 16, 48, 24, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("L,B,Hkv,S,D", [(3, 2, 4, 256, 128), (2, 16, 4, 64, 128),
                                         (3, 4, 2, 96, 64), WAVE_CASE])
def test_cuda_append_kv_kernel_is_exact(cuda_device, dtype, L, B, Hkv, S, D):
    """bf16 cache, and an int8 cache with rows the caller quantized; B = 16,
    D = 64, more rows than one wave of the grid holds (its loop takes a
    second pass), positions −1 and S (not written)."""
    if (L, B, Hkv, S, D) == WAVE_CASE:
        assert _past_one_wave(L * B * Hkv * D * dtype.itemsize // 16, cuda_device)
    ck, cv = (t.mul(50).to(dtype) for t in _cuda_inputs([(L, B, Hkv, S, D)] * 2, cuda_device, 24))
    nk, nv = (t.mul(50).to(dtype) for t in _cuda_inputs([(L, B, Hkv, 1, D)] * 2, cuda_device, 25))
    pos = (torch.tensor([255, 17], dtype=torch.int32) if B == 2 else
           _append_positions(B, S)).to(cuda_device)
    ck2, cv2 = ck.clone(), cv.clone()
    before = tfa.append_kv.launches
    tfa.append_kv(ck, cv, nk, nv, pos)
    tfa.append_kv_plain(ck2, cv2, nk, nv, pos)
    torch.cuda.synchronize()
    assert tfa.append_kv.launches == before + 1
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)


def _q8_rows(L, B, Hkv, D, dev, dtype, seed):
    """New rows (L, B, Hkv, 1, D) for K4 q8: random, one all-zero row, and
    rows of exact .5 ties at scale 1 (amax 127: ±0.5, ±1.5, ±2.5) and at
    scale 2 (amax 254: ±1, ±3, ±5)."""
    x, = _arrays([(L, B, Hkv, 1, D)], seed, 2.0)
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5], np.float32)
    x[0, 0, 0, 0] = 0.0
    if L * B * Hkv > 1:
        x[-1, -1, -1, 0] = 0.0
        x[-1, -1, -1, 0, :6], x[-1, -1, -1, 0, 6] = ties, 127.0
    if B > 1:
        x[0, -1, 0, 0] = 0.0
        x[0, -1, 0, 0, :6], x[0, -1, 0, 0, 6] = 2 * ties, -254.0
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,B,Hkv,S,D", [(40, 4, 40, 1152, 128), (1, 1, 1, 16, 128),
                                         (3, 8, 2, 64, 64), (2, 16, 5, 40, 128),
                                         (32, 4, 1, 24, 64), (1, 5, 40, 8, 128),
                                         (40, 16, 40, 24, 128), (48, 16, 48, 24, 64)])
def test_cuda_append_kv_q8_kernel_is_bit_identical_to_plain(cuda_device, dtype, L, B, Hkv, S, D):
    """K4 q8 against ``append_kv_q8_plain`` on the card, bit for bit (int8
    rows and f32 scales): bf16 and f32 rows; the 13B int8 shape and L, B,
    Hkv of 1-40; D = 64 and 128; an all-zero row (scale 0, bytes 0) and .5
    ties; positions 0, S − 1 and inside, and −1 and S, which leave the cache
    and scales as they were; at 16 rows of the 13B shape and at D = 64,
    more rows than one wave of the grid holds (its loop takes a second
    pass). The plain version on the card gives the CPU's bytes too
    (``quantize_kv`` divides on both)."""
    if B == 16 and L >= 40:
        assert _past_one_wave(L * B * Hkv * D // 8, cuda_device)
    ck, cv = (torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=cuda_device)
              for _ in range(2))
    ks, vs = (torch.rand((L, B, Hkv, S), device=cuda_device) for _ in range(2))
    nk, nv = (_q8_rows(L, B, Hkv, D, cuda_device, dtype, seed) for seed in (60, 61))
    pos = (_append_positions(B, S) if B > 1 else torch.tensor([S - 1], dtype=torch.int32)).to(
        cuda_device)
    cache, plain = [ck, cv, ks, vs], [t.clone() for t in (ck, cv, ks, vs)]
    init, cpu = [t.clone() for t in cache], [t.cpu() for t in cache]
    before = tfa.append_kv_q8.launches
    tfa.append_kv_q8(*cache, nk, nv, pos)
    tfa.append_kv_q8_plain(*plain, nk, nv, pos)
    tfa.append_kv_q8_plain(*cpu, nk.cpu(), nv.cpu(), pos.cpu())
    torch.cuda.synchronize()
    assert tfa.append_kv_q8.launches == before + 1
    for got, want, host in zip(cache, plain, cpu):
        assert torch.equal(got, want) and torch.equal(want.cpu(), host)
    for b in range(B):
        p = int(pos[b])
        for got, old in zip(cache, init):
            if 0 <= p < S:  # only row p of sample b moved
                assert torch.equal(got[:, b, :, :p], old[:, b, :, :p])
                assert torch.equal(got[:, b, :, p + 1:], old[:, b, :, p + 1:])
            else:
                assert torch.equal(got[:, b], old[:, b])
    assert torch.all(ks[0, 0, 0, int(pos[0])] == 0)  # the all-zero row
    assert torch.all(ck[0, 0, 0, int(pos[0])] == 0)


@pytest.mark.cuda
def test_cuda_append_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """No copy on the way in: new rows of another dtype than the cache or
    rows not a multiple of 16 bytes (K4), int8 rows or a head_dim not a
    multiple of 8 (K4 q8), rows not contiguous, int64 positions — each
    raises."""
    ck, cv = _cuda_inputs([(2, 2, 2, 16, 128)] * 2, cuda_device, 62)
    nk, nv = _cuda_inputs([(2, 2, 2, 1, 128)] * 2, cuda_device, 63)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tfa.append_kv(ck, cv, nk.float(), nv.float(), pos)
    with pytest.raises(ValueError):
        tfa.append_kv(ck, cv, nk, nv, pos.long())
    wide = _cuda_inputs([(2, 2, 2, 1, 256)], cuda_device, 64)[0][..., ::2]
    with pytest.raises(ValueError):
        tfa.append_kv(ck, cv, wide, wide, pos)
    c8 = torch.zeros((2, 2, 2, 16, 8), dtype=torch.int8, device=cuda_device)
    n8 = torch.zeros((2, 2, 2, 1, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.append_kv(c8, c8.clone(), n8, n8.clone(), pos)
    q8 = [torch.zeros((2, 2, 2, 16, 128), dtype=torch.int8, device=cuda_device) for _ in range(2)]
    sc = [torch.zeros((2, 2, 2, 16), device=cuda_device) for _ in range(2)]
    with pytest.raises(TypeError):
        tfa.append_kv_q8(*q8, *sc, nk.to(torch.int8), nv.to(torch.int8), pos)
    q12 = [torch.zeros((2, 2, 2, 16, 12), dtype=torch.int8, device=cuda_device) for _ in range(2)]
    n12 = torch.zeros((2, 2, 2, 1, 12), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.append_kv_q8(*q12, *sc, n12, n12, pos)
    assert tfa.append_kv_q8(*q8, *sc, nk, nv, pos)[0] is q8[0]


@pytest.mark.cuda
def test_cuda_append_kernels_are_one_launch(cuda_device):
    """Each append wrapper is one kernel on the card, nothing else (no cast,
    copy or scale write beside it)."""
    from torch.profiler import ProfilerActivity, profile

    ck, cv = _cuda_inputs([(4, 4, 8, 64, 128)] * 2, cuda_device, 65)
    nk, nv = _cuda_inputs([(4, 4, 8, 1, 128)] * 2, cuda_device, 66)
    q8 = [torch.zeros((4, 4, 8, 64, 128), dtype=torch.int8, device=cuda_device) for _ in range(2)]
    sc = [torch.zeros((4, 4, 8, 64), device=cuda_device) for _ in range(2)]
    pos = torch.tensor([0, 63, 9, 30], dtype=torch.int32, device=cuda_device)
    runs = (lambda: tfa.append_kv(ck, cv, nk, nv, pos),
            lambda: tfa.append_kv_q8(*q8, *sc, nk, nv, pos))
    for run in runs:
        run()
    torch.cuda.synchronize()
    # one profiling session for both: the device events in launch order
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for run in runs:
            run()
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    assert "append_kv_kernel" in names[0] and "append_kv_q8_kernel" in names[1], names


@pytest.mark.cuda
def test_cuda_decode_step_over_an_int8_cache_k7_q8_cannot_read(cuda_device):
    """``decode_step`` with ``attention=FLASH`` over ``init_kv_cache(quant=True)``
    of S = 1001 on the card: K7 q8's wrapper refuses that layout, so the step
    decodes with the plain math (no K7 q8 launch) and does not raise; its one
    append is K4 q8. At S = 1152 the same step runs K7 q8 a layer. Both give
    finite hidden states."""
    from icl_speech_text_llm_tpu_torch.models import llama as tllama

    cfg = tllama.DecoderConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                               hidden_dim=1024, max_seq_len=2048)
    assert cfg.hd == 128
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tllama.init_decoder(cfg, gen, cuda_device, torch.bfloat16)
    x, = _cuda_inputs([(3, 1, cfg.dim)], cuda_device, 67)
    cur = torch.tensor([700, 0, 998], dtype=torch.int32, device=cuda_device)
    for S, q8_launches in ((1001, 0), (1152, cfg.n_layers)):
        cache = tllama.init_kv_cache(cfg, 3, S, device=cuda_device, quant=True)
        kernels.reset_launch_counts()
        h, cache = tllama.decode_step(cfg, params, x, cache, cur,
                                      attention=tllama.DecodeAttention.FLASH)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["flash_decode_attention_q8"] == q8_launches, counts
        assert counts["append_kv_q8"] == 1 and counts["append_kv"] == 0, counts
        assert torch.isfinite(h).all() and h.shape == (3, 1, cfg.dim)
        k_s = cache["k_s"][:, 2]
        assert torch.all(k_s[:, :, 998] > 0) and torch.all(k_s[:, :, 999] == 0)


def _grad_err(got, want, rows):
    """max |got − want| over valid rows, relative to max |want| there."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    return _valid_rows_max(got, want, rows) / max(
        _valid_rows_max(want, np.zeros_like(want), rows), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,D,H,Hkv,S,lengths,fused", [
    (True, 128, 4, 4, 200, [200, 77], False), (True, 128, 4, 2, 256, [256, 1], False),
    (False, 64, 4, 4, 200, [200, 130], False), (False, 64, 2, 2, 150, None, False),
    (True, 64, 8, 2, 256, [256, 190], False),   # D = 64 causal, GQA n_rep 4
    (True, 128, 4, 4, 300, [300, 150], False),  # S = 300: no multiple of 64
    (False, 64, 4, 4, 300, [300, 65], False),
    (True, 128, 4, 2, 200, [200, 0], False),    # a sample of length 0
    (False, 64, 8, 1, 300, [1, 300], False),    # GQA n_rep 8
    (True, 128, 4, 4, 300, [300, 201], True),   # fused QKV views, strided do
    (False, 64, 4, 4, 200, [200, 130], True),
    (True, 128, 7, 1, 256, [256, 147], False),  # Qwen2-7B's n_rep 7
    (True, 128, 14, 2, 300, [300, 131], False),  # n_rep 7 over two kv heads
    (False, 128, 7, 1, 256, [100, 256], False)])
def test_cuda_flash_backward_kernels_match_plain(cuda_device, causal, D, H, Hkv, S, lengths,
                                                 fused):
    """K5 (dq, delta) and K6 (dk, dv) against flash_attention_bwd_plain on the
    same bf16 inputs computed in f32; do is zero past each length. ``fused``:
    q, k, v are strided views of one (B, S, 3, H, D) tensor and do a
    transposed view of a (B, S, H, D) one, as the model's layouts give them.
    A sample of length 0 gets dq = dk = dv = 0."""
    B = 2
    if fused:
        qkv, do = _cuda_inputs([(B, S, 3, H, D), (B, S, H, D)], cuda_device, 26)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = do.transpose(1, 2)
        assert not (q.is_contiguous() or do.is_contiguous())
    else:
        q, do = _cuda_inputs([(B, H, S, D)] * 2, cuda_device, 26)
        k, v = _cuda_inputs([(B, Hkv, S, D)] * 2, cuda_device, 27)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda_device)
    rows = [S] * B if lengths is None else lengths
    if lengths is not None:
        keep = torch.arange(S, device=cuda_device)[None, :] < lens[:, None]
        do = do.mul_(keep[:, None, :, None].to(do.dtype))
    fwd = tfa.flash_attention_causal if causal else tfa.flash_attention_noncausal
    o, m, l = fwd(q, k, v, lens)
    before = (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    dq, delta = tfa.flash_attention_bwd_dq(q, k, v, o, m, l, do, lens, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, m, l, delta, do, lens, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), m, l,
                                         do.float(), lens, causal)
    q_rows = [S] * B if not causal else rows
    assert _grad_err(dq, want[0], q_rows) < 2e-2
    assert _grad_err(dk, want[1], rows) < 2e-2
    assert _grad_err(dv, want[2], rows) < 2e-2
    np.testing.assert_allclose(delta.cpu().numpy(), (do.float() * o.float()).sum(-1).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    if lengths is not None:  # key rows past the length get exact zeros
        for i, n in enumerate(lengths):
            assert torch.all(dk[i, :, n:] == 0) and torch.all(dv[i, :, n:] == 0)
            if n == 0:
                assert torch.all(dq[i] == 0)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()


@pytest.mark.cuda
def test_cuda_flash_attention_function_trains_through_the_kernels(cuda_device):
    """flash_attention with inputs that require grad: forward K1, backward
    K5 + K6, gradients like autograd through the plain forward."""
    B, H, S, D = 2, 4, 192, 128
    q, = _cuda_inputs([(B, H, S, D)], cuda_device, 28)
    k, v = _cuda_inputs([(B, 2, S, D)] * 2, cuda_device, 29)
    lens = torch.tensor([192, 100], device=cuda_device)
    w, = _cuda_inputs([(B, H, S, D)], cuda_device, 30)
    w = w * (torch.arange(S, device=cuda_device)[None, :] < lens[:, None])[:, None, :, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = kernels.launch_counts()
    (tfa.flash_attention(*leaves, lens, causal=True).float() * w.float()).sum().backward()
    after = kernels.launch_counts()
    for name in ("flash_attention_causal", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == counts[name] + 1, name
    ref = [t.float().clone().requires_grad_() for t in (q, k, v)]
    (tfa.flash_attention_plain(*ref, lens, True)[0] * w.float()).sum().backward()
    for got, want in zip(leaves, ref):
        assert _grad_err(got.grad, want.grad, [192, 192]) < 2e-2


@pytest.mark.cuda
def test_cuda_forward_kernels_refuse_inputs_that_need_grad(cuda_device):
    """A ctypes-filled output has no grad_fn: the forward wrappers raise
    instead of dropping the gradient; under no_grad they run."""
    q, k, v, xh = (t.requires_grad_() for t in _cuda_inputs([(1, 2, 64, 64)] * 4, cuda_device, 31))
    bias, = _cuda_inputs([(2, 64, 64)], cuda_device, 32)
    gw, gb, ga = (torch.zeros(64, 8, device=cuda_device), torch.zeros(8, device=cuda_device),
                  torch.ones(2, device=cuda_device))
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa.flash_attention_causal(q, k, v)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa.flash_attention_noncausal(q, k, v)
    with pytest.raises(RuntimeError, match="requires grad"):
        tfa.gated_bias_attention(q, k, v, xh, bias, gw, gb, ga)
    with torch.no_grad():
        assert tfa.flash_attention_causal(q, k, v)[0].shape == q.shape
        assert tfa.gated_bias_attention(q, k, v, xh, bias, gw, gb, ga).shape == q.shape


def _wq_err(y, ref):
    """max |y − ref| relative to max |ref|."""
    return ((y.float() - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group", [
    (4, 1024, 384, 128), (1, 512, 128, 128), (33, 1024, 256, 256), (256, 512, 512, 128),
    (4, 2048, 640, 128),
    # Qwen2-7B's widths: wk/wv (N = 512), w_gate/w_up, w_down (K = 18944)
    (4, 3584, 512, 128), (4, 3584, 18944, 128), (4, 18944, 3584, 128)])
def test_cuda_int4_kernel_matches_plain(cuda_device, M, K, N, group):
    """K10 at decode (one 16-row tile, K split over blocks) and prefill row
    counts (64-row tiles, a ragged last tile), groups of 128 and 256."""
    w, = _arrays([(K, N)], 40, 0.05)
    qt = {k: v.to(cuda_device) for k, v in tquant.quantize_tensor_int4(
        torch.from_numpy(w), group=group).items()}
    x, = _cuda_inputs([(M, K)], cuda_device, 41)
    before = tint4.int4_matmul.launches
    y = tint4.int4_matmul(x, qt["q4"], qt["s"])
    torch.cuda.synchronize()
    assert tint4.int4_matmul.launches == before + 1 and y.dtype == torch.bfloat16
    assert _wq_err(y, tint4.int4_matmul_plain(x.float(), qt["q4"], qt["s"])) < 1e-2


def _int4_case(dev, M, K, N, group=128, seed=48):
    w, = _arrays([(K, N)], seed, 0.05)
    qt = {k: v.to(dev) for k, v in tquant.quantize_tensor_int4(
        torch.from_numpy(w), group=group).items()}
    x, = _cuda_inputs([(M, K)], dev, seed + 1)
    return x, qt["q4"], qt["s"]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group", [
    (1, 5120, 256, 128), (16, 5120, 256, 128), (17, 5120, 256, 128), (64, 5120, 256, 128),
    (4, 5120, 128, 128), (4, 5120, 384, 256)])
def test_cuda_int4_kernel_matches_plain_at_decode_k(cuda_device, M, K, N, group):
    """K10 at the 13B hidden size: the row counts on both sides of the
    16-row tile, one column tile (N = 128), groups of 256."""
    x, packed, scales = _int4_case(cuda_device, M, K, N, group)
    y = tint4.int4_matmul(x, packed, scales)
    torch.cuda.synchronize()
    assert _wq_err(y, tint4.int4_matmul_plain(x.float(), packed, scales)) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n,splits", [(128, 1), (128, 8), (64, 1), (64, 8)])
@pytest.mark.parametrize("M", [4, 40])
def test_cuda_wq_kernels_match_plain_at_forced_partitions(cuda_device, monkeypatch, tile_n,
                                                          splits, M):
    """Both column tiles with no split and with a cluster of 8, forced
    through ``partition``, for K10 and K12."""
    monkeypatch.setattr(tint4, "partition", lambda *shape: (tile_n, splits))
    x, packed, scales = _int4_case(cuda_device, M, 2048, 256)
    y = tint4.int4_matmul(x, packed, scales)
    assert _wq_err(y, tint4.int4_matmul_plain(x.float(), packed, scales)) < 1e-2
    w, = _arrays([(1024, 256)], 50, 0.05)
    qt = {k: v.to(cuda_device) for k, v in tquant.quantize_tensor(torch.from_numpy(w)).items()}
    y8 = tint4.int8_matmul(x[:, :1024].contiguous(), qt["q"], qt["s"])
    torch.cuda.synchronize()
    assert _wq_err(y8, tint4.int8_matmul_plain(x[:, :1024].float(), qt["q"], qt["s"])) < 1e-2


#: CUgraphNodeType of a kernel node (cuda.h)
_CU_GRAPH_NODE_TYPE_KERNEL = 0


def _captured_nodes(fn):
    """A CUDA graph captured from one call of ``fn`` (its result kept as
    ``graph.output``) and the CUgraphNodeType of each of its nodes, read by
    ``cuGraphGetNodes`` / ``cuGraphNodeGetType`` of the driver library."""
    import ctypes

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        graph.output = fn()
    driver = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert driver.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    graph.instantiate()
    return graph, types


@pytest.mark.cuda
def test_cuda_int4_kernel_is_deterministic_and_one_launch(cuda_device):
    """The split-K sum runs in rank order inside the cluster: two calls on
    the same inputs give the same bits, and a call is one kernel on the
    card (no reduce kernel, no memset): a CUDA graph captured from one call
    holds one node, a kernel node, whose replay alone gives the same bits.
    The graph's nodes are read through the driver API, not a profiler
    window (whose CUDA events CUPTI has dropped on this card)."""
    x, packed, scales = _int4_case(cuda_device, 4, 5120, 5120)
    assert tint4.partition(4, 5120, 2560 // tint4.STEP_ROWS,
                           torch.cuda.get_device_properties(0).multi_processor_count)[1] > 1
    y1 = tint4.int4_matmul(x, packed, scales)
    y2 = tint4.int4_matmul(x, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    before = tint4.int4_matmul.launches
    graph, types = _captured_nodes(lambda: tint4.int4_matmul(x, packed, scales))
    assert tint4.int4_matmul.launches == before + 1
    assert types == [_CU_GRAPH_NODE_TYPE_KERNEL], types
    graph.output.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.output, y1)


@pytest.mark.cuda
def test_cuda_int4_kernel_reads_a_stacked_layer_in_place(cuda_device):
    L, M, K, N = 3, 4, 1024, 256
    w, = _arrays([(L, K, N)], 42, 0.05)
    qt = {k: v.to(cuda_device) for k, v in tquant.quantize_tensor_int4(torch.from_numpy(w)).items()}
    x, = _cuda_inputs([(M, K)], cuda_device, 43)
    for layer in range(L):
        y = tint4.int4_matmul(x, qt["q4"][layer], qt["s"][layer])
        ref = tint4.int4_matmul_plain(x.float(), qt["q4"][layer], qt["s"][layer])
        assert _wq_err(y, ref) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 1024, 256), (17, 512, 384), (256, 1024, 128),
                                   (4, 2560, 1280),
                                   # Qwen2-7B's widths
                                   (4, 3584, 512), (4, 3584, 18944), (4, 18944, 3584)])
def test_cuda_int8_kernel_matches_plain(cuda_device, M, K, N):
    w, = _arrays([(K, N)], 44, 0.05)
    qt = {k: v.to(cuda_device) for k, v in tquant.quantize_tensor(torch.from_numpy(w)).items()}
    x, = _cuda_inputs([(M, K)], cuda_device, 45)
    before = tint4.int8_matmul.launches
    y = tint4.int8_matmul(x, qt["q"], qt["s"])
    torch.cuda.synchronize()
    assert tint4.int8_matmul.launches == before + 1 and y.dtype == torch.bfloat16
    assert _wq_err(y, tint4.int8_matmul_plain(x.float(), qt["q"], qt["s"])) < 1e-2


@pytest.mark.cuda
def test_cuda_dequant_matmul_routes_by_rows(cuda_device):
    """Up to 1024 rows on the card go to the kernels; more take the plain
    dequantized route, as the JAX package's gate sends them to XLA."""
    w, = _arrays([(512, 256)], 46, 0.05)
    q4 = {k: v.to(cuda_device) for k, v in tquant.quantize_tensor_int4(torch.from_numpy(w)).items()}
    q8 = {k: v.to(cuda_device) for k, v in tquant.quantize_tensor(torch.from_numpy(w)).items()}
    counts = kernels.launch_counts()
    for rows, launched in ((4, 1), (1024, 1), (1030, 0)):
        x, = _cuda_inputs([(2, rows // 2, 512)], cuda_device, 47)
        for w_, name in ((q4, "int4_matmul"), (q8, "int8_matmul")):
            y = tquant.dequant_matmul(x, w_)
            assert y.shape == (2, rows // 2, 256)
            now = kernels.launch_counts()
            assert now[name] - counts[name] == launched, (rows, name)
            counts = now
    with pytest.raises(TypeError):
        tint4.int4_matmul(x.float()[0, :4], q4["q4"], q4["s"])


def _attn_bound(ref):
    """2e-2 × max |plain| (~2.5 bf16 steps of the largest output), never
    above 2e-2."""
    return min(2e-2, 2e-2 * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,quant", [(4, 4, False), (4, 2, False), (7, 1, False),
                                         (4, 4, True), (4, 2, True)])
def test_cuda_flash_decode_kernel_matches_plain(cuda_device, H, Hkv, quant):
    """K7 on a stacked (L, B, Hkv, S, D) cache read at a layer, ragged
    lengths (one sample with no cached row), with and without the self
    column; bf16 and int8 (scales from quantize_kv) caches."""
    L, B, S, D = 3, 3, 300, 128
    q, = _cuda_inputs([(B, H, 1, D)], cuda_device, 50)
    ck, cv = _cuda_inputs([(L, B, Hkv, S, D)] * 2, cuda_device, 51)
    kn, vn = _cuda_inputs([(B, Hkv, 1, D)] * 2, cuda_device, 52)
    lens = torch.tensor([300, 131, 0], device=cuda_device)
    if quant:
        (ck, ks), (cv, vs) = tquant.quantize_kv(ck), tquant.quantize_kv(cv)
        fn, args = tfa.flash_decode_attention_q8, (q, ck, cv, ks, vs, lens)
    else:
        fn, args = tfa.flash_decode_attention, (q, ck, cv, lens)
    for layer in (0, 2):
        for self_kv in (None, (kn, vn)):
            before = fn.launches
            o = fn(*args, self_kv=self_kv, layer=layer)
            torch.cuda.synchronize()
            assert fn.launches == before + 1 and o.shape == (B, H, 1, D)
            cache = [t[layer] for t in args[1:-1]]
            ref = tfa.flash_decode_attention_plain(
                q, cache[0], cache[1], lens, self_kv=self_kv,
                k_s=cache[2] if quant else None, v_s=cache[3] if quant else None)
            assert (o.float() - ref.float()).abs().max().item() < _attn_bound(ref)
            if self_kv is None:
                assert torch.all(o[2] == 0)  # no key at all: o = 0


#: the 13B cache length's ragged lengths: full, 1, 0, the main path's ~900,
#: and lengths around the kernel's 64-row tiles and 4-row rank starts
Q8_LENGTHS = [1152, 1, 0, 901, 3, 7, 64, 65, 127, 128, 129, 500, 1000, 1151, 2, 900]


def _q8_case(dev, B, Hkv, n_rep, S=1152, L=2, seed=53):
    D = 128
    q, = _cuda_inputs([(B, Hkv * n_rep, 1, D)], dev, seed)
    ck, cv = _cuda_inputs([(L, B, Hkv, S, D)] * 2, dev, seed + 1)
    kn, vn = _cuda_inputs([(B, Hkv, 1, D)] * 2, dev, seed + 2)
    (ck, ks), (cv, vs) = tquant.quantize_kv(ck), tquant.quantize_kv(cv)
    lens = torch.tensor(Q8_LENGTHS[:B], dtype=torch.int32, device=dev)
    return q, (ck, cv, ks, vs), lens, (kn, vn)


def _q8_check(q, cache, lens, self_kv, layer):
    """K7 q8 twice (the same bits: the merge runs in a fixed order) against
    its plain version; a sample with no row and no self column gives 0."""
    before = tfa.flash_decode_attention_q8.launches
    o1 = tfa.flash_decode_attention_q8(q, *cache, lens, self_kv=self_kv, layer=layer)
    o2 = tfa.flash_decode_attention_q8(q, *cache, lens, self_kv=self_kv, layer=layer)
    torch.cuda.synchronize()
    assert tfa.flash_decode_attention_q8.launches == before + 2
    assert torch.equal(o1, o2)
    c = [t[layer] for t in cache]
    ref = tfa.flash_decode_attention_plain(q, c[0], c[1], lens, self_kv=self_kv,
                                           k_s=c[2], v_s=c[3])
    assert (o1.float() - ref.float()).abs().max().item() < _attn_bound(ref)
    if self_kv is None:
        assert torch.all(o1[lens.cpu() == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rep", [1, 4, 7, 8])
@pytest.mark.parametrize("B", [4, 16])
def test_cuda_flash_decode_q8_kernel_at_the_13b_cache_length(cuda_device, n_rep, B):
    """K7 q8 at S = 1152 with the lengths ``Q8_LENGTHS``, n_rep 1, 4, 7 and 8,
    B = 4 and 16 (at Hkv = 8 on an H100 clusters of 8 and of 4 blocks), with
    and without the self column."""
    q, cache, lens, self_kv = _q8_case(cuda_device, B, 8, n_rep)
    for sk in (None, self_kv):
        _q8_check(q, cache, lens, sk, layer=1)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_cuda_flash_decode_q8_kernel_at_forced_splits(cuda_device, monkeypatch, splits):
    """Every cluster size the kernel takes gives the plain version's output,
    c = 1 (no merge across blocks) included."""
    monkeypatch.setattr(tfa, "decode_splits", lambda *shape: splits)
    q, cache, lens, self_kv = _q8_case(cuda_device, 16, 4, 2, S=1152, seed=57)
    for sk in (None, self_kv):
        _q8_check(q, cache, lens, sk, layer=0)


@pytest.mark.cuda
def test_cuda_flash_decode_q8_refuses_a_cache_strided_along_s(cuda_device):
    q, (ck, cv, ks, vs), lens, _ = _q8_case(cuda_device, 4, 4, 1, S=256)
    with pytest.raises(ValueError, match="contiguous along"):
        tfa.flash_decode_attention_q8(q, ck[0, :, :, ::2], cv[0, :, :, ::2],
                                      ks[0, :, :, ::2].contiguous(),
                                      vs[0, :, :, ::2].contiguous(), torch.clamp(lens, max=128))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [300, 1496])
def test_cuda_gated_bias_schedules_match_plain(cuda_device, S):
    """K8 (batch_block) and K9 (gate rows) at a batch that is not a multiple
    of K8's 4-sample chunk, ragged lengths and the BEATs length 1496, held to
    the f32-exp2 form of their plain versions (the kernels' arithmetic)."""
    B, H, D = 5, 2, 64
    q, k, v, xh = _cuda_inputs([(B, H, S, D)] * 4, cuda_device, 53)
    bias, = _cuda_inputs([(H, S, S)], cuda_device, 54)
    grep_w = torch.randn(D, 8, device=cuda_device) * 0.2
    grep_b = torch.randn(8, device=cuda_device) * 0.1
    grep_a = 1 + 0.1 * torch.randn(H, device=cuda_device)
    lens_list = [S, S - 100, 77, S, 1]
    lens = torch.tensor(lens_list, device=cuda_device)
    counts = kernels.launch_counts()
    o8 = tfa.gated_bias_attention(q, k, v, xh, bias, grep_w, grep_b, grep_a, lens,
                                  batch_block=True)
    ref8 = tfa.gated_bias_batched_plain(q, k, v, xh, bias, grep_w, grep_b, grep_a, lens,
                                        pallas_rounding=False)
    rows = tfa.gate_rows(xh, grep_w, grep_b, grep_a)
    o9 = tfa.gated_bias_attention_rows(q, k, v, rows, bias, lens)
    ref9 = tfa.gated_bias_rows_plain(q, k, v, rows, bias, lens, pallas_rounding=False)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gated_bias_attention_batched"] == counts["gated_bias_attention_batched"] + 1
    assert after["gated_bias_attention_rows"] == counts["gated_bias_attention_rows"] + 1
    assert after["gated_bias_attention"] == counts["gated_bias_attention"]
    assert _valid_rows_max(o8.float().cpu(), ref8.float().cpu(), [S] * B) < _attn_bound(ref8)
    assert _valid_rows_max(o9.float().cpu(), ref9.float().cpu(), [S] * B) < _attn_bound(ref9)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [300, 1496])
def test_cuda_gated_bias_wgmma_kernels_match_plain(cuda_device, S):
    """K3, K8 and K9 (the wgmma/TMA kernel: one sample a work item, two
    samples, and one with the gate read from precomputed rows) on BEATs'
    layout: q, k, v and xh are (B, H, S, 64) views of (B, S, H, 64) tensors;
    B = 5 is not a multiple of K8's chunk; ragged lengths, one of a single
    key; S = 300 takes the padded bias rows (600 bytes is not a multiple of
    16), S = 1496 the table in place. Each is held to its plain version, and
    K8 and K9 to K3."""
    B, H, D = 5, 3, 64
    qkvx = _cuda_inputs([(B, S, H, D)] * 4, cuda_device, 55)
    q, k, v, xh = (t.transpose(1, 2) for t in qkvx)
    assert not q.is_contiguous()
    bias, = _cuda_inputs([(H, S, S)], cuda_device, 56)
    bias = bias * 0.5
    grep_w = torch.randn(D, 8, device=cuda_device) * 0.2
    grep_b = torch.randn(8, device=cuda_device) * 0.1
    grep_a = 1 + 0.1 * torch.randn(H, device=cuda_device)
    lens = torch.tensor([S, S - 100, 77, S, 1], device=cuda_device)
    args = (q, k, v, xh, bias, grep_w, grep_b, grep_a, lens)
    rows = tfa.gate_rows(xh, grep_w, grep_b, grep_a)
    counts = kernels.launch_counts()
    o3 = tfa.gated_bias_attention(*args)
    o8 = tfa.gated_bias_attention(*args, batch_block=True)
    o9 = tfa.gated_bias_attention_rows(q, k, v, rows, bias, lens)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("gated_bias_attention", "gated_bias_attention_batched",
                 "gated_bias_attention_rows"):
        assert after[name] == counts[name] + 1, name
    ref3 = tfa.gated_bias_attention_plain(*args)
    ref8 = tfa.gated_bias_batched_plain(*args, pallas_rounding=False)
    ref9 = tfa.gated_bias_rows_plain(q, k, v, rows, bias, lens, pallas_rounding=False)
    assert _valid_rows_max(o3.float().cpu(), ref3.float().cpu(), [S] * B) < _attn_bound(ref3)
    assert _valid_rows_max(o8.float().cpu(), ref8.float().cpu(), [S] * B) < _attn_bound(ref8)
    assert _valid_rows_max(o9.float().cpu(), ref9.float().cpu(), [S] * B) < _attn_bound(ref9)
    for o in (o8, o9):
        assert _valid_rows_max(o.float().cpu(), o3.float().cpu(), [S] * B) < _attn_bound(o3)
    assert torch.isfinite(o3).all() and torch.isfinite(o8).all() and torch.isfinite(o9).all()


@pytest.mark.cuda
def test_cuda_gated_bias_wgmma_kernels_write_zero_rows_without_keys(cuda_device):
    """A sample of length 0 writes o = 0 in K3, K8 and K9; the others
    match their plain versions (B = 3: K8's second chunk holds one sample)."""
    B, H, S, D = 3, 2, 136, 64
    q, k, v, xh = _cuda_inputs([(B, H, S, D)] * 4, cuda_device, 57)
    bias, = _cuda_inputs([(H, S, S)], cuda_device, 58)
    gw, gb, ga = (torch.randn(D, 8, device=cuda_device) * 0.2,
                  torch.zeros(8, device=cuda_device), torch.ones(H, device=cuda_device))
    lens = torch.tensor([0, 129, 136], device=cuda_device)
    args = (q, k, v, xh, bias, gw, gb, ga, lens)
    ref = tfa.gated_bias_attention_plain(*args)
    for o in (tfa.gated_bias_attention(*args), tfa.gated_bias_attention(*args, batch_block=True),
              tfa.gated_bias_attention_rows(q, k, v, tfa.gate_rows(xh, gw, gb, ga), bias, lens)):
        assert torch.all(o[0] == 0)
        assert _valid_rows_max(o.float().cpu(), ref.float().cpu(), [S] * B) < _attn_bound(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks", [((73728, 64), 1024), ((3, 1000, 8), 7), ((64,), 16)])
def test_cuda_stream_probe_matches_plain(cuda_device, shape, blocks):
    """K11 reads every element: its partial sums equal the plain version's
    up to the f32 summation order (1e-5 × the largest block's Σ|x|), also
    with more blocks than 16-byte vectors; stream_rate gives a rate."""
    from icl_speech_text_llm_tpu_torch.ops import probes

    x, = _cuda_inputs([shape], cuda_device, 60)
    before = probes.stream_read.launches
    got = probes.stream_read(x, blocks)
    torch.cuda.synchronize()
    assert probes.stream_read.launches == before + 1 and got.shape == (blocks,)
    ref = probes.stream_read_plain(x, blocks)
    tol = 1e-5 * max(probes.stream_read_plain(x.abs(), blocks).max().item(), 1.0)
    assert (got - ref).abs().max().item() <= tol
    assert probes.stream_rate(x, reps=3) > 0
    with pytest.raises(ValueError):
        probes.stream_read(x.reshape(-1)[:-1])  # not a multiple of 8 elements


@pytest.mark.cuda
def test_cuda_converted_int4_dir_matches_quantize_decoder_and_decodes_through_k10(
        cuda_device, tmp_path):
    """HF shards streamed to an int4 dir on the host (numpy) hold the bytes
    ``quantize_decoder(bits=4)`` gives on the card over the same weights;
    loaded onto the card, one decode step over the dir's tree launches K10 for
    each of the 7 matmuls of each layer."""
    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.models import llama as tllama
    from icl_speech_text_llm_tpu_torch.models.convert import convert_hf_decoder
    from icl_speech_text_llm_tpu_torch.models.stream_convert import (
        TensorSource,
        flatten_tree,
        load_params_dir,
        stream_decoder_to_dir,
    )
    from icl_speech_text_llm_tpu_torch.models.synth_ckpt import write_hf_decoder_shards

    cfg = tllama.DecoderConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                               hidden_dim=512)
    hf, dst = str(tmp_path / "hf"), str(tmp_path / "int4")
    write_hf_decoder_shards(hf, cfg, seed=1)
    stream_decoder_to_dir(TensorSource(hf), cfg, dst, quantize="int4")
    src = TensorSource(hf)
    ref = params_from_numpy(convert_hf_decoder({k: src.get(k) for k in src.keys()}, cfg),
                            device=cuda_device)
    tquant.quantize_decoder(ref, bits=4)
    want = {k: v.cpu().numpy() for k, v in flatten_tree(ref).items()}
    got = flatten_tree(load_params_dir(dst))
    assert set(got) == set(want) and "layers/mlp/w_down/q4" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k

    params = params_from_numpy(load_params_dir(dst), device=cuda_device, dtype=torch.bfloat16)
    cache = tllama.init_kv_cache(cfg, 2, 128, device=cuda_device)
    x = torch.randn(2, 1, cfg.dim, device=cuda_device, dtype=torch.bfloat16)
    before = kernels.launch_counts()["int4_matmul"]
    h, _ = tllama.decode_step(cfg, params, x, cache,
                              torch.tensor([5, 9], dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int4_matmul"] - before == 7 * cfg.n_layers
    assert h.shape == (2, 1, cfg.dim) and torch.isfinite(h.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16_pool", "int8_pool"])
def test_cuda_serving_pool_admits_through_k1_and_appends_through_k4(cuda_device, kv_int8):
    """The serving engine at salmonn-7b's decoder widths cut to one layer,
    bf16 on the card: one admission wave of 4 requests (K1, once a layer),
    then every decode step one append into the pool's (L, S + 1, Hkv,
    cache_len, hd) layout, scratch row included: K4 for the bf16 pool, K4
    q8 for the int8 one, never the other. Each slot's KV block is
    bit-identical to the static engine's prefill of the same 4 rows, and
    each first token is that prefill's argmax."""
    import dataclasses

    from icl_speech_text_llm_tpu_torch.inference import engine as tengine
    from icl_speech_text_llm_tpu_torch.inference import serving as tserving
    from icl_speech_text_llm_tpu_torch.models import llama as tllama

    cfg = dataclasses.replace(tllama.DECODER_CONFIGS["vicuna-7b"], n_layers=1)
    params = tllama.init_decoder(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                 cuda_device, torch.bfloat16)
    lengths = [200, 256, 131, 17]
    rng = np.random.RandomState(1)
    embs = [torch.from_numpy((rng.randn(n, cfg.dim) * 0.3).astype(np.float32))
            .to(cuda_device, torch.bfloat16) for n in lengths]
    scfg = tserving.ServingConfig(num_slots=4, max_new_tokens=6, prompt_buckets=(256,),
                                  admit_batch=4, sync_every=2, kv_int8=kv_int8, eos_token_id=2)
    eng = tserving.ContinuousBatchingEngine(cfg, params, scfg, dtype=torch.bfloat16,
                                            device=cuda_device)
    assert eng._cache["k"].shape == (1, 5, cfg.n_kv_heads, 384, cfg.hd)
    kernels.reset_launch_counts()
    rids = [eng.submit(e, n) for e, n in zip(embs, lengths)]
    res = eng.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = eng.stats["decode_blocks"] * scfg.sync_every
    assert eng.stats["prefill_waves"] == {(256, 4, 0): 1} and steps == 6
    assert counts["flash_attention_causal"] == cfg.n_layers
    assert counts["append_kv_q8" if kv_int8 else "append_kv"] == steps
    assert counts["append_kv" if kv_int8 else "append_kv_q8"] == 0
    for r in rids:
        assert len(res[r]) <= 6 and all(0 <= t < cfg.vocab_size for t in res[r])

    seqs = torch.zeros((4, 256, cfg.dim), dtype=torch.bfloat16, device=cuda_device)
    for j, e in enumerate(embs):
        seqs[j, :lengths[j]] = e
    logits, cache = tengine.prefill(
        cfg, params, seqs, torch.tensor(lengths, dtype=torch.int32, device=cuda_device), 384,
        dt=torch.bfloat16, kv_int8=kv_int8)
    first = logits.argmax(-1).tolist()
    for j, (r, n) in enumerate(zip(rids, lengths)):
        assert res[r][:1] == ([] if first[j] == scfg.eos_token_id else [first[j]])
        for key in cache:
            assert torch.equal(eng._cache[key][:, j, :, :n], cache[key][:, j, :, :n]), (key, j)


@pytest.mark.cuda
def test_cuda_symbol_loss_and_mlp_gradient_match_the_plain_path(cuda_device):
    """The symbol adapter's loss (``mlp_salmonn_train_loss``, soft
    quantization at T = 0.1) at salmonn-bench widths cut to one layer per
    stack: bf16 on the card (the encoders through K2 and K3, the decoder
    through K1, then K5 and K6 in the backward) against the f32 plain path
    on the CPU with the same weights and batch. The loss within 1e-2
    relative; the ``input_mlp`` and LoRA gradients within 5e-2 × max
    |plain gradient|, the gradient reaching the masked text embeddings
    through the decoder's attention."""
    import dataclasses

    from icl_speech_text_llm_tpu_torch.models.salmonn import init_salmonn, salmonn_bench
    from icl_speech_text_llm_tpu_torch.symbol_adapter import init_mlp_adapter
    from icl_speech_text_llm_tpu_torch.symbol_adapter.losses import mlp_salmonn_train_loss

    base = salmonn_bench()
    cfg = dataclasses.replace(base, whisper=dataclasses.replace(base.whisper, n_layers=1),
                              beats=dataclasses.replace(base.beats, n_layers=1),
                              llm=dataclasses.replace(base.llm, n_layers=1))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    params = init_salmonn(cfg, gen, cuda_device, torch.bfloat16, trainable_dtype=torch.float32)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=cuda_device) * 0.02
    params["mlp"] = init_mlp_adapter(gen, cfg.llm.dim, 8, device=cuda_device)
    rng = np.random.RandomState(6)
    B, n_text, T_a, L = 2, 64, cfg.audio_tokens_per_slot, 256
    idx = np.concatenate([1 + np.arange(40), 1 + n_text + np.arange(T_a), 41 + np.arange(24)])
    gather = np.zeros((B, L), np.int64)
    gather[:, :len(idx)] = idx
    seq_mask = (gather > 0).astype(np.int32)
    labels = np.full((B, L), -100, np.int64)
    labels[:, len(idx) - 6:len(idx) - 1] = rng.randint(3, cfg.llm.vocab_size, (B, 5))
    label_mask = np.zeros((B, n_text), bool)
    label_mask[:, rng.choice(n_text, 8, replace=False)] = True
    batch = {"text_tokens": rng.randint(3, cfg.llm.vocab_size, (B, n_text)),
             "gather_idx": gather, "seq_mask": seq_mask, "shifted_labels": labels,
             "wavs": (rng.randn(B, 1, 5 * 16000) * 3000).astype(np.int16),
             "label_mask": label_mask}

    def run(device, dtype):
        p = _tree_to_device(params, device, dtype)
        lora = [t.requires_grad_() for sub in p["lora"].values() for t in sub.values()]
        mlp = [t.requires_grad_() for t in _leaves(p["mlp"]["input_mlp"])]
        loss = mlp_salmonn_train_loss(
            dataclasses.replace(cfg, compute_dtype=dtype), p,
            {k: torch.as_tensor(v, device=device) for k, v in batch.items()},
            mlp_params=p["mlp"], temperature=0.1)[0]
        grads = torch.autograd.grad(loss, lora + mlp)
        return loss.item(), [g.float().cpu() for g in grads[:len(lora)]], \
            [g.float().cpu() for g in grads[len(lora):]]

    before = kernels.launch_counts()
    got = run(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("flash_attention_causal", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] - before[name] == 1, name
    for name in ("flash_attention_noncausal", "gated_bias_attention"):
        assert after[name] - before[name] >= 1, name
    want = run(torch.device("cpu"), torch.float32)
    assert np.isfinite(got[0]) and abs(got[0] - want[0]) <= 1e-2 * abs(want[0])
    for g, w in zip(got[1:], want[1:]):
        g, w = torch.cat([t.flatten() for t in g]), torch.cat([t.flatten() for t in w])
        assert w.abs().max() > 0
        assert (g - w).abs().max() <= 5e-2 * w.abs().max()


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _tree_to_device(tree, device, dtype):
    """A copy of a parameter tree on ``device``: bf16 leaves in ``dtype``,
    f32 leaves f32."""
    if isinstance(tree, dict):
        return {k: _tree_to_device(v, device, dtype) for k, v in tree.items()}
    return tree.detach().to(device, dtype if tree.dtype == torch.bfloat16 else tree.dtype).clone()


@pytest.mark.cuda
def test_cuda_qwen_tower_to_the_longest_clip_matches_the_30s_tower(cuda_device):
    """Qwen2-Audio-7B's tower (32 × 1280 over 128 mels) in bf16 on 8 clips
    of 2-10 s: ``encode_audio`` runs 512 post-conv frames (one past the
    longest clip's 500, in buckets of 128) and matches the same tower over
    the whole 3000-frame mel at every spliced position within 2e-2 × max
    |30-s tower| there; zeros from position 256; K2 runs."""
    from icl_speech_text_llm_tpu_torch.models import qwen_audio as tqa
    from icl_speech_text_llm_tpu_torch.models.common import layer_norm, linear
    from icl_speech_text_llm_tpu_torch.models.whisper import whisper_encode
    from icl_speech_text_llm_tpu_torch.ops.mel import log_mel_spectrogram

    cfg = tqa.qwen2_audio_7b()
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    params = tqa.init_qwen_audio(cfg, gen, cuda_device, torch.bfloat16, skip_llm=True)
    n = [32000, 56000, 80000, 96000, 115200, 128000, 145600, 160000]
    rng = np.random.RandomState(8)
    wavs = np.zeros((len(n), 480000), np.float32)
    for i, x in enumerate(n):
        wavs[i, :x] = rng.randn(x) * 0.1
    mels = log_mel_spectrogram(torch.from_numpy(wavs).to(cuda_device), cfg.encoder.n_mels)
    lengths = torch.tensor(n, device=cuda_device)
    assert tqa.host_tower_frames(np.array(n)) == 512
    with torch.inference_mode():
        before = kernels.launch_counts()["flash_attention_noncausal"]
        got = tqa.encode_audio(cfg, params, mels, lengths)
        assert kernels.launch_counts()["flash_attention_noncausal"] - before == 32
        feats = whisper_encode(cfg.encoder, params["encoder"], mels, dtype=torch.bfloat16,
                               apply_ln_post=False,
                               frame_lengths=tqa.audio_feat_lengths(lengths))
        pooled = feats.reshape(len(n), 750, 2, -1).mean(dim=2)
        ln = params["encoder"]["ln_post"]
        full = linear(layer_norm(pooled, ln["w"], ln["b"]), params["projector"]["w"],
                      params["projector"]["b"])
    assert got.shape == full.shape == (len(n), 750, cfg.llm.dim)
    assert torch.all(got[:, 256:] == 0)
    for i, x in enumerate(n):
        m = int(tqa.audio_output_length(x))
        want = full[i, :m].float()
        gap = (got[i, :m].float() - want).abs().max().item()
        print(f"clip {x} samples, {m} positions: max gap {gap:.4g} of max {want.abs().max():.4g}")
        assert torch.isfinite(want).all() and gap <= 2e-2 * want.abs().max().item()
