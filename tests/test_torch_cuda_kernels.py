"""Each Hopper kernel of the port against its plain PyTorch version, on an
NVIDIA GPU. The tests carry the ``cuda`` marker and skip without a card.

This file imports no jax, so it also runs on the machine with the card:
    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
(``--noconftest`` because ``tests/conftest.py`` sets up jax). Bounds: bf16
outputs within 2e-2 of the f32-softmax plain version on valid rows, row
max m within 1e-3, and the KV append bit-exact.
"""

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu_torch.ops import flash_attention as tfa


def _arrays(shapes, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _valid_rows_max(a, b, lengths):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return max(d[i, :, :n].max() for i, n in enumerate(lengths))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_inputs(shapes, dev, seed):
    return [torch.from_numpy(a).to(dev, torch.bfloat16) for a in _arrays(shapes, seed, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,D,Hkv,lengths", [
    (True, 128, 4, [200, 77]), (True, 128, 2, [200, 1]), (False, 64, 4, [200, 130]),
    (False, 64, 4, None)])
def test_cuda_flash_kernel_matches_plain(cuda_device, causal, D, Hkv, lengths):
    B, H, S = 2, 4, 200
    q, = _cuda_inputs([(B, H, S, D)], cuda_device, 20)
    k, v = _cuda_inputs([(B, Hkv, S, D)] * 2, cuda_device, 21)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda_device)
    fn = tfa.flash_attention_causal if causal else tfa.flash_attention_noncausal
    before = fn.launches
    o, m, l = fn(q, k, v, lens)
    assert fn.launches == before + 1
    o_p, m_p, l_p = tfa.flash_attention_plain(q, k, v, lens, causal)
    rows = [S] * B if (lengths is None or not causal) else lengths
    assert _valid_rows_max(o.float().cpu(), o_p.float().cpu(), rows) < 2e-2
    assert _valid_rows_max(m.cpu()[..., None], m_p.cpu()[..., None], rows) < 1e-3


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_cuda_append_kv_kernel_is_exact(cuda_device, dtype):
    """bf16 cache, and an int8 cache with rows the caller quantized."""
    ck, cv = (t.mul(50).to(dtype) for t in _cuda_inputs([(3, 2, 4, 256, 128)] * 2, cuda_device, 24))
    nk, nv = (t.mul(50).to(dtype) for t in _cuda_inputs([(3, 2, 4, 1, 128)] * 2, cuda_device, 25))
    pos = torch.tensor([255, 17], device=cuda_device)
    ck2, cv2 = ck.clone(), cv.clone()
    tfa.append_kv(ck, cv, nk, nv, pos)
    tfa.append_kv_plain(ck2, cv2, nk, nv, pos)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)
