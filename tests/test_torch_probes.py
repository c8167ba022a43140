"""The streaming probe (K11) of the port on the CPU: its plain version
against a numpy sum, the wrapper's dispatch and its refusals. The kernel
itself runs only on the card (tests/test_torch_cuda_kernels.py). Also: each C
entry that ``kernels.py`` binds is defined in ``csrc/``."""

import re

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu_torch import kernels
from icl_speech_text_llm_tpu_torch.ops import probes


def _numpy_partials(x: np.ndarray, blocks: int) -> np.ndarray:
    """Blocks of ceil(ceil(n / 8) / blocks) groups of 8 elements, summed in
    f64: the kernel's partition, written out with python ints."""
    flat = x.reshape(-1).astype(np.float64)
    n_vec = (flat.size + 7) // 8
    chunk = 8 * ((n_vec + blocks - 1) // blocks)
    return np.array([flat[i * chunk:(i + 1) * chunk].sum() for i in range(blocks)])


@pytest.mark.parametrize("shape,blocks", [
    ((73, 512), 16), ((4, 2, 9, 16), 7), ((1000,), 3), ((13,), 5), ((8,), 1), ((2, 3), 4)])
def test_stream_read_plain_matches_numpy(shape, blocks):
    """Ragged chunks, a last block that is short, blocks past the end (0)."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = _numpy_partials(xt.float().numpy(), blocks)
    got = probes.stream_read_plain(xt, blocks)
    assert got.shape == (blocks,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert abs(got.sum().item() - xt.float().sum().item()) < 1e-3 * max(1.0, np.abs(x).sum())


def test_stream_read_on_cpu_is_the_plain_version_and_launches_nothing():
    x = torch.randn(4, 32, 72, 128).to(torch.bfloat16)
    kernels.reset_launch_counts()
    assert torch.equal(probes.stream_read(x), probes.stream_read_plain(x))
    assert probes.stream_read(x, 64).shape == (64,)
    assert "stream_read" in kernels.WRAPPERS
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)


@pytest.mark.parametrize("call,err", [
    (lambda: probes.stream_read(torch.ones(16, dtype=torch.bfloat16), blocks=0), ValueError),
    (lambda: probes.stream_read(torch.ones(16, dtype=torch.bfloat16, device="meta")),
     ValueError),
    (lambda: probes.stream_rate(torch.ones(16, dtype=torch.bfloat16)), ValueError)])
def test_probe_refuses_what_it_cannot_take(call, err):
    """A bad block count, a device that is neither CPU nor CUDA, and a rate
    asked of a CPU tensor (only the card has one) raise."""
    with pytest.raises(err):
        call()


def test_every_bound_c_entry_is_defined_in_csrc():
    """kernels.py binds each name in _SIGNATURES (and iclk_error_string)
    from the built library: each is an extern "C" function of csrc/*.cu."""
    defined = set()
    for path in kernels.CSRC_DIR.glob("*.cu"):
        defined |= set(re.findall(r'extern "C"\s+[\w\s\*]+?\b(iclk_\w+)\s*\(', path.read_text()))
    assert set(kernels._SIGNATURES) | {"iclk_error_string"} <= defined
