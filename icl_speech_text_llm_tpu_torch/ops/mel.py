"""Whisper log-mel frontend in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/ops/mel.py``: the STFT is the same
slice-framed windowed DFT (three contiguous 160-row matmuls against chunks
of the windowed basis, no frame gather), computed in full f32 — the JAX
version asks for ``Precision.HIGHEST``, so TF32 is switched off here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..models.common import full_f32

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH_S  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3_000
N_FREQS = N_FFT // 2 + 1  # 201


def hertz_to_mel_slaney(freq):
    """Slaney-scale Hz→mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
        mels)


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    return np.where(log_region,
                    min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq)


@functools.lru_cache(maxsize=4)
def mel_filter_bank(n_freqs: int = N_FREQS, n_mels: int = N_MELS,
                    sample_rate: int = SAMPLE_RATE, f_min: float = 0.0,
                    f_max: float = 8000.0) -> np.ndarray:
    """Slaney-normalized triangular mel filter bank, (n_freqs, n_mels) —
    what WhisperFeatureExtractor uses."""
    fft_freqs = np.linspace(0.0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hertz_to_mel_slaney(f_min), hertz_to_mel_slaney(f_max),
                          n_mels + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """Windowed real-DFT basis, (n_fft, 2*n_freqs): [cos | -sin] columns."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_freqs)[None, :]
    angle = 2.0 * np.pi * k * f / n_fft
    window = np.hanning(n_fft + 1)[:-1]  # periodic Hann
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (window[:, None] * basis).astype(np.float32)


def wavs_to_float(wavs: torch.Tensor) -> torch.Tensor:
    """Undo the collator's int16 transport encoding (no-op for float input)."""
    if not wavs.is_floating_point():
        return wavs.float() / 32768.0
    return wavs


def pad_or_trim(wav: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Zero-pad / truncate the last axis to ``length`` (Whisper semantics)."""
    n = wav.shape[-1]
    if n == length:
        return wav
    if n > length:
        return wav[..., :length]
    return F.pad(wav, (0, length - n))


def framed_dft(rows: torch.Tensor, basis: torch.Tensor, n_frames: int,
               frame_length: int, hop: int) -> torch.Tensor:
    """Frame i of a signal viewed as (·, hop) rows is rows i, i+1, … plus the
    head of the next row: the framed DFT is a sum of contiguous-slice matmuls
    against hop-row chunks of the (frame_length, ·) basis. rows (N, R, hop)."""
    n_full = frame_length // hop
    rem = frame_length - n_full * hop
    out = torch.matmul(rows[:, 0:n_frames], basis[:hop])
    for j in range(1, n_full):
        out = out + torch.matmul(rows[:, j:n_frames + j], basis[j * hop:(j + 1) * hop])
    if rem:
        out = out + torch.matmul(rows[:, n_full:n_frames + n_full, :rem],
                                 basis[n_full * hop:])
    return out


def log_mel_spectrogram(wav: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """Whisper log-mel features: (n,) or (B, n) 16 kHz PCM, padded/truncated
    to 30 s → (n_mels, 3000) or (B, n_mels, 3000) f32."""
    dev = wav.device
    wav = pad_or_trim(wav.float())
    lead = wav.shape[:-1]
    flat = wav.reshape(-1, N_SAMPLES)
    with full_f32():
        padded = F.pad(flat[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
        n_rows = N_FRAMES + N_FFT // HOP_LENGTH + 1
        sig = F.pad(padded, (0, n_rows * HOP_LENGTH - padded.shape[-1]))
        basis = torch.from_numpy(_dft_basis()).to(dev)
        spec2 = framed_dft(sig.reshape(-1, n_rows, HOP_LENGTH), basis, N_FRAMES,
                           N_FFT, HOP_LENGTH)
        power = spec2[..., :N_FREQS] ** 2 + spec2[..., N_FREQS:] ** 2
        mel = torch.matmul(power, torch.from_numpy(mel_filter_bank(n_mels=n_mels)).to(dev))
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(-1, -2).reshape(*lead, n_mels, N_FRAMES)


def resample_kaiser(wav: torch.Tensor, orig_sr: int, new_sr: int, zeros: int = 16) -> torch.Tensor:
    """Windowed-sinc polyphase resampler for (n,) audio at ``orig_sr`` →
    ``new_sr`` (host-side preparation of non-16 kHz audio): zero-stuffed by
    ``up``, convolved with a Kaiser(β = 8) windowed sinc of half-width
    ``zeros`` crossings at the upsampled rate (numpy's ``convolve(mode=
    "same")`` alignment), then every ``down``-th sample kept. The JAX
    package's filter and output length."""
    if orig_sr == new_sr:
        return wav
    from math import gcd

    g = gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    rate = max(up, down)
    T = zeros * rate
    cutoff = 1.0 / rate
    n = np.arange(-T, T + 1)
    h = np.sinc(n * cutoff) * cutoff * up * np.kaiser(2 * T + 1, 8.0)
    h = torch.from_numpy(h.astype(np.float32)).to(wav.device)
    x = torch.zeros(wav.shape[-1] * up, dtype=torch.float32, device=wav.device)
    x[::up] = wav.float()
    M, N = x.shape[0], h.shape[0]
    with full_f32():  # the full convolution, then its centred max(M, N) samples
        full = F.conv1d(x[None, None], h.flip(0)[None, None], padding=N - 1)[0, 0]
    start = (min(M, N) - 1) // 2
    return full[start:start + max(M, N)][::down]
