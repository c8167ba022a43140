"""ctypes bindings to the native host runtime (runtime/libiclrt.so).

Auto-builds on first use when a compiler is available; every entry point has a
numpy fallback, so the framework stays fully functional without the native
library (but the packing hot loop is ~10-40x faster with it).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_RUNTIME_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "runtime")
_LIB_PATH = os.path.join(_RUNTIME_DIR, "libiclrt.so")

_lib = None
_load_attempted = False


def _try_build() -> bool:
    script = os.path.join(_RUNTIME_DIR, "build.sh")
    if not os.path.exists(script):
        return False
    try:
        subprocess.run(["sh", script], check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception as e:
        logger.info(f"native runtime build skipped: {e}")
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH) and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.iclrt_pack_audio_block.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.iclrt_resample.restype = ctypes.c_int64
        lib.iclrt_resample.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ]
        lib.iclrt_version.restype = ctypes.c_int64
        assert lib.iclrt_version() == 1
        _lib = lib
        logger.info(f"loaded native runtime {_LIB_PATH}")
    except Exception as e:
        logger.info(f"native runtime unavailable ({e}); using numpy fallbacks")
    return _lib


def pack_audio_block(
    wavs: Sequence[Optional[np.ndarray]], n_samples: int
) -> np.ndarray:
    """Pack a flat list of optional wavs into (len(wavs), n_samples) float32."""
    n = len(wavs)
    out = np.empty((n, n_samples), np.float32)
    lib = get_lib()
    if lib is not None:
        arrays: List[np.ndarray] = []  # keep references alive
        ptrs = (ctypes.c_void_p * n)()
        lengths = (ctypes.c_int64 * n)()
        for i, w in enumerate(wavs):
            if w is None or len(w) == 0:
                ptrs[i] = None
                lengths[i] = 0
            else:
                a = np.ascontiguousarray(w, dtype=np.float32)
                arrays.append(a)
                ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
                lengths[i] = a.shape[0]
        lib.iclrt_pack_audio_block(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), lengths,
            n, n_samples, out.ctypes.data_as(ctypes.c_void_p),
        )
        return out
    # numpy fallback
    out[:] = 0.0
    for i, w in enumerate(wavs):
        if w is None:
            continue
        m = min(len(w), n_samples)
        out[i, :m] = w[:m]
    return out


def resample(wav: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    """Polyphase kaiser-windowed resample (native, numpy fallback)."""
    wav = np.ascontiguousarray(wav, np.float32)
    if from_sr == to_sr:
        return wav
    n_out = int(len(wav) * to_sr / from_sr)
    lib = get_lib()
    if lib is not None:
        out = np.empty(n_out + 8, np.float32)
        written = lib.iclrt_resample(
            wav.ctypes.data_as(ctypes.c_void_p), len(wav), from_sr, to_sr,
            out.ctypes.data_as(ctypes.c_void_p), len(out), 16, 8.0,
        )
        return out[:written]
    # numpy fallback: same math, vectorized
    from math import gcd

    g = gcd(from_sr, to_sr)
    up, down = to_sr // g, from_sr // g
    rate = max(up, down)
    # half-width must cover `zeros` sinc zero crossings at the upsampled rate
    zeros = 16
    T = zeros * rate
    cutoff = 1.0 / rate
    t = np.arange(-T, T + 1)
    h = np.sinc(t * cutoff) * cutoff * up * np.kaiser(2 * T + 1, 8.0)
    x = np.zeros(len(wav) * up, np.float32)
    x[::up] = wav
    y = np.convolve(x, h.astype(np.float32), mode="same")
    return y[::down][:n_out]
