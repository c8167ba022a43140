"""Kernel loader: builds the Hopper kernels in ``csrc/`` and binds them.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
for ``sm_90a`` with a plain C interface, and ``ctypes`` loads it. The build
goes to ``build/torch_kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an edit to any
source rebuilds and an unchanged tree reuses the library. Nothing here runs
at import: the CPU paths never touch it.

Every C entry returns the ``cudaGetLastError()`` of its launch; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_NAME = "libiclk.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (0.0 when the cached library
#: was reused) and nvcc's output for it
build_seconds = 0.0
build_log = ""

_p = ctypes.c_void_p
_i = ctypes.c_int
_strides = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # q, k, v, o, m, l, lengths, B, H, Hkv, S, S_kv, D, causal, strides,
    # sm_scale, stream
    "iclk_flash_fwd": [_p] * 7 + [_i] * 7 + [_strides, ctypes.c_float, _p],
    # q, k, v, xh, bias, grep_w, grep_b, grep_a, o, lengths, B, H, S, D,
    # strides, sm_scale, stream
    "iclk_gated_bias_fwd": [_p] * 10 + [_i] * 4 + [_strides, ctypes.c_float, _p],
    # cache_k, cache_v, new_k, new_v, positions, L, B, Hkv, S, D,
    # elem_bytes, stream
    "iclk_append_kv": [_p] * 5 + [_i] * 6 + [_p],
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu into the hashed build directory unless it exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    (out.parent / "build.log").write_text(build_log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.iclk_error_string.argtypes = [ctypes.c_int]
            handle.iclk_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err:
        msg = lib().iclk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def strides_arg(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])
