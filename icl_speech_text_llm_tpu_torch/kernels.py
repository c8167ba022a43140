"""Kernel loader: builds the Hopper kernels in ``csrc/`` and binds them.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. The build
goes to ``build/torch_kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an edit to any
source rebuilds and an unchanged tree reuses the library. Nothing here runs
at import: the CPU paths never touch it.

Every C entry that launches returns the ``cudaGetLastError()`` of its
launch; ``check`` turns a non-zero code into an exception. The flash forward,
the flash backward, the gated-bias and the quantized matmul kernels build
TMA tensor maps with ``cuTensorMapEncodeTiled``, which they reach through the
runtime's ``cudaGetDriverEntryPoint``: the library needs no link against
``libcuda``.

The launch-count registry lives here too: each ops module ``register``s its
kernel wrappers, each wrapper adds one to ``<wrapper>.launches`` where it
launches its kernel, and ``launch_counts`` / ``reset_launch_counts`` read
and clear them all.
"""

from __future__ import annotations

import ctypes
import functools
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
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
    # strides (q, k, v, o, xh as (b, h, s), then the bias row stride),
    # sm_scale, stream
    "iclk_gated_bias_fwd": [_p] * 10 + [_i] * 4 + [_strides, ctypes.c_float, _p],
    # the same arguments, batched schedule (K8)
    "iclk_gated_bias_batched": [_p] * 10 + [_i] * 4 + [_strides, ctypes.c_float, _p],
    # q, k, v, scale_rows, bias, o, lengths, B, H, S, D, strides (q, k, v, o
    # as (b, h, s), then the bias row stride), sm_scale, stream
    "iclk_gated_bias_rows": [_p] * 7 + [_i] * 4 + [_strides, ctypes.c_float, _p],
    # q, k, v, k_s, v_s, k_new, v_new, o, lengths, B, H, Hkv, S, D, splits,
    # strides, sm_scale, stream
    "iclk_flash_decode": [_p] * 9 + [_i] * 6 + [_strides, ctypes.c_float, _p],
    # cache_k, cache_v, new_k, new_v, positions, L, B, Hkv, S, D,
    # elem_bytes, sms, stream
    "iclk_append_kv": [_p] * 5 + [_i] * 7 + [_p],
    # cache_k, cache_v, scale_k, scale_v, new_k, new_v, positions, L, B,
    # Hkv, S, D, rows_f32, sms, stream
    "iclk_append_kv_q8": [_p] * 7 + [_i] * 7 + [_p],
    # q, k, v, o, dout, m, l, delta, dq, lengths, B, H, Hkv, S, S_kv, D,
    # causal, strides, sm_scale, stream
    "iclk_flash_bwd_dq": [_p] * 10 + [_i] * 7 + [_strides, ctypes.c_float, _p],
    # q, k, v, dout, m, l, delta, dk, dv, lengths, B, H, Hkv, S, S_kv, D,
    # causal, strides, sm_scale, stream
    "iclk_flash_bwd_dkv": [_p] * 10 + [_i] * 7 + [_strides, ctypes.c_float, _p],
    # x, packed, scales, y, M, N, K, n_groups, tile_n, splits, stream
    "iclk_int4_matmul": [_p] * 4 + [_i] * 6 + [_p],
    # x, q, s, y, M, N, K, n_groups (ignored), tile_n, splits, stream
    "iclk_int8_matmul": [_p] * 4 + [_i] * 6 + [_p],
    # x, partial, n_vec (16-byte vectors), blocks, stream
    "iclk_stream_read": [_p, _p, ctypes.c_longlong, _i, _p],
    # D → dynamic shared memory of a flash-forward block, in bytes
    "iclk_flash_fwd_smem_bytes": [_i],
    # batched (0: K3/K9, 1: K8) → dynamic shared memory of a gated-bias block
    "iclk_gated_bias_smem_bytes": [_i],
    # D, dkv (0: K5, 1: K6) → dynamic shared memory of a backward block
    "iclk_flash_bwd_smem_bytes": [_i, _i],
    # int4 (1) or int8 (0), rows MT, columns TN → dynamic shared memory of a
    # quantized-matmul block
    "iclk_wq_smem_bytes": [_i, _i, _i],
    # int4 (1) or int8 (0), rows MT, columns TN, splits → clusters of that
    # many blocks the card holds at once
    "iclk_wq_max_clusters": [_i, _i, _i, _i],
    # n_rep → dynamic shared memory of a K7 q8 block
    "iclk_flash_decode_q8_smem_bytes": [_i],
    # n_rep, splits → clusters of that many K7 q8 blocks the card holds at once
    "iclk_flash_decode_q8_max_clusters": [_i, _i],
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


def _run_all(cmds):
    """Run the commands concurrently → [(returncode, output)] in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def build() -> Path:
    """Compile csrc/*.cu into the hashed build directory unless it exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [work / (src.stem + ".o") for src in srcs]
        runs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(srcs, objs)])
        tmp = work / LIB_NAME
        if all(rc == 0 for rc, _ in runs):
            runs += _run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
        build_log = "".join(log for _, log in runs)
        (out.parent / "build.log").write_text(build_log)
        if any(rc != 0 for rc, _ in runs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the host functions
    that size a kernel's grid, ``int4_matmul.partition`` and
    ``flash_attention.decode_splits``, and the append kernels take it)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def strides_arg(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


#: the kernel wrappers of the port's paths, by kernel name
WRAPPERS: dict = {}


def register(*wrappers) -> None:
    """Add kernel wrappers to ``WRAPPERS`` under their names, counts at 0."""
    for fn in wrappers:
        fn.launches = 0
        WRAPPERS[fn.__name__] = fn


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
