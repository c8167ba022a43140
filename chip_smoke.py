"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device  — the card's name and power limit (nvidia-smi); exits non-zero
               without CUDA;
  2. build   — compiles the Hopper kernels of icl_speech_text_llm_tpu_torch/csrc
               (one nvcc per source, in parallel); prints each kernel's
               registers, shared memory and spills (ptxas -v) and, where
               cuobjdump exists, whether the SASS of the wgmma/TMA kernels
               (the flash forward K1/K2, the gated bias K3/K8/K9, the flash
               backward K5/K6) holds HGMMA (wgmma) and UTMALDG (TMA loads),
               that of each quantized-matmul instance (K10/K12) HMMA
               (mma.sync) and UTMALDG, that of each int8-cache flash-decode
               instance (K7 q8) HMMA and no I2F, and that of each append
               instance (K4, K4 q8) its loads and stores;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the shapes of the paths below, with the stated tolerances, plus
               CUDA-event times of both, its bound (the least time the H100
               could take: the bytes it must move at 3.35 TB/s or its matmul
               FLOPs at 989 TFLOP/s bf16, the larger) and, where one PyTorch
               call computes the same function, that call's time (K1-K4,
               K8-K10 and K12 timed in turns with theirs: kernel, library,
               library, kernel; K5 + K6 together in turns with one SDPA
               backward); K4 q8 at the 13B int8 cache in turns with the
               route it replaced (~900 small kernels), which has no library
               call, and held against both at the 16-row shape of the
               main path's sampled beams; K7 q8 at the 13B 4-row and 16-row shapes, with
               SDPA over a dequantized bf16 copy printed for reference; the
               streaming probe (K11) on two 75.5 MB buffers, with its GB/s;
  4. check   — one-layer-per-stack models, the bf16 kernel path on the card
               against the f32 plain path on the CPU with the same weights and
               inputs: at salmonn-7b widths the first-token logits and 3
               decode steps' logits through the flash-decode kernel, then the
               training loss and the LoRA / Q-Former gradients; at salmonn-13b
               widths with int4 weights and an int8 KV cache the first-token
               logits and 3 decode steps' logits, with the default decode
               attention and with the flash-decode kernel, each step's one
               append through K4 q8; then the kernels one full-depth decode
               step launches (13B int4 + int8 KV, 7B bf16) and its time
               (``_append_sweep`` counts and times another tree's beside);
  5. main    — the port's inference entry points at full width (random
               weights from a seed), voxceleb requests of 6 clips each, each
               run's kernel launch counts read from that run alone: the CLI on
               salmonn-7b bf16 (8 requests), salmonn-13b --quantize_int4
               --kv_int8 (8), salmonn-7b --quantize_int8 (4), salmonn-7b bf16
               with --num_beams 4 --repetition_penalty 1.2 --min_new_tokens 2
               (4); then create_model + run_inference on salmonn-7b bf16 with
               use_flash_decode=True and BEATs lean_bias_flash (4), and on
               salmonn-13b int4 + int8 KV with use_flash_decode=True and 4
               sampled beams (4); then the batched BEATs attention schedule,
               which no model config selects, through its entry point
               gated_bias_attention(batch_block=True) on every BEATs layer of
               a main-path batch of 24 clips; then the streaming probe (K11)
               through its entry point, ops.probes.stream_rate, on the two
               buffers of the JAX probes;
  6. load    — converted weights: (a) HF shards at vicuna-13b's widths cut to
               2 layers (models/synth_ckpt.py) through cli/convert.py
               --quantize_int4 on the host, every leaf byte-identical to
               quantize_decoder(bits=4) on the card over the same weights, and
               a 13B-width salmonn_v1.pth through --component salmonn; (b) the
               salmonn-13b model of phase main's int4 + int8 KV run, its int4
               decoder written to a dir (~7.5 GB), then that CLI run with
               --llm_params_dir: the same launches and predictions, the model
               build's peak memory under 16 GiB; (c) --quantize_int8 over the
               int4 dir exits, and cli/reprocess.py of (b)'s results gives
               (b)'s metrics; (d) salmonn-7b's encoders over 24 clips with
               encode_chunk=6 and without, the outputs within 5% of the
               largest and each one's peak memory;
  7. train   — the port's training CLI on salmonn-7b at full width: 4 optimizer
               steps (batch 4, seq 1024), validation by generation and a
               checkpoint, with each step's kernel launches read; then 2 steps
               with full activation checkpointing.
The line before the last is a JSON object of the fourteen kernels (launch
counts from the run of each kernel's own path: the salmonn-13b int4 run for
the int4 and int8 matmuls and K4 q8, the flash-decode runs of phase main for the
flash-decode kernels and the K9 schedule, phase main's BEATs-layer run for
the K8 schedule, its probe run for K11, the train phase for the others),
after a line with K7 q8's launches × (ms − bound) at the 16-row shape; the
last
line is {"ok": true, "device": {...}} and is printed only when every phase
passed. Takes ~5 minutes on one H100.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)


def _bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take for
    ``nbytes`` moved and ``flops`` bf16 matmul FLOPs, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row_case(label, ker, ref):
    """An attention kernel's output against its plain version, row by row
    (the last axis: one query's head vector): the largest |kernel − plain|
    in a row over that row's largest |plain|, bound 2e-2 (~2.5 bf16 steps
    of the row's largest element), so that rows of small outputs are held
    as tightly as rows of large ones. → (label, worst row ratio, 2e-2, max
    abs error)."""
    d = (ker.float() - ref.float()).abs()
    scale = ref.float().abs().amax(-1)
    ratio = (d.amax(-1) / scale.clamp_min(1e-30)).max().item()
    return f"{label} (worst row's max |err| / max |plain|)", ratio, 2e-2, d.max().item()


def _causal_pairs(S, lens):
    """(query row, key) pairs a causal pass with key lengths computes, per
    (sample, head): Σ_i min(i + 1, len)."""
    return sum(n * (n + 1) // 2 + (S - n) * n for n in lens)


def _device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def _time_ms(fn, reps=10, stat=statistics.median):
    """``stat`` (the median, or the least) of ``reps`` CUDA-event times of
    one synchronised call, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return stat(times)


def _device_ms(fn, reps=20):
    """Device time of one call, from CUDA events around ``reps`` calls queued
    behind a ~30 ms device spin, so that the host's launch overhead is not in
    the measurement; a warm-up call first."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _in_turns(label, kernel, library, bound, lib_name="SDPA", reps=20):
    """Device times of a kernel and of the library call computing the same
    function, in turns (kernel, library, library, kernel) → (kernel ms,
    library ms), each the mean of its two turns; prints the four times and
    the kernel's share of its bound."""
    t = [_device_ms(f, reps) for f in (kernel, library, library, kernel)]
    ms, lib_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"  {label}: kernel, {lib_name}, {lib_name}, kernel {[round(x, 4) for x in t]} ms; "
          f"kernel {ms:.4f} ms = {100 * bound[0] / ms:.1f}% of its bound {bound[0]:.4f} ms "
          f"({bound[1]}); {'faster' if ms < lib_ms else 'slower'} than {lib_name} "
          f"({lib_ms / ms:.2f}x)", flush=True)
    return ms, lib_ms


#: the wgmma/TMA kernels and their instances in the SASS: the flash forward
#: (D 64/128 × causal or not), the gated bias (K3, K8, K9), the backward's
#: K5 and K6 (D 64/128 × causal or not each)
SASS_INSTANCES = {"flash_fwd_wgmma_kernel": 4, "gated_bias_wgmma_kernel": 3,
                  "flash_bwd_dq_wgmma_kernel": 4, "flash_bwd_dkv_wgmma_kernel": 4}
#: the mma.sync/TMA kernels: the quantized matmuls K10/K12 (int4 or int8 ×
#: 8, 16 or 64 rows × 128 or 64 columns), each with HMMA (mma.sync) and UTMALDG
SASS_MMA_INSTANCES = {"wq_matmul_kernel": 12}
#: the int8-cache flash decode (K7 q8, n_rep 1-8): mma.sync products (HMMA)
#: fed by bulk copies, its int8 converted without I2F
SASS_Q8_INSTANCES = {"flash_decode_q8_kernel": 8}
#: the decode-step appends: K4 (16-byte vectors) and K4 q8 (bf16 and f32 rows)
SASS_APPEND_INSTANCES = {"append_kv_kernel": 1, "append_kv_q8_kernel": 2}


def _build_report(lib_path, log):
    """Each kernel's registers, shared memory and spills from nvcc's ptxas -v
    output (the TMA kernels' dynamic shared memory from their C entries),
    and, where cuobjdump exists, the HGMMA (wgmma), HMMA (mma.sync), UTMALDG
    (TMA tensor load) and WARPGROUP.DEPBAR counts of each instance of
    ``SASS_INSTANCES`` and ``SASS_MMA_INSTANCES``, the HMMA, UBLKCP (bulk
    copy) and I2F counts of ``SASS_Q8_INSTANCES``, and the LDG, STG and SHFL
    counts of ``SASS_APPEND_INSTANCES``; fails if an instance is missing or
    lacks its tensor-core product or its TMA load, if a K7 q8 instance holds
    an I2F, or if an append instance lacks its loads, stores or (K4 q8) the
    row-maximum shuffles."""
    import shutil

    from icl_speech_text_llm_tpu_torch import kernels

    name, props = "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line and name:
            print(f"  ptxas: {name}: {line.split(':', 1)[1].strip()}; {props}", flush=True)
            name = ""
    smem = kernels.lib().iclk_flash_fwd_smem_bytes
    gsmem = kernels.lib().iclk_gated_bias_smem_bytes
    bsmem = kernels.lib().iclk_flash_bwd_smem_bytes
    wsmem = kernels.lib().iclk_wq_smem_bytes
    qsmem = kernels.lib().iclk_flash_decode_q8_smem_bytes
    print(f"  dynamic shared memory: flash_fwd_wgmma_kernel D = 64 {smem(64)} bytes, "
          f"D = 128 {smem(128)} bytes; gated_bias_wgmma_kernel K3/K9 {gsmem(0)} bytes, "
          f"K8 {gsmem(1)} bytes; flash_bwd K5 D = 64 {bsmem(64, 0)}, D = 128 "
          f"{bsmem(128, 0)} bytes, K6 D = 64 {bsmem(64, 1)}, D = 128 {bsmem(128, 1)} bytes; "
          "wq_matmul_kernel (int4/int8, rows, columns) " + ", ".join(
              f"({'int4' if b else 'int8'}, {mt}, {tn}) {wsmem(b, mt, tn)}"
              for b in (1, 0) for mt in (8, 16, 64) for tn in (128, 64)) + " bytes; "
          "flash_decode_q8_kernel n_rep 1-8 " + ", ".join(str(qsmem(n)) for n in range(1, 9))
          + " bytes", flush=True)
    tool = next((c for c in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "cuobjdump"),
                             shutil.which("cuobjdump") or "", "/usr/local/cuda/bin/cuobjdump")
                 if c and os.path.isfile(c)), None)
    if tool is None:
        print("  cuobjdump not found: SASS not checked", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    want = {**SASS_INSTANCES, **SASS_MMA_INSTANCES, **SASS_Q8_INSTANCES,
            **SASS_APPEND_INSTANCES}
    found = dict.fromkeys(want, 0)
    for fn in sass.split("Function : ")[1:]:
        fname = fn.split("\n", 1)[0].strip()
        kind = next((k for k in found if k in fname), None)
        if kind is None:
            continue
        found[kind] += 1
        if kind in SASS_APPEND_INSTANCES:
            ldg, stg, shfl = fn.count("LDG"), fn.count("STG"), fn.count("SHFL")
            print(f"  SASS {fname}: {ldg} LDG, {stg} STG, {shfl} SHFL", flush=True)
            if not (ldg and stg) or (kind == "append_kv_q8_kernel" and not shfl):
                raise AssertionError(f"{fname}: no load, store or shuffle in the SASS")
            continue
        if kind in SASS_Q8_INSTANCES:
            hmma, i2f = fn.count("HMMA"), fn.count("I2F")
            print(f"  SASS {fname}: {hmma} HMMA, {fn.count('UBLKCP')} UBLKCP, {i2f} I2F",
                  flush=True)
            if not hmma or i2f:
                raise AssertionError(f"{fname}: no HMMA, or an I2F, in the SASS")
            continue
        hgmma, hmma, utma = fn.count("HGMMA"), fn.count("HMMA"), fn.count("UTMALDG")
        depbar = fn.count("WARPGROUP.DEPBAR")
        print(f"  SASS {fname}: {hgmma} HGMMA, {hmma} HMMA, {utma} UTMALDG, "
              f"{depbar} WARPGROUP.DEPBAR", flush=True)
        product = hmma if kind in SASS_MMA_INSTANCES else hgmma
        if not (product and utma):
            raise AssertionError(f"{fname}: no tensor-core product or no TMA load in the SASS")
    if found != want:
        raise AssertionError(f"expected the kernel instances {want} in the SASS, "
                             f"found {found}")


def _probe_kernel_rows(report, gen):
    """K11, the streaming probe, on the JAX probes' two buffers: the (73728,
    512) bf16 matrix of probe_stream_matrix.py and one layer's k + v of the
    7B cache, (2, 4, 32, 1152, 128), the shape of probe_kernel_variants.py;
    75.5 MB each, above the 50 MB L2. Bound on the partial sums: 1e-5 × the
    largest block's Σ|x| (f32 sums of 36,864 terms in another order). The
    library call: torch.sum over the (blocks, chunk) view in f32."""
    import torch

    from icl_speech_text_llm_tpu_torch.ops import probes

    dev = torch.device("cuda")
    errs, timed = [], None
    for label, shape in (("(73728, 512)", (73728, 512)),
                         ("7B cache layer k + v (2, 4, 32, 1152, 128)", (2, 4, 32, 1152, 128))):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        got = probes.stream_read(x)
        ref = probes.stream_read_plain(x)
        tol = 1e-5 * probes.stream_read_plain(x.abs()).max().item()
        torch.cuda.synchronize()
        errs.append((f"{label} partial sums (bound 1e-5 × max block Σ|x| = {tol:.3e})",
                     (got - ref).abs().max().item(), tol))
        nbytes = x.numel() * x.element_size() + 4 * probes.PROBE_BLOCKS
        ms = _device_ms(lambda i=0: probes.stream_read(x))
        lib_ms = _device_ms(lambda i=0: torch.sum(x.view(probes.PROBE_BLOCKS, -1), dim=1,
                                                  dtype=torch.float32))
        print(f"  stream_read {label}: {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s against the "
              f"data sheet's 3350 GB/s; torch.sum {lib_ms:.4f} ms "
              f"({nbytes / lib_ms / 1e6:.1f} GB/s)", flush=True)
        if timed is None:
            plain_ms = _device_ms(lambda i=0: probes.stream_read_plain(x), reps=5)
            timed = (ms, plain_ms, _bound(nbytes, 0.0), lib_ms)
        del x, got, ref
    report("stream_read", "cuda", "icl_speech_text_llm_tpu_torch/csrc/stream_probe.cu",
           "scripts/probe_stream_matrix.py:67, scripts/probe_kernel_variants.py:50", errs,
           *timed)
    torch.cuda.empty_cache()


#: the int4 wrapper's host µs per call before the cluster kernel (two
#: launches: split-K partials, then a reduce kernel), at 13B w_gate, w_down
#: and wq M = 4: the least of its two turns (five trials of 200 calls each)
#: in ``_wq_sweep(baseline=<a checkout of that tree>)`` below, in turns with
#: this wrapper; NVIDIA H100 80GB HBM3, 700.00 W. Printed beside this run's
#: host µs.
WQ_HOST_US_BEFORE = (27.55, 25.22, 35.97)


def _host_us(fn, calls=200, trials=5):
    """Host µs of one call: the least over ``trials`` of the enqueue time of
    ``calls`` calls queued behind a device spin, so that no call waits for
    the card."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def _wq_weights(gen, name, K, N, copies, group=128):
    """Random weights of the int4 or int8 matmul, ``copies`` stacked: int4
    random bytes with scales in [1e-3, 2.1e-2), int8 in [-127, 127]."""
    import torch

    dev = torch.device("cuda")
    if name == "int4_matmul":
        packed = torch.randint(0, 256, (copies, K // 2, N), generator=gen, device=dev,
                               dtype=torch.uint8)
        scales = torch.rand((copies, K // group, N), generator=gen, device=dev) * 0.02 + 1e-3
        return packed, scales
    q = torch.randint(-127, 128, (copies, K, N), generator=gen, device=dev, dtype=torch.int8)
    return q, torch.rand((copies, N), generator=gen, device=dev) * 0.02 + 1e-3


def _wq_library(name, w, s, group=128):
    """torch's weight-only matmul on the same weight, repacked here, outside
    any timed call. int4: aten._weight_int4pack_mm (tinygemm's layout, bf16
    scale and zero per group, weight (q − 8)·scale + zero): the nibbles of
    rows k and k + K/2 (one byte here) become rows of an (N, K) matrix
    packed two consecutive k a byte, even k in the high nibble, zero 0 → a
    call computing the kernel's function with its scales rounded to bf16.
    int8: aten._weight_int8pack_mm, the weight as (N, K), the f32 per-column
    scales as they are."""
    import torch

    if name == "int4_matmul":
        q = torch.cat([w & 0xF, w >> 4], 0).t()
        wpk = torch.ops.aten._convert_weight_to_int4pack(
            ((q[:, ::2] << 4) | q[:, 1::2]).contiguous(), 8)
        sz = torch.stack([s.to(torch.bfloat16), torch.zeros_like(s, dtype=torch.bfloat16)], -1)
        sz = sz.contiguous()
        return lambda x: torch.ops.aten._weight_int4pack_mm(x, wpk, group, sz)
    wt = w.t().contiguous()
    return lambda x: torch.ops.aten._weight_int8pack_mm(x, wt, s)


#: (kernel, label, M, K, N, stacked copies) of the quantized matmuls: the
#: salmonn-13b int4 decode products (M = 4: w_gate/w_up, w_down, wq/wk/wv/wo
#: read as layer 17 of a stacked [40] weight) and an M = 256 prefill; K12 at
#: the 13B lm_head and the 7B w_down. Copies whose bytes exceed the 50 MB L2,
#: cycled, so that each timed call streams its weight from device memory.
WQ_CASES = (
    ("int4_matmul", "13B w_gate M=4", 4, 5120, 13824, 4),
    ("int4_matmul", "13B w_down M=4", 4, 13824, 5120, 4),
    ("int4_matmul", "13B wq stacked [17] M=4", 4, 5120, 5120, 40),
    ("int4_matmul", "13B w_gate M=256", 256, 5120, 13824, 4),
    ("int8_matmul", "13B lm_head M=4", 4, 5120, 32000, 1),
    ("int8_matmul", "7B w_down M=4", 4, 11008, 4096, 4),
)


def _wq_kernel_rows(report, gen):
    """K10 (int4) and W8A16 (int8, K12) at ``WQ_CASES``. Bound: 1e-2 × max
    |plain| over the output, the plain version computing in f32 from the
    same bf16 x. Every int4 M = 4 shape and the lm_head are timed in turns
    with torch's weight-only matmul (``_wq_library``), which must meet the
    same bound; each prints its GB/s, column tile, cluster split, the
    busiest SM's share of the mean (``partition``'s model) and the weight
    bytes in flight an SM; at the end the int4 wrapper's host µs a call at
    the three M = 4 shapes, beside the two-launch wrapper's
    (``WQ_HOST_US_BEFORE``). The
    row's numbers are its first case's."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels as built
    from icl_speech_text_llm_tpu_torch.ops import int4_matmul as wq

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = built.lib()
    kernels = {"int4_matmul": (wq.int4_matmul, wq.int4_matmul_plain,
                               "icl_speech_text_llm_tpu/ops/int4_matmul.py:199"),
               "int8_matmul": (wq.int8_matmul, wq.int8_matmul_plain,
                               "icl_speech_text_llm_tpu/ops/quant.py:141 (XLA convert; "
                               "no Pallas kernel)")}
    host_runs = []  # the int4 M = 4 calls, timed on the host at the end
    for name, (kernel, plain, replaces) in kernels.items():
        errs, timed = [], None
        for _, label, M, K, N, copies in (c for c in WQ_CASES if c[0] == name):
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            w, s = _wq_weights(gen, name, K, N, copies)
            first = 17 if copies == 40 else 0
            y = kernel(x, w[first], s[first])
            ref = plain(x.float(), w[first], s[first])
            torch.cuda.synchronize()
            tol = 1e-2 * ref.abs().max().item()
            errs.append((f"{label} (bound 1e-2 × max |plain|)",
                         (y.float() - ref).abs().max().item(), tol))
            nbytes = w[0].numel() + 4 * s[0].numel() + 2 * (M * K + M * N)
            bound = _bound(nbytes, 2.0 * M * K * N)

            def run(i=0, kernel=kernel, x=x, w=w, s=s, copies=copies):
                return kernel(x, w[i % copies], s[i % copies])

            lib_ms = None
            if M == 4 and (name == "int4_matmul" or timed is None):
                libs = [_wq_library(name, w[c], s[c]) for c in range(copies)]
                lib_err = (libs[first](x).float() - ref).abs().max().item()
                print(f"  {name} {label}: library call vs plain {lib_err:.3e} (tolerance "
                      f"{tol:.1e}) {'ok' if lib_err <= tol else 'FAIL'}", flush=True)
                if lib_err > tol:
                    raise AssertionError(f"{name} library call error {lib_err} > {tol}")
                ms, lib_ms = _in_turns(f"{name} {label}", run, lambda i=0: libs[i % copies](x),
                                       bound, lib_name=f"aten._weight_{name[:4]}pack_mm")
                del libs
                if name == "int4_matmul":
                    host_runs.append(run)
            else:
                ms = _device_ms(run)
            plain_ms = _device_ms(lambda i=0: plain(x, w[i % copies], s[i % copies]), reps=5)
            n_steps = w.shape[1] // wq.STEP_ROWS
            tile_n, splits = wq.partition(M, N, n_steps, sms)
            work = wq.sm_work(M, N, n_steps, tile_n, splits, sms)
            # blocks an SM holds at once (the clusters that fit, as many as
            # the grid has) × the ring's weight boxes
            mt = 8 if M <= 8 else 16 if M <= 16 else 64
            blocks = (N // tile_n) * -(-M // (16 if M <= 16 else 64)) * splits
            fit = lib.iclk_wq_max_clusters(int(name == "int4_matmul"), mt, tile_n, splits)
            resident = min(blocks, fit * splits) / sms
            in_flight = resident * wq.STAGES * tile_n * wq.STEP_ROWS
            print(f"  {name} {label}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of "
                  f"{nbytes / 1e6:.1f} MB), {tile_n}-column tiles, {splits} K splits a "
                  f"cluster, {blocks} blocks, busiest SM {max(work) * len(work) / sum(work):.3f}"
                  f"× the mean, {resident:.2f} blocks an SM at once: up to "
                  f"{in_flight / 1024:.0f} KB of weight in flight an SM; plain "
                  f"{plain_ms:.4f} ms", flush=True)
            if timed is None:
                timed = (ms, plain_ms, bound, lib_ms)
            del y, ref
        report(name, "cuda", "icl_speech_text_llm_tpu_torch/csrc/wq_matmul.cu", replaces,
               errs, *timed)
    # the wrapper's host µs a call: the least of three rounds over the shapes
    hosts = [min(h) for h in zip(*[[_host_us(r) for r in host_runs] for _ in range(3)])]
    print(f"  int4_matmul host µs a call at w_gate / w_down / wq: "
          f"{' / '.join(f'{h:.2f}' for h in hosts)} (the two-launch wrapper: "
          f"{' / '.join(f'{h:.2f}' for h in WQ_HOST_US_BEFORE)})", flush=True)
    del host_runs
    torch.cuda.empty_cache()


def _baseline_module(baseline, module):
    """``module`` (e.g. "ops.int4_matmul") of the port in another checkout of
    this repository, rooted at ``baseline``, imported as the package
    ``baseline_port``; its kernels build from that checkout's sources into
    its own build directory."""
    import importlib
    import importlib.util
    import sys

    if "baseline_port" not in sys.modules:
        pkg = os.path.join(os.path.abspath(baseline), "icl_speech_text_llm_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            "baseline_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
        sys.modules["baseline_port"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["baseline_port"])
    return importlib.import_module(f"baseline_port.{module}")


def _wq_sweep(baseline=None, reps=20):
    """Tuning aid, not part of the smoke run: at each int4 M = 4 shape and
    the K12 lm_head, the kernel's device ms at every (column tile, split)
    ``partition`` could choose, in one pass with torch's weight-only matmul
    before and after, and the chosen pair's ms and host µs. With
    ``baseline`` (the root of another checkout of this repository, e.g. the
    parent commit unpacked by ``git archive``) its wrapper runs in turns
    with this one: device ms and host µs, new, old, old, new. Run:
        python3 -c "import chip_smoke as c; c._device_phase(); c._wq_sweep('<dir>')"
    """
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.ops import int4_matmul as wq

    old = None if baseline is None else _baseline_module(baseline, "ops.int4_matmul")
    kernels.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = wq.partition
    for name, label, M, K, N, copies in WQ_CASES:
        if M != 4 or label.startswith("7B"):
            continue
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w, s = _wq_weights(gen, name, K, N, copies)
        nbytes = w[0].numel() + 4 * s[0].numel() + 2 * (M * K + M * N)
        libs = [_wq_library(name, w[c], s[c]) for c in range(copies)]
        lib_ms = [_device_ms(lambda i=0: libs[i % copies](x), reps)]
        n_steps = w.shape[1] // wq.STEP_ROWS
        pick = chosen(M, N, n_steps, sms)

        def new(i=0):
            return getattr(wq, name)(x, w[i % copies], s[i % copies])

        for tile_n in wq.TILES_N:
            line = []
            for splits in range(1, min(wq.MAX_SPLITS, n_steps) + 1):
                wq.partition = lambda *shape, p=(tile_n, splits): p
                try:
                    ms = _device_ms(new, reps)
                finally:
                    wq.partition = chosen
                work = wq.sm_work(M, N, n_steps, tile_n, splits, sms)
                mark = "*" if (tile_n, splits) == pick else ""
                line.append(f"S{splits}{mark} {ms:.4f} ({max(work) * len(work) / sum(work):.2f})")
            print(f"  sweep {name} {label} tile {tile_n}: " + ", ".join(line), flush=True)
        lib_ms.append(_device_ms(lambda i=0: libs[i % copies](x), reps))
        # the chosen pair on one weight, called again and again: from L2
        # where the weight fits in its 50 MB
        hot = _device_ms(lambda i=0: new(0), reps)
        print(f"  sweep {name} {label}: library {lib_ms[0]:.4f} / {lib_ms[1]:.4f} ms; "
              f"bound {_bound(nbytes, 2.0 * M * K * N)[0]:.4f} ms; chosen pair on one "
              f"weight again and again {hot:.4f} ms", flush=True)
        if old is not None:
            def before(i=0):
                return getattr(old, name)(x, w[i % copies], s[i % copies])

            y_new, y_old = new(), before()
            torch.cuda.synchronize()
            d = (y_new.float() - y_old.float()).abs().max().item()
            t = [_device_ms(f, reps) for f in (new, before, before, new)]
            h = [_host_us(f) for f in (new, before, before, new)]
            print(f"  sweep {name} {label}: new, old, old, new device ms "
                  f"{[round(v, 4) for v in t]}, host µs {[round(v, 2) for v in h]}; "
                  f"max |new − old| {d:.3e}", flush=True)
        del x, w, s, libs
        torch.cuda.empty_cache()


def _old_append_q8(quantize_kv, fa, cache, nk, nv, pos, staging):
    """The int8-cache append as the decode step made it before K4 q8: each
    layer's k and v rows quantized by ``quantize_kv`` into int8 staging rows
    and scales, one ``append_kv`` of the int8 rows, each scale plane written
    by ``index_put_``."""
    import torch

    ck, cv, ks, vs = cache
    k8, v8, k_s, v_s = staging
    for l in range(nk.shape[0]):
        k8[l], k_s[l] = quantize_kv(nk[l])
        v8[l], v_s[l] = quantize_kv(nv[l])
    fa.append_kv(ck, cv, k8, v8, pos)
    b_idx = torch.arange(pos.shape[0], device=pos.device)
    for plane, new in ((ks, k_s), (vs, v_s)):
        plane.permute(1, 3, 0, 2).index_put_((b_idx, pos.long()), new[..., 0].permute(1, 0, 2))


def _kernel_launches(fn):
    """(kernels launched, their summed device µs) in one call of ``fn``, from
    torch.profiler (after a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels)


def _append_kernel_rows(report, gen):
    """K4 and K4 q8, bit-exact against their plain versions. K4 into the
    Vicuna-7B bf16 cache (32, 4, 32, 1152, 128), timed in turns with two
    ``index_put_`` (no single PyTorch call writes both caches), which must
    write the same bytes, and into the salmonn-13b int8 cache with rows the
    caller quantized; B = 16 (4 beams) too. K4 q8 at the salmonn-13b
    ``--kv_int8`` shape (40, 4, 40, 1152, 128), bf16 rows, timed in turns
    with the route it replaced (``_old_append_q8``: ~900 small kernels,
    whose count and summed device time the profiler gives), which must write
    the same bytes; it has no library call. K4 q8 at 16 rows (4 beams, the
    main path's sampled-beam run: more rows than one wave of the grid
    holds, so its loop takes a second pass) against both too. Positions
    [1033, 700, 1151, 0]: the main path's lengths and both ends, each
    repeated 4 times at 16 rows. Bound: the new rows read once and the cache
    rows (and scales) written once. Host µs a call of both wrappers."""
    import torch

    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa
    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_kv

    dev = torch.device("cuda")
    bf = torch.bfloat16
    pos = torch.tensor([1033, 700, 1151, 0], dtype=torch.int32, device=dev)
    pos16 = pos.repeat_interleave(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def rand_i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def same(a, b):
        return 0.0 if all(torch.equal(x, y) for x, y in zip(a, b)) else max(
            (x.float() - y.float()).abs().max().item() for x, y in zip(a, b))

    def append_err(cache, new, p):
        plain = [t.clone() for t in cache]
        fa.append_kv(*cache, *new, p)
        fa.append_kv_plain(*plain, *new, p)
        return same(cache, plain)

    S, D = 1152, 128
    L, B, Hkv = 40, 4, 40
    errs = [("13B int8 cache, rows the caller quantized (bit-exact)",
             append_err([rand_i8(L, B, Hkv, S, D) for _ in range(2)],
                        [rand_i8(L, B, Hkv, 1, D) for _ in range(2)], pos), 0.0)]
    L, B, Hkv = 32, 16, 32
    errs.append(("7B bf16 cache, 4 beams (16 rows) (bit-exact)",
                 append_err([randn(L, B, Hkv, S, D) for _ in range(2)],
                            [randn(L, B, Hkv, 1, D) for _ in range(2)], pos16), 0.0))
    torch.cuda.empty_cache()
    L, B, Hkv = 32, 4, 32
    ck, cv = randn(L, B, Hkv, S, D), randn(L, B, Hkv, S, D)
    nk, nv = randn(L, B, Hkv, 1, D), randn(L, B, Hkv, 1, D)
    b_idx, pos_l = torch.arange(B, device=dev), pos.long()
    rows_k, rows_v = (t[:, :, :, 0].permute(1, 0, 2, 3).contiguous() for t in (nk, nv))

    def index_put(i=0, ck=ck, cv=cv):
        ck.permute(1, 3, 0, 2, 4).index_put_((b_idx, pos_l), rows_k)
        cv.permute(1, 3, 0, 2, 4).index_put_((b_idx, pos_l), rows_v)

    lib_copy = [ck.clone(), cv.clone()]
    errs.insert(0, ("7B bf16 cache (bit-exact)", append_err([ck, cv], [nk, nv], pos), 0.0))
    index_put(0, *lib_copy)
    errs.append(("index_put_ (library) vs kernel (bit-exact)", same([ck, cv], lib_copy), 0.0))
    del lib_copy
    bound = _bound(4 * L * B * Hkv * D * 2, 0.0)

    def new(i=0):
        return fa.append_kv(ck, cv, nk, nv, pos)

    ms, lib_ms = _in_turns("append_kv 7B bf16 (32, 4, 32, 1152, 128)", new, index_put, bound,
                           lib_name="index_put_ ×2", reps=50)
    report("append_kv", "cuda", "icl_speech_text_llm_tpu_torch/csrc/append_kv.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:1438", errs, ms,
           _device_ms(lambda i=0: fa.append_kv_plain(ck, cv, nk, nv, pos), reps=50),
           bound, lib_ms)
    print(f"  append_kv host µs a call {_host_us(new):.2f}", flush=True)
    del ck, cv, nk, nv, rows_k, rows_v
    torch.cuda.empty_cache()

    # K4 q8 at the 13B --kv_int8 cache
    L, Hkv = 40, 40

    def q8_case(B, p):
        """A fresh 13B int8 cache of B rows and its new bf16 rows (one all
        zero: scale 0, bytes 0), K4 q8 run once → (cache, (nk, nv), the
        replaced route's staging rows, the two bit-exact cases)."""
        cache = [rand_i8(L, B, Hkv, S, D), rand_i8(L, B, Hkv, S, D),
                 torch.rand((L, B, Hkv, S), generator=gen, device=dev),
                 torch.rand((L, B, Hkv, S), generator=gen, device=dev)]
        nk, nv = randn(L, B, Hkv, 1, D), randn(L, B, Hkv, 1, D)
        nk[0, 0, 0] = 0
        staging = [torch.empty((L, B, Hkv, 1, D), dtype=torch.int8, device=dev)
                   for _ in range(2)] + [torch.empty((L, B, Hkv, 1), device=dev)
                                         for _ in range(2)]
        plain, route = [t.clone() for t in cache], [t.clone() for t in cache]
        fa.append_kv_q8(*cache, nk, nv, p)
        fa.append_kv_q8_plain(*plain, nk, nv, p)
        _old_append_q8(quantize_kv, fa, route, nk, nv, p, staging)
        shape = f"({L}, {B}, {Hkv}, {S}, {D})"
        return cache, (nk, nv), staging, [
            (f"13B int8 cache {shape}, bf16 rows, rows and scales (bit-exact)",
             same(cache, plain), 0.0),
            (f"{shape}: the replaced route (quantize_kv, append_kv, index_put_) vs kernel "
             "(bit-exact)", same(cache, route), 0.0)]

    beams = q8_case(16, pos16)[3]
    torch.cuda.empty_cache()
    B = 4
    cache, (nk, nv), staging, errs = q8_case(B, pos)
    errs += beams
    nbytes = 2 * L * B * Hkv * D * 2 + 2 * L * B * Hkv * D + 2 * L * B * Hkv * 4 + 4 * B
    bound = _bound(nbytes, 0.0)

    def q8(i=0):
        return fa.append_kv_q8(*cache, nk, nv, pos)

    def replaced(i=0):
        _old_append_q8(quantize_kv, fa, cache, nk, nv, pos, staging)

    # the replaced route is ~900 launches a call: one call a timing, queued
    # behind the spin
    t = [_device_ms(q8, reps=50), _device_ms(replaced, reps=1), _device_ms(replaced, reps=1),
         _device_ms(q8, reps=50)]
    ms, old_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    n_old, us_old = _kernel_launches(replaced)
    print(f"  append_kv_q8 13B (40, 4, 40, 1152, 128): kernel, replaced route, replaced route, "
          f"kernel {[round(x, 4) for x in t]} ms; kernel {ms:.4f} ms = "
          f"{100 * bound[0] / ms:.1f}% of its bound {bound[0]:.4f} ms ({bound[1]}); the "
          f"replaced route {old_ms:.4f} ms ({old_ms / ms:.1f}x): {n_old} kernels summing "
          f"{us_old / 1e3:.4f} ms on the device; host µs a call {_host_us(q8):.2f}, the "
          f"replaced route's {_host_us(replaced, calls=3, trials=3):.2f}", flush=True)
    report("append_kv_q8", "cuda", "icl_speech_text_llm_tpu_torch/csrc/append_kv.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:1438 (+ ops/quant.py:36)",
           errs, ms, _device_ms(lambda i=0: fa.append_kv_q8_plain(*cache, nk, nv, pos), reps=5),
           bound, None)
    del cache, staging, nk, nv
    torch.cuda.empty_cache()


#: (label, layers, B, H, Hkv, lengths) of K7 q8 at the salmonn-13b int8
#: cache: the 4-row decode and 4 beams (the main path's 16 rows)
DECODE_Q8_CASES = (
    ("13B int8 (4, 40, 1152), layer 39", 40, 4, 40, 40, [903, 897, 900, 895]),
    ("13B int8 4 beams (16, 40, 1152)", 40, 16, 40, 40,
     [903] * 4 + [897] * 4 + [900] * 4 + [895] * 4))


def _decode_case(gen, L, B, H, Hkv, S, lens, quant):
    """K7's inputs on the card: q (B, H, 1, 128), the stacked cache (k, v[,
    k_s, v_s]) of L layers (int8 by quantize_kv where ``quant``), lengths,
    the self column (k_new, v_new)."""
    import torch

    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_kv

    dev, bf, D = torch.device("cuda"), torch.bfloat16, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, kn, vn = randn(B, H, 1, D), randn(B, Hkv, 1, D), randn(B, Hkv, 1, D)
    rows, scales = [], []
    for _ in range(2):  # k, v; layer by layer, no f32 copy of a whole cache
        c = torch.empty((L, B, Hkv, S, D), dtype=torch.int8 if quant else bf, device=dev)
        s = torch.empty((L, B, Hkv, S), dtype=torch.float32, device=dev) if quant else None
        for l in range(L):
            x = randn(B, Hkv, S, D)
            if quant:
                c[l], s[l] = quantize_kv(x)
            else:
                c[l] = x
        rows.append(c)
        scales.append(s)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    cache = (*rows, *scales) if quant else tuple(rows)
    return q, cache, lengths, (kn, vn)


def _decode_sweep(baseline=None, reps=20):
    """Tuning aid, not part of the smoke run: K7 q8 at ``DECODE_Q8_CASES``
    (one layer a call, cycling over the 40), its device ms at every cluster
    split 1-8 (the one ``decode_splits`` picks marked; each with the busiest
    SM's share of the mean and the clusters resident at once). With
    ``baseline`` (the root of another checkout of this repository, e.g. the
    parent commit unpacked by ``git archive``) that tree's wrapper runs in
    turns with this one: device ms new, old, old, new, and max |new − old|.
    Run:
        python3 -c "import chip_smoke as c; c._device_phase(); c._decode_sweep('<dir>')"
    """
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    old = None if baseline is None else _baseline_module(baseline, "ops.flash_attention")
    lib = kernels.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = fa.decode_splits
    for label, L, B, H, Hkv, lens in DECODE_Q8_CASES:
        q, cache, lengths, self_kv = _decode_case(gen, L, B, H, Hkv, 1152, lens, True)
        nbytes = Hkv * sum(lens) * (2 * 128 + 8) + 2 * 2 * B * H * 128 + 2 * 2 * B * Hkv * 128
        bound = _bound(nbytes, 4.0 * 128 * H * sum(n + 1 for n in lens))[0]
        pick = chosen(B, Hkv, sms, fa.decode_resident(0, H // Hkv))

        def new(i=0):
            return fa.flash_decode_attention_q8(q, *cache, lengths, self_kv=self_kv,
                                                layer=i % L)

        line = []
        for splits in range(1, fa.DECODE_MAX_SPLITS + 1):
            fa.decode_splits = lambda *shape, c=splits: c
            try:
                ms = _device_ms(new, reps)
            finally:
                fa.decode_splits = chosen
            work = fa.decode_sm_blocks(B * Hkv * splits, sms)
            fit = lib.iclk_flash_decode_q8_max_clusters(H // Hkv, splits)
            line.append(f"c{splits}{'*' if splits == pick else ''} {ms:.4f} "
                        f"({max(work) * sms / sum(work):.2f}, {fit} resident)")
        print(f"  sweep flash_decode_attention_q8 {label} (bound {bound:.4f} ms): "
              + ", ".join(line), flush=True)
        if old is not None:
            def before(i=0):
                return old.flash_decode_attention_q8(q, *cache, lengths, self_kv=self_kv,
                                                     layer=i % L)

            y_new, y_old = new(L - 1), before(L - 1)
            torch.cuda.synchronize()
            d = (y_new.float() - y_old.float()).abs().max().item()
            t = [_device_ms(f, reps) for f in (new, before, before, new)]
            print(f"  sweep flash_decode_attention_q8 {label}: new, old, old, new device ms "
                  f"{[round(v, 4) for v in t]}; max |new − old| {d:.3e}", flush=True)
        del q, cache, lengths, self_kv
        torch.cuda.empty_cache()


def _decode_kernel_rows(report, gen):
    """K7 at the decode steps' shapes, against its plain version: the 7B
    bf16 stacked cache (32, 4, 32, 1152, 128) with ~900 cached positions a
    sample (timed, one layer a call, cycling over the 32 layers, so each call
    reads its rows from device memory), the same with 4 beams (16 rows) and
    with GQA (n_rep 4); the 13B int8 cache (40, 4, 40, 1152, 128) with f32
    scales (timed) and with 4 beams. The current token's column is folded in
    as on the main path. Bound per output row (``_row_case``); the plain
    version's arithmetic is the kernel's: f32 scores, p in bf16 for P·V.
    Library: one F.scaled_dot_product_attention over the cache rows with the
    current token's column concatenated (the concatenation, a copy of the
    cache, made outside the timed call) under a boolean length mask; none for
    the int8 cache, which no PyTorch call takes. K7 q8 is timed at both
    shapes (the row's numbers are the 4-row shape's; the 16-row shape's,
    where the main path's launches are, go under the row's "beam" key), each
    printed with its cluster split and, for reference only, the time of SDPA
    over a bf16 dequantized copy of the same rows (made outside the timed
    call): what reading the int8 cache saves."""
    import torch
    import torch.nn.functional as F

    from icl_speech_text_llm_tpu_torch import kernels as built
    from icl_speech_text_llm_tpu_torch.models.llama import _xla_decode_attn
    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf = torch.bfloat16
    D = 128

    def case(L, B, H, Hkv, S, lens, quant):
        return _decode_case(gen, L, B, H, Hkv, S, lens, quant)

    def kernel(q, cache, lengths, self_kv, layer):
        fn = fa.flash_decode_attention_q8 if len(cache) == 4 else fa.flash_decode_attention
        return fn(q, *cache, lengths, self_kv=self_kv, layer=layer)

    def plain(q, cache, lengths, self_kv, layer):
        c = [t[layer] for t in cache]
        return fa.flash_decode_attention_plain(q, c[0], c[1], lengths, self_kv=self_kv,
                                               k_s=c[2] if len(c) == 4 else None,
                                               v_s=c[3] if len(c) == 4 else None)

    for name, quant, cases in (
            ("flash_decode_attention", False, [
                ("7B bf16 (4, 32, 1152), layer 31", 32, 4, 32, 32, [903, 897, 900, 895]),
                ("7B bf16 4 beams (16, 32, 1152)", 32, 16, 32, 32, [903] * 4 + [897] * 4
                 + [900] * 4 + [895] * 4),
                ("GQA n_rep 4 (4, 32 / 8, 1152)", 4, 4, 32, 8, [1151, 640, 1, 0])]),
            ("flash_decode_attention_q8", True, DECODE_Q8_CASES)):
        errs, timed = [], None
        for label, L, B, H, Hkv, lens in cases:
            q, cache, lengths, self_kv = case(L, B, H, Hkv, 1152, lens, quant)
            layer = L - 1
            got = kernel(q, cache, lengths, self_kv, layer)
            ref = plain(q, cache, lengths, self_kv, layer)
            torch.cuda.synchronize()
            errs.append(_row_case(label, got, ref))
            if "beams" in label and not quant:
                # the beam step's other cache cost: both leaves follow the beams
                perm = torch.arange(B, device=dev).flip(0)
                reorder_ms = _device_ms(lambda i=0: [c.index_select(1, perm) for c in cache],
                                        reps=5)
                print(f"  {label}: reorder of the whole cache (index_select of k and v, "
                      f"{2 * cache[0].numel() * 2 / 1e9:.2f} GB each way) {reorder_ms:.4f} ms",
                      flush=True)
            if timed is None and not quant:
                # the default decode attention (``"xla"``) on the same layer
                xla_ms = _device_ms(lambda i=0: _xla_decode_attn(
                    None, q, cache[0][i % L], cache[1][i % L], *self_kv, lengths))
                print(f"  {label}: _xla_decode_attn {xla_ms:.4f} ms a layer", flush=True)
            if timed is None or quant:
                ms = _device_ms(lambda i=0: kernel(q, cache, lengths, self_kv, i % L))
                plain_ms = _device_ms(lambda i=0: plain(q, cache, lengths, self_kv, i % L),
                                      reps=5)
                # k and v rows below the lengths (int8: + two f32 scales a row),
                # q and o, the current token's k and v
                row_bytes = 2 * D + 8 if quant else 4 * D
                nbytes = Hkv * sum(lens) * row_bytes + 2 * 2 * B * H * D + 2 * 2 * B * Hkv * D
                flops = 4.0 * D * H * sum(n + 1 for n in lens)
                library_ms = None
                if not quant:
                    S = cache[0].shape[3]
                    kc = torch.cat([cache[0][layer], self_kv[0]], dim=2)
                    vc = torch.cat([cache[1][layer], self_kv[1]], dim=2)
                    cols = torch.arange(S + 1, device=dev)
                    mask = ((cols[None, :] < lengths[:, None]) | (cols[None, :] == S))
                    mask = mask[:, None, None, :]
                    lib = F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)
                    errs.append((f"{label}: SDPA over the concatenated cache vs plain",
                                 (lib.float() - ref.float()).abs().max().item(), 2e-2))
                    library_ms = _device_ms(lambda i=0: F.scaled_dot_product_attention(
                        q, kc, vc, attn_mask=mask))
                    del kc, vc
                else:
                    S = cache[0].shape[3]
                    kc, vc = (torch.cat([(cache[j][layer].float()
                                          * cache[j + 2][layer][..., None]).to(bf),
                                         self_kv[j]], dim=2) for j in (0, 1))
                    cols = torch.arange(S + 1, device=dev)
                    mask = ((cols[None, :] < lengths[:, None]) | (cols[None, :] == S))
                    mask = mask[:, None, None, :]
                    deq_ms = _device_ms(lambda i=0: F.scaled_dot_product_attention(
                        q, kc, vc, attn_mask=mask))
                    splits = fa.decode_splits(B, Hkv, sms, fa.decode_resident(0, H // Hkv))
                    work = fa.decode_sm_blocks(B * Hkv * splits, sms)
                    fit = built.lib().iclk_flash_decode_q8_max_clusters(H // Hkv, splits)
                    print(f"  {name} {label}: clusters of {splits}, {B * Hkv * splits} blocks, "
                          f"busiest SM {max(work) * sms / sum(work):.3f}× the mean, "
                          f"{fit} clusters resident at once; for reference, SDPA over a "
                          f"bf16 dequantized copy {deq_ms:.4f} ms", flush=True)
                    del kc, vc
                bound = _bound(nbytes, flops)
                if timed is None:
                    timed = (ms, plain_ms, bound, library_ms)
                else:
                    beam = (ms, bound[0])
                print(f"  {name} {label}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of "
                      f"{nbytes / 1e6:.2f} MB) = {100 * bound[0] / ms:.1f}% of its bound "
                      f"{bound[0]:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            del q, cache, lengths, self_kv, got, ref
            torch.cuda.empty_cache()
        row = report(name, "cuda", "icl_speech_text_llm_tpu_torch/csrc/flash_decode.cu",
                     "icl_speech_text_llm_tpu/ops/flash_attention.py:1281", errs, *timed)
        if quant:
            row["beam"] = beam


def _kernel_phase():
    """Kernel vs plain version on the card at the shapes the main paths give
    it: the 7B and 13B prefills (K1), Whisper (K2), BEATs (K3), the 7B bf16
    and 13B int8 caches (K4, K4 q8), the 7B training backward (K5, K6), the
    13B int4 and 7B / 13B int8 products (K10, W8A16)."""
    import torch
    import torch.nn.functional as F

    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rows = []

    def report(name, route, source, replaces, errs, ms, plain_ms, bound, library_ms):
        """One kernel row; ``bound`` = (ms, "bytes" | "operations") from this
        run's inputs, ``library_ms`` a PyTorch call's time or None."""
        worst = 0.0
        for what, err, tol, *abs_err in errs:  # a row case also gives its abs error
            ok = err <= tol
            extra = f", max_abs_err {abs_err[0]:.3e}" if abs_err else ""
            kind = "" if abs_err else "max_abs_err "
            print(f"  {name} {what}: {kind}{err:.3e} (tolerance {tol:.1e}){extra} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} {what} error {err} > {tol}")
            worst = max(worst, abs_err[0] if abs_err else err)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}), library call {lib}", flush=True)
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "max_abs_err": worst,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms})
        return rows[-1]

    def valid_rows_err(a, b, lengths):
        d = (a.float() - b.float()).abs()
        worst = 0.0
        for i, n in enumerate(lengths):
            worst = max(worst, d[i, :, :n].max().item())
        return worst

    def stat_errs(ker, ref, lengths):
        o_err = valid_rows_err(ker[0], ref[0], lengths)
        m_err = valid_rows_err(ker[1][..., None], ref[1][..., None], lengths)
        l_rel = valid_rows_err((ker[2] / ref[2])[..., None],
                               torch.ones_like(ref[2])[..., None], lengths)
        return [("o", o_err, 2e-2), ("m", m_err, 1e-3), ("l (relative)", l_rel, 1e-3)]

    # K1: LLM prefill, (4, 32, 1024, 128) causal, ragged lengths; then GQA;
    # then the salmonn-13b prefill, (4, 40, 1024, 128)
    B, H, S, D = 4, 32, 1024, 128
    lens = [1024, 901, 640, 333]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    ker = fa.flash_attention_causal(q, k, v, lengths)
    ref = fa.flash_attention_plain(q, k, v, lengths, causal=True)
    errs = stat_errs(ker, ref, lens)
    kg, vg = randn(B, H // 2, S, D), randn(B, H // 2, S, D)
    ker_g = fa.flash_attention_causal(q, kg, vg, lengths)
    ref_g = fa.flash_attention_plain(q, kg, vg, lengths, causal=True)
    errs += [(f"GQA {what}", e, tol) for what, e, tol in stat_errs(ker_g, ref_g, lens)]
    q13, k13, v13 = (randn(B, 40, S, D) for _ in range(3))
    ker_13 = fa.flash_attention_causal(q13, k13, v13, lengths)
    ref_13 = fa.flash_attention_plain(q13, k13, v13, lengths, causal=True)
    errs += [(f"13B (4, 40, 1024, 128) {what}", e, tol)
             for what, e, tol in stat_errs(ker_13, ref_13, lens)]
    del q13, k13, v13, ker_13, ref_13, kg, vg, ker_g, ref_g
    # library: one SDPA call with the causal and key-length mask, timed in
    # turns with the kernel, both queued behind a device spin
    rows_i = torch.arange(S, device=dev)
    sdpa_mask = ((rows_i[None, :] <= rows_i[:, None])[None]
                 & (rows_i[None, None, :] < lengths[:, None, None]))[:, None]
    nbytes = 2 * 2 * B * H * S * D + 2 * 2 * H * D * sum(lens) + 2 * 4 * B * H * S
    bound = _bound(nbytes, 4.0 * D * H * _causal_pairs(S, lens))
    ms, lib_ms = _in_turns(
        "flash_attention_causal (4, 32, 1024, 128)",
        lambda i=0: fa.flash_attention_causal(q, k, v, lengths),
        lambda i=0: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), bound)
    report("flash_attention_causal", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/flash_fwd.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:145", errs, ms,
           _time_ms(lambda: fa.flash_attention_plain(q, k, v, lengths, True)), bound, lib_ms)
    del sdpa_mask

    # K2: Whisper encoder, (24, 20, 1500, 64) non-causal, all 1500 keys valid
    B, H, S, D = 24, 20, 1500, 64
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    ker = fa.flash_attention_noncausal(q, k, v)
    ref = fa.flash_attention_plain(q, k, v, None, causal=False)
    errs = stat_errs(ker, ref, [S] * B)
    del ker, ref
    bound = _bound(4 * 2 * B * H * S * D + 2 * 4 * B * H * S, 4.0 * D * B * H * S * S)
    ms, lib_ms = _in_turns("flash_attention_noncausal (24, 20, 1500, 64)",
                           lambda i=0: fa.flash_attention_noncausal(q, k, v),
                           lambda i=0: F.scaled_dot_product_attention(q, k, v), bound)
    report("flash_attention_noncausal", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/flash_fwd.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:238", errs, ms,
           _time_ms(lambda: fa.flash_attention_plain(q, k, v, None, False)), bound, lib_ms)
    del q, k, v

    # K3: BEATs gated relative-position bias, (24, 12, 1496, 64)
    B, H, S, D = 24, 12, 1496, 64
    q, k, v, xh = (randn(B, H, S, D) for _ in range(4))
    bias = randn(H, S, S, scale=0.5)
    grep_w = torch.randn((D, 8), generator=gen, device=dev) * 0.2
    grep_b = torch.randn((8,), generator=gen, device=dev) * 0.1
    grep_a = 1.0 + 0.1 * torch.randn((H,), generator=gen, device=dev)
    args = (q, k, v, xh, bias, grep_w, grep_b, grep_a)
    gate = fa.gate_rows(xh, grep_w, grep_b, grep_a)
    # library, for K3, K8 and K9: one SDPA call with the additive mask g·bias
    # (every key valid at this shape) materialised as (B, H, S, S) bf16
    # outside the timed call, 1.29 GB; K3, K8 and K9 are timed in turns with it
    add_mask = torch.empty((B, H, S, S), dtype=bf, device=dev)
    for b in range(B):
        add_mask[b] = (gate[b][..., None] * bias.float()).to(bf)

    def masked_sdpa(i=0):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=add_mask)

    # the work of K3, K8 and K9: q·kᵀ and p·v over every (row, key) pair; the
    # bias (H, S, S) bf16 read once; K9 reads f32 gate rows instead of xh
    gated_flops = 4.0 * D * B * H * S * S + 2.0 * 8 * D * B * H * S
    bias_bytes = 2 * H * S * S
    gated_bound = _bound(5 * 2 * B * H * S * D + bias_bytes, gated_flops)
    # K3 and K8 at the main path's shape, and at B = 22 with ragged lengths.
    # K8 (and K9) are held to the
    # f32-exp2 form of their plain versions, the kernels' arithmetic; the
    # Pallas kernels' bf16 rounding (the CPU path's) would put a floor of
    # ~8e-3 under the comparison
    lens22 = [S - 37 * i for i in range(22)]
    sub22 = (q[:22], k[:22], v[:22], xh[:22], bias, grep_w, grep_b, grep_a,
             torch.tensor(lens22, device=dev))
    errs = [_row_case("o (24, 12, 1496, 64)", fa.gated_bias_attention(*args),
                      fa.gated_bias_attention_plain(*args)),
            _row_case("o B = 22, ragged lengths", fa.gated_bias_attention(*sub22),
                      fa.gated_bias_attention_plain(*sub22))]
    ms, lib_ms = _in_turns("gated_bias_attention (24, 12, 1496, 64)",
                           lambda i=0: fa.gated_bias_attention(*args), masked_sdpa, gated_bound)
    report("gated_bias_attention", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/gated_bias.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:840", errs, ms,
           _time_ms(lambda: fa.gated_bias_attention_plain(*args)), gated_bound, lib_ms)
    errs = [_row_case("o (24, 12, 1496, 64)", fa.gated_bias_attention(*args, batch_block=True),
                      fa.gated_bias_batched_plain(*args, pallas_rounding=False)),
            _row_case("o B = 22, ragged lengths",
                      fa.gated_bias_attention(*sub22, batch_block=True),
                      fa.gated_bias_batched_plain(*sub22, pallas_rounding=False))]
    ms, lib_ms = _in_turns("gated_bias_attention_batched (24, 12, 1496, 64)",
                           lambda i=0: fa.gated_bias_attention(*args, batch_block=True),
                           masked_sdpa, gated_bound)
    report("gated_bias_attention_batched", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/gated_bias.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:802", errs, ms,
           _time_ms(lambda: fa.gated_bias_batched_plain(*args, pallas_rounding=False)),
           gated_bound, lib_ms)
    del sub22
    # K9: the gate rows precomputed (as BEATs lean_bias_flash computes them),
    # timed in turns with the same SDPA call
    rargs = (q, k, v, gate, bias)
    ker = fa.gated_bias_attention_rows(*rargs)
    ref = fa.gated_bias_rows_plain(*rargs, pallas_rounding=False)
    errs = [_row_case("o (24, 12, 1496, 64)", ker, ref)]
    sub22 = (q[:22], k[:22], v[:22], gate[:22], bias, torch.tensor(lens22, device=dev))
    errs.append(_row_case("o B = 22, ragged lengths", fa.gated_bias_attention_rows(*sub22),
                         fa.gated_bias_rows_plain(*sub22, pallas_rounding=False)))
    rows_bound = _bound(4 * 2 * B * H * S * D + 4 * B * H * S + bias_bytes, gated_flops)
    ms, lib_ms = _in_turns("gated_bias_attention_rows (24, 12, 1496, 64)",
                           lambda i=0: fa.gated_bias_attention_rows(*rargs), masked_sdpa,
                           rows_bound)
    report("gated_bias_attention_rows", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/gated_bias.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:1044", errs, ms,
           _time_ms(lambda: fa.gated_bias_rows_plain(*rargs, pallas_rounding=False)),
           rows_bound, lib_ms)
    del add_mask
    del args, rargs, sub22, q, k, v, xh, bias, gate, ker, ref
    torch.cuda.empty_cache()

    _append_kernel_rows(report, gen)
    _decode_kernel_rows(report, gen)

    # K5/K6: the LLM training backward, (4, 32, 1024, 128) causal with ragged
    # lengths and do zero past each length, the same with Hkv = 16 (GQA), and
    # the Whisper shape (4, 20, 1500, 64) non-causal. Bound per tensor:
    # 2e-2 × max |plain gradient| over valid rows; the plain version gets the
    # same bf16 inputs, computed in f32.
    dq_errs, dkv_errs, timed = [], [], None
    for label, B, H, Hkv, S, D, lens, causal in (
            ("causal", 4, 32, 32, 1024, 128, [1024, 901, 640, 333], True),
            ("causal GQA", 4, 32, 16, 1024, 128, [1024, 901, 640, 333], True),
            ("non-causal", 4, 20, 20, 1500, 64, None, False)):
        q, do = randn(B, H, S, D), randn(B, H, S, D)
        k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = [S] * B if lens is None else lens
        if lengths is not None:
            keep = torch.arange(S, device=dev)[None, :] < lengths[:, None]
            do = do * keep[:, None, :, None].to(bf)
        fwd = fa.flash_attention_causal if causal else fa.flash_attention_noncausal
        o, m, l = fwd(q, k, v, lengths)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, m, l, do, lengths, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, m, l, delta, do, lengths, causal)
        f = [t.float() for t in (q, k, v, o)]
        dq_p, delta_p = fa.flash_attention_bwd_dq_plain(*f, m, l, do.float(), lengths, causal)
        dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(*f[:3], m, l, delta_p, do.float(),
                                                      lengths, causal)

        def rel_bound(ker, ref, scale=2e-2):
            return (valid_rows_err(ker, ref, valid),
                    scale * valid_rows_err(ref, torch.zeros_like(ref), valid))

        for errs, name, ker, ref, scale in (
                (dq_errs, "dq", dq, dq_p, 2e-2),
                (dq_errs, "delta", delta[..., None], delta_p[..., None], 1e-3),
                (dkv_errs, "dk", dk, dk_p, 2e-2), (dkv_errs, "dv", dv, dv_p, 2e-2)):
            errs.append((f"{label} {name} (bound {scale:g} × max |plain|)",
                         *rel_bound(ker, ref, scale)))
        if timed is None:  # the main path's shape
            args = (q, k, v, o, m, l, do, lengths, causal)
            args_kv = (q, k, v, m, l, delta, do, lengths, causal)
            pairs = H * _causal_pairs(S, lens)
            qo = 2 * B * H * S * D  # bytes of one (B, H, S, D) bf16 tensor
            kv_len = 2 * 2 * Hkv * D * sum(lens)  # k and v rows below the lengths
            # dq: q·kᵀ, do·vᵀ, ds·k; dk/dv: those two and pᵀ·do, dsᵀ·q. No
            # single PyTorch call returns dq alone or dk/dv alone: the library
            # column of both rows is one SDPA backward (dq, dk, dv) of K1's
            # masked call, a retained graph's torch.autograd.grad, timed in
            # turns with K5 + K6 together (bound: the function's bytes and
            # its five products, q·kᵀ and do·vᵀ once); each kernel alone is
            # timed behind the device spin too
            rows_i = torch.arange(S, device=dev)
            sdpa_mask = ((rows_i[None, :] <= rows_i[:, None])[None]
                         & (rows_i[None, None, :] < lengths[:, None, None]))[:, None]
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
            stats = 3 * 4 * B * H * S  # m, l, delta
            _, sdpa_bwd_ms = _in_turns(
                f"{label} backward K5 + K6 (4, 32, 1024, 128)",
                lambda i=0: (fa.flash_attention_bwd_dq(*args),
                             fa.flash_attention_bwd_dkv(*args_kv)),
                lambda i=0: torch.autograd.grad(out, leaves, do, retain_graph=True),
                _bound(4 * qo + kv_len + 2 * 2 * B * Hkv * S * D + stats, 10.0 * D * pairs),
                lib_name="SDPA backward", reps=10)
            del leaves, out, sdpa_mask
            timed = {
                "dq": (_device_ms(lambda i=0: fa.flash_attention_bwd_dq(*args)),
                       _time_ms(lambda: fa.flash_attention_bwd_dq_plain(*args)),
                       _bound(4 * qo + kv_len + stats, 6.0 * D * pairs), sdpa_bwd_ms),
                "dkv": (_device_ms(lambda i=0: fa.flash_attention_bwd_dkv(*args_kv)),
                        _time_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args_kv)),
                        _bound(2 * qo + kv_len + 2 * 2 * B * Hkv * S * D + stats,
                               8.0 * D * pairs), sdpa_bwd_ms)}
            print(f"  {label} backward alone: K5 {timed['dq'][0]:.4f} ms, K6 "
                  f"{timed['dkv'][0]:.4f} ms", flush=True)
        del q, k, v, do, o, m, l, dq, dk, dv, delta, f, dq_p, dk_p, dv_p, delta_p
        torch.cuda.empty_cache()
    report("flash_attention_bwd_dq", "cuda", "icl_speech_text_llm_tpu_torch/csrc/flash_bwd.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:432", dq_errs, *timed["dq"])
    report("flash_attention_bwd_dkv", "cuda", "icl_speech_text_llm_tpu_torch/csrc/flash_bwd.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:455", dkv_errs, *timed["dkv"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _wq_kernel_rows(report, gen)
    _probe_kernel_rows(report, gen)
    return rows


def _one_layer(cfg):
    """A SALMONN config with one layer per stack at the same widths."""
    return dataclasses.replace(
        cfg,
        whisper=dataclasses.replace(cfg.whisper, n_layers=1),
        beats=dataclasses.replace(cfg.beats, n_layers=1),
        llm=dataclasses.replace(cfg.llm, n_layers=1),
    )


def _check_batch(cfg, seed):
    """One request: 20 text positions, clip 0 (88), 20 text, clip 1 (88) of
    5 s clips, in a 256-position prompt → (batch, lengths)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    B, n_slots, L, n_text = 1, 2, 256, 40
    T_a = cfg.audio_tokens_per_slot
    wavs = (rng.randn(B, n_slots, 5 * 16000) * 3000).astype(np.int16)
    text = rng.randint(3, cfg.llm.vocab_size, size=(B, n_text)).astype(np.int32)
    idx = np.concatenate([1 + np.arange(20), 1 + n_text + np.arange(T_a),
                          21 + np.arange(20), 1 + n_text + T_a + np.arange(T_a)])
    gather = np.zeros((B, L), np.int64)
    gather[0, :len(idx)] = idx
    return {"text_tokens": text, "gather_idx": gather, "wavs": wavs}, \
        np.array([len(idx)], np.int32)


def _logits_run(cfg, params, batch, lengths, device, tokens, kv_int8, attention):
    """First-token logits, then one decode step (``attention``) per given
    token → a list of (1, V) f32 CPU tensors."""
    import torch

    from icl_speech_text_llm_tpu_torch.inference.engine import prefill, speech_sequence
    from icl_speech_text_llm_tpu_torch.models.llama import decode_step, embed_tokens, lm_logits

    with torch.inference_mode():
        seq = speech_sequence(cfg, params, {k: torch.as_tensor(v, device=device)
                                            for k, v in batch.items()})
        cur = torch.as_tensor(lengths, device=device)
        scaling = cfg.lora.scaling
        logits, cache = prefill(cfg.llm, params["llm"], seq, cur, seq.shape[1] + 128,
                                params["lora"], scaling, cfg.compute_dtype, kv_int8=kv_int8)
        out = [logits.float().cpu()]
        for tok in tokens:
            emb = embed_tokens(params["llm"], torch.tensor([[tok]], device=device),
                               dtype=cfg.compute_dtype)
            hidden, cache = decode_step(cfg.llm, params["llm"], emb, cache, cur,
                                        params["lora"], scaling, attention)
            out.append(lm_logits(cfg.llm, params["llm"], hidden)[:, 0].float().cpu())
            cur = cur + 1
    return out


def _cpu_reference(cfg, params, batch, lengths, kv_int8, steps=3):
    """The f32 plain path on the CPU and its greedy tokens → (logits list,
    tokens)."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import DecodeAttention

    cpu_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    cpu_params = _tree_to(params, torch.device("cpu"), torch.float32)
    toks = []
    ref = _logits_run(cpu_cfg, cpu_params, batch, lengths, "cpu", toks, kv_int8,
                      DecodeAttention.XLA)
    for _ in range(steps):
        toks.append(int(ref[-1].argmax(-1)[0]))
        ref = _logits_run(cpu_cfg, cpu_params, batch, lengths, "cpu", toks, kv_int8,
                          DecodeAttention.XLA)
    return ref, toks


def _compare_logits(label, got, ref):
    import torch

    for i, (g, r) in enumerate(zip(got, ref)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: non-finite logits on the card (step {i})")
        err = (g - r).abs().max().item()
        tol = 5e-2 * r.abs().max().item()
        what = "first-token" if i == 0 else f"decode step {i}"
        print(f"  {label} {what} logits: max_abs_err {err:.4e} vs f32 CPU (tolerance "
              f"{tol:.4e} = 5% of max |logit|); argmax {g.argmax(-1).tolist()} vs "
              f"{r.argmax(-1).tolist()}", flush=True)
        if err > tol:
            raise AssertionError(f"{label}: reference check failed at {what}: {err} > {tol}")


def _checked_launches(label, fn, need, none=()):
    """Run ``fn`` and require at least ``need[name]`` launches of each kernel
    and no launch of the kernels ``none``."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels

    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in (*need, *none)}
    print(f"  {label}: launches {launched} (need {need}, none of {list(none)})", flush=True)
    if any(launched[k] < n for k, n in need.items()) or any(launched[k] for k in none):
        raise AssertionError(f"{label} did not run its kernels, or ran others: {launched}")
    return out


def _reference_phase():
    """salmonn-7b widths with one layer per stack: the bf16 kernel path on the
    card against the f32 plain path on the CPU, same weights and inputs: the
    first-token logits, then 3 decode steps through the flash-decode kernel
    (K7) fed the CPU path's greedy tokens."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import DecodeAttention
    from icl_speech_text_llm_tpu_torch.models.salmonn import init_salmonn, salmonn_7b

    cfg = _one_layer(salmonn_7b())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_salmonn(cfg, gen, dev, torch.bfloat16)
    batch, lengths = _check_batch(cfg, 0)
    ref, toks = _cpu_reference(cfg, params, batch, lengths, kv_int8=False)
    got = _checked_launches(
        "7B bf16 one-layer check with K7",
        lambda: _logits_run(cfg, params, batch, lengths, dev, toks, False,
                            DecodeAttention.FLASH),
        {"flash_decode_attention": 3, "flash_attention_causal": 1, "append_kv": 3})
    _compare_logits("7B bf16", got, ref)
    del params
    torch.cuda.empty_cache()


def _quant_reference_phase():
    """salmonn-13b widths with one layer per stack, the decoder quantized to
    int4 by the main path's ``quantize_decoder`` (the lm_head int8) and an
    int8 KV cache: the bf16 kernel path on the card (K10 in the M = 256
    prefill and the M = 1 decode steps, W8A16 for the logits; the decode
    attention first the default, then the flash-decode kernel on the int8
    cache) against the f32 plain path on the CPU on the same quantized tree.
    The decode steps feed both sides the CPU path's greedy tokens."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import DecodeAttention
    from icl_speech_text_llm_tpu_torch.models.salmonn import init_salmonn, salmonn_13b
    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_decoder

    cfg = _one_layer(salmonn_13b())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    params = init_salmonn(cfg, gen, dev, torch.bfloat16)
    quantize_decoder(params["llm"], bits=4)
    batch, lengths = _check_batch(cfg, 2)
    ref, toks = _cpu_reference(cfg, params, batch, lengths, kv_int8=True)
    for label, attention, need in (
            ("13B int4 + int8 KV", DecodeAttention.XLA, {}),
            ("13B int4 + int8 KV with K7 q8", DecodeAttention.FLASH,
             {"flash_decode_attention_q8": 3})):
        got = _checked_launches(
            label + " one-layer check",
            lambda: _logits_run(cfg, params, batch, lengths, dev, toks, True, attention),
            {"int4_matmul": 7 * 4, "int8_matmul": 4, "append_kv_q8": 3, **need}, {"append_kv"})
        _compare_logits(label, got, ref)
    del params
    torch.cuda.empty_cache()


def _step_launches(old=None):
    """Kernels launched by one decode step (torch.profiler, after a warm-up
    step) at the main path's widths, random weights, batch 4 at ~900 cached
    positions, the default decode attention: salmonn-13b's decoder with int4
    weights over an int8 cache of 1152 positions, and salmonn-7b's bf16
    decoder over a bf16 cache. Also each step's time (CUDA events around a
    synchronised step, which the host paces: the least of 10). ``old``:
    another tree's ``models.llama`` (``_append_sweep``), whose
    ``decode_step`` on the same weights and cache is counted too and timed
    in turns with this one's. Prints one line."""
    import torch

    from icl_speech_text_llm_tpu_torch.models import llama

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S = 4, 1152
    cur = torch.tensor([903, 897, 900, 895], dtype=torch.int32, device=dev)
    parts = []
    for label, name, quant in (("13B int4 + int8 KV", "vicuna-13b", True),
                               ("7B bf16", "vicuna-7b", False)):
        cfg = llama.DECODER_CONFIGS[name]
        params = (llama.init_decoder_quantized(cfg, gen, dev, bits=4) if quant
                  else llama.init_decoder(cfg, gen, dev, torch.bfloat16))
        cache = llama.init_kv_cache(cfg, B, S, device=dev, quant=quant)
        x = torch.randn((B, 1, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)

        def step():
            return llama.decode_step(cfg, params, x, cache, cur)

        with torch.inference_mode():
            part = f"{label} {_kernel_launches(step)[0]}"
            if old is None:
                part += f", step ms (CUDA events, least of 10) {_time_ms(step, stat=min):.3f}"
            else:
                def old_step():
                    return old.decode_step(cfg, params, x, cache, cur)

                times = [_time_ms(f, stat=min) for f in (step, old_step, old_step, step)]
                part += (f" (the baseline's decode_step: {_kernel_launches(old_step)[0]}), step "
                         f"ms (CUDA events, least of 10; new, baseline, baseline, new) "
                         f"{[round(t, 3) for t in times]}")
        parts.append(part)
        del params, cache
        torch.cuda.empty_cache()
    print(f"  kernels launched by one decode step (torch.profiler): {'; '.join(parts)}",
          flush=True)


def _append_sweep(baseline, reps=50):
    """Measuring aid, not part of the smoke run: K4 and the decode step
    against ``baseline`` (the root of another checkout of this repository,
    e.g. the tree before K4's redesign unpacked by ``git archive``). K4 at
    the Vicuna-7B bf16 cache (32, 4, 32, 1152, 128) in turns with that
    tree's ``append_kv``: device ms and host µs, new, old, old, new (the two
    must write the same bytes); then ``_step_launches`` with that tree's
    ``decode_step``. Run:
        python3 -c "import chip_smoke as c; c._device_phase(); c._append_sweep('<dir>')"
    """
    import torch

    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    old = _baseline_module(baseline, "ops.flash_attention")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    L, B, Hkv, S, D = 32, 4, 32, 1152, 128
    ck, cv, nk, nv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for shape in [(L, B, Hkv, S, D)] * 2 + [(L, B, Hkv, 1, D)] * 2)
    pos = torch.tensor([1033, 700, 1151, 0], dtype=torch.int32, device=dev)
    ck2, cv2 = ck.clone(), cv.clone()

    def new(i=0):
        return fa.append_kv(ck, cv, nk, nv, pos)

    def before(i=0):
        return old.append_kv(ck, cv, nk, nv, pos)

    new()
    old.append_kv(ck2, cv2, nk, nv, pos)
    if not (torch.equal(ck, ck2) and torch.equal(cv, cv2)):
        raise AssertionError("append_kv: this tree's and the baseline's caches differ")
    _in_turns("append_kv 7B bf16 (32, 4, 32, 1152, 128), the baseline's kernel", new, before,
              _bound(4 * L * B * Hkv * D * 2, 0.0), lib_name="baseline append_kv", reps=reps)
    h = [_host_us(f) for f in (new, before, before, new)]
    print(f"  append_kv host µs a call: new, baseline, baseline, new "
          f"{[round(v, 2) for v in h]}", flush=True)
    del ck, cv, nk, nv, ck2, cv2
    torch.cuda.empty_cache()
    _step_launches(_baseline_module(baseline, "models.llama"))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _train_check_phase():
    """salmonn-7b widths with one layer per stack: the training loss and the
    trainable gradients of the bf16 kernel path on the card (K1 forward, K5
    and K6 backward) against the f32 plain path on the CPU, same weights and
    batch. LoRA B is drawn non-zero so that the A gradients are non-zero
    too; the Q-Former gradient flows back through dq, dk and dv."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.models.salmonn import (
        init_salmonn,
        salmonn_7b,
        salmonn_train_loss,
    )
    from icl_speech_text_llm_tpu_torch.training.step import merge_params, split_params, tree_map

    cfg = _one_layer(salmonn_7b())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    params = init_salmonn(cfg, gen, dev, torch.bfloat16, trainable_dtype=torch.float32)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=dev) * 0.02
    rng = np.random.RandomState(1)
    B, n_slots, L, n_text = 2, 2, 256, 40
    T_a = cfg.audio_tokens_per_slot
    wavs = (rng.randn(B, n_slots, 5 * 16000) * 3000).astype(np.int16)
    text = rng.randint(3, cfg.llm.vocab_size, size=(B, n_text)).astype(np.int32)
    gather = np.zeros((B, L), np.int64)
    mask = np.zeros((B, L), np.int32)
    labels = np.full((B, L), -100, np.int64)
    for b, n in enumerate((20, 10)):  # text, clip 0, text, clip 1; ragged lengths
        idx = np.concatenate([1 + np.arange(n), 1 + n_text + np.arange(T_a),
                              1 + n + np.arange(n), 1 + n_text + T_a + np.arange(T_a)])
        gather[b, :len(idx)] = idx
        mask[b, :len(idx)] = 1
        labels[b, len(idx) - 6:len(idx) - 1] = rng.randint(3, cfg.llm.vocab_size, 5)
    batch = {"text_tokens": text, "gather_idx": gather, "seq_mask": mask,
             "shifted_labels": labels, "wavs": wavs}

    def loss_and_grads(cfg, params, device):
        trainable, frozen = split_params(params)
        trainable = tree_map(lambda t: t.detach().clone().requires_grad_(), trainable)
        loss = salmonn_train_loss(cfg, merge_params(frozen, trainable),
                                  {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
        named = _paths(trainable)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.item(), {n: g.float().cpu() for n, g in zip(named, grads)}

    before = kernels.launch_counts()
    got_loss, got = loss_and_grads(cfg, params, dev)
    after = kernels.launch_counts()
    for name in ("flash_attention_causal", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if after[name] - before[name] != 1:
            raise AssertionError(f"{name}: {after[name] - before[name]} launches, expected 1")
    cpu_params = _tree_to(params, torch.device("cpu"), torch.float32)
    want_loss, want = loss_and_grads(dataclasses.replace(cfg, compute_dtype=torch.float32),
                                     cpu_params, torch.device("cpu"))
    rel = abs(got_loss - want_loss) / abs(want_loss)
    print(f"  train loss: card {got_loss:.6f} vs f32 CPU {want_loss:.6f}, relative error "
          f"{rel:.3e} (bound 1e-2)", flush=True)
    if not (np.isfinite(got_loss) and rel <= 1e-2):
        raise AssertionError(f"train loss check failed: {got_loss} vs {want_loss}")
    groups = {"lora.*.a": lambda n: n.startswith("lora.") and n.endswith(".a"),
              "lora.*.b": lambda n: n.startswith("lora.") and n.endswith(".b"),
              "qformer": lambda n: n.startswith("qformer.")}
    for gname, member in groups.items():
        names = [n for n in want if member(n)]
        g = torch.cat([got[n].flatten() for n in names]).double()
        w = torch.cat([want[n].flatten() for n in names]).double()
        rel = ((g - w).norm() / w.norm()).item()
        cos = (g @ w / (g.norm() * w.norm())).item()
        print(f"  grad {gname} ({len(names)} leaves, |g| {w.norm().item():.4e}): relative "
              f"error {rel:.3e} (bound 5e-2), cosine {cos:.6f} (bound 0.99)", flush=True)
        if not (w.norm() > 0 and rel <= 5e-2 and cos >= 0.99):
            raise AssertionError(f"train gradient check failed for {gname}")
    del params, cpu_params
    torch.cuda.empty_cache()


def _tree_to(tree, device, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def _checked_run(label, run, n_requests, need, max_new=10):
    """One inference run at full width on the card: ``run()`` → the paths of
    its results and metrics JSON. Launch counts are set to 0 just before the
    run and read just after; returns (counts, paths)."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels

    print(f"  {label}:", flush=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    paths = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    with open(paths["results"]) as f:
        results = json.load(f)["results"]
    with open(paths["metrics"]) as f:
        metrics = json.load(f)
    if len(results) != n_requests:
        raise AssertionError(f"expected {n_requests} results, got {len(results)}")
    for r in results:
        toks = r["tokens"]
        if len(toks) != max_new or not all(0 <= t < 32000 for t in toks):
            raise AssertionError(f"bad generated tokens {toks}")
    if metrics.get("voxceleb", {}).get("total_samples") != n_requests:
        raise AssertionError(f"metrics of {n_requests} voxceleb results expected in "
                             f"{paths['metrics']}")
    scalars = {k: v for k, v in metrics["voxceleb"].items() if not isinstance(v, (dict, list))}
    print(f"    voxceleb metrics: {scalars}", flush=True)
    for name, n in need.items():
        print(f"    launches {name}: {counts[name]} (need >= {n})", flush=True)
        if counts[name] < n:
            raise AssertionError(f"{name} launched {counts[name]} < {n} times")
    perf = metrics["perf"]
    steps = perf["decode_step_ms"]
    print(f"    {n_requests} requests in {wall:.3f} s wall (model build included); serving "
          f"{perf['examples_per_sec']:.4f} utt/s, p50 batch {perf['p50_batch_seconds']:.4f} s, "
          f"batches {[round(x, 4) for x in perf['batch_seconds']]}; prefill ms "
          f"{[round(x, 2) for x in perf['prefill_ms']]}; decode step ms median "
          f"{statistics.median(steps):.3f} (min {min(steps):.3f}, max {max(steps):.3f}); "
          f"generation peak memory {perf['peak_memory_bytes'] / 2**30:.3f} GiB", flush=True)
    print(f"    predictions: {[r['predicted_label'] for r in results]}", flush=True)
    torch.cuda.empty_cache()
    return counts, paths


def _main_run(out_dir, model_type, extra, n_requests, need, max_new=10,
              run_name="chip_smoke"):
    """cli/inference.py at full width on the card; returns the run's kernel
    launch counts and the paths of its results and metrics JSON."""
    from icl_speech_text_llm_tpu_torch.cli import inference

    argv = ["--model_type", model_type, "--dataset_type", "voxceleb", "--synthetic",
            "--input_mode", "speech_only", "--fewshot_mode", "speech",
            "--num_examples", "5", "--batch_size", "4", "--max_samples", str(n_requests),
            "--seq_len", "1024", "--text_len", "448", "--max_new_tokens", str(max_new),
            "--device", "cuda", "--results_dir", out_dir, "--run_name", run_name, *extra]
    return _checked_run(f"{model_type} {' '.join(extra) or 'bf16'}",
                        lambda: inference.main(argv), n_requests, need, max_new)


def _api_run(out_dir, model_type, gen_kw, beats_kw, bits, n_requests, need, max_new=10):
    """The library entry points a user calls for what the CLI has no flag
    for: ``create_model(generation=GenerationConfig(**gen_kw))``, the BEATs
    options ``beats_kw`` set on the model's config, ``quantize_decoder`` when
    ``bits``, then ``run_inference`` + ``save_final_results`` on voxceleb
    requests as the CLI builds them; returns the run's launch counts and
    paths."""
    from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
    from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
    from icl_speech_text_llm_tpu_torch.inference.engine import GenerationConfig
    from icl_speech_text_llm_tpu_torch.inference.runner import (
        InferenceSettings,
        run_inference,
        save_final_results,
    )
    from icl_speech_text_llm_tpu_torch.models.factory import create_model
    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_decoder
    from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    def run():
        tok = get_tokenizer()
        gen = GenerationConfig(max_new_tokens=max_new, eos_token_id=tok.eos_token_id,
                               pad_token_id=tok.pad_token_id, **gen_kw)
        model = create_model(model_type, seed=42, generation=gen, device="cuda")
        if bits:
            quantize_decoder(model.params["llm"], bits=bits)
        cfg = dataclasses.replace(model.cfg, beats=dataclasses.replace(model.cfg.beats,
                                                                       **beats_kw))
        model.cfg = model.engine.cfg = cfg
        pack_cfg = PackConfig(seq_len=1024, text_len=448, max_slots=6,
                              audio_tokens_per_slot=cfg.audio_tokens_per_slot)
        dataset = create_dataset(
            DatasetType.VOXCELEB, split=DatasetSplit.TEST, input_mode="speech_only",
            fewshot_mode="speech", num_examples=5, is_training=False, max_samples=n_requests,
            synthetic=True, synthetic_size=32, seed=42, prompt_style="salmonn")
        settings = InferenceSettings(
            batch_size=4, max_new_tokens=max_new, results_dir=out_dir, run_name="chip_smoke",
            input_mode="speech_only", fewshot_mode="speech", num_examples=5,
            max_samples=n_requests)
        payload = run_inference(model.engine, dataset, pack_cfg, settings)
        return save_final_results(payload, [DatasetType.VOXCELEB], settings)

    label = f"{model_type} {gen_kw} BEATs {beats_kw}" + (f" int{bits}" if bits else "")
    return _checked_run(label, run, n_requests, need, max_new)


def _beats_batched_run():
    """The batched schedule of the BEATs attention (K8) has no model route,
    in the JAX package neither: its entry point is
    ``gated_bias_attention(..., batch_block=True)``. It runs here on every
    layer of the salmonn BEATs encoder (iter3-as2m, bf16, random weights
    from seed 42) over a main-path batch, 24 clips (4 requests × 6) of 5 s
    of noise padded to 30 s: (24, 12, 1496, 64) a layer. Each layer's input
    is the default encoder's; K8's output is held against the default
    schedule's (K3) on the same inputs, row by row (``_row_case``; one
    function in the same f32 arithmetic). Launch counts are set to 0 just
    before and read just after; returns them."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.models import beats
    from icl_speech_text_llm_tpu_torch.models.common import layer_at, linear
    from icl_speech_text_llm_tpu_torch.ops.flash_attention import gated_bias_attention

    dev = torch.device("cuda")
    cfg = beats.BEATS_CONFIGS["iter3-as2m"]
    H, hd = cfg.n_heads, cfg.head_dim
    print("  BEATs iter3-as2m, 24 clips, each layer's attention through "
          "gated_bias_attention(batch_block=True):", flush=True)
    kernels.reset_launch_counts()
    params = beats.init_beats(cfg, torch.Generator(device=dev).manual_seed(42), dev,
                              torch.bfloat16)
    wav = torch.zeros((24, 30 * 16000), device=dev)
    wav[:, :5 * 16000] = torch.from_numpy(
        np.random.RandomState(42).randn(24, 5 * 16000).astype(np.float32) * 0.1)
    table = beats.beats_bias_table(cfg, params, beats.beats_num_tokens(cfg, wav.shape[1]))
    bias = table.to(torch.bfloat16)
    with torch.inference_mode():
        x = beats.beats_encode(dataclasses.replace(cfg, n_layers=0), params, wav,
                               dtype=torch.bfloat16, bias_table=table)
        B, T, d = x.shape
        worst = []
        for l in range(cfg.n_layers):
            layer = layer_at(params["layers"], l)
            a = layer["attn"]
            q, k, v = (linear(x, a[w], a[b_]).view(B, T, H, hd).transpose(1, 2)
                       for w, b_ in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
            xh = x.view(B, T, H, hd).transpose(1, 2)
            gate = (a["grep_w"], a["grep_b"], a["grep_a"])
            got = gated_bias_attention(q, k, v, xh, bias, *gate, batch_block=True)
            ref = gated_bias_attention(q, k, v, xh, bias, *gate)
            _, ratio, tol, err = _row_case("K8 vs K3", got, ref)
            if not (torch.isfinite(got).all() and ratio <= tol):
                raise AssertionError(f"BEATs layer {l}: K8 vs K3 row error {ratio} > {tol}")
            worst.append(err)
            x = beats._layer_forward(cfg, layer, x, bias)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"    (24, {T}, {d}): K8 vs K3 max_abs_err per layer {[f'{e:.2e}' for e in worst]}; "
          f"launches gated_bias_attention_batched: {counts['gated_bias_attention_batched']} "
          f"(need >= {cfg.n_layers})", flush=True)
    if counts["gated_bias_attention_batched"] < cfg.n_layers:
        raise AssertionError(f"the BEATs-layer run did not run K8: {counts}")
    del params, x, table, bias
    torch.cuda.empty_cache()
    return counts


def _probe_run():
    """K11's path: the port's probe entry point, ops.probes.stream_rate, on
    the two buffers of the JAX probes (random bf16 from seed 5). Launch
    counts are set to 0 just before and read just after; returns them."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.ops import probes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    print("  streaming probe through ops.probes.stream_rate:", flush=True)
    kernels.reset_launch_counts()
    for label, shape in (("(73728, 512)", (73728, 512)),
                         ("7B cache layer k + v (2, 4, 32, 1152, 128)", (2, 4, 32, 1152, 128))):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        rate = probes.stream_rate(x)
        print(f"    {label}, {x.numel() * 2 / 1e6:.1f} MB: {rate:.1f} GB/s "
              f"({100 * rate / 3350:.1f}% of the data sheet's 3350 GB/s)", flush=True)
        if not 0 < rate < 1e5:
            raise AssertionError(f"stream_rate gave {rate} GB/s")
        del x
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"    launches stream_read: {counts['stream_read']} (need >= 42)", flush=True)
    if counts["stream_read"] < 42:
        raise AssertionError(f"the probe run did not run K11: {counts}")
    torch.cuda.empty_cache()
    return counts


#: the reference's serving layout through the CLI, and the least launches
#: of its 8-request run (2 batches of 9 decode steps)
QUANT_13B_FLAGS = ["--quantize_int4", "--kv_int8"]
QUANT_13B_NEED = {"int4_matmul": 7 * 40 * 9 * 2, "int8_matmul": 10 * 2, "append_kv_q8": 9 * 2,
                  "flash_attention_causal": 40 * 2, "flash_attention_noncausal": 32 * 2,
                  "gated_bias_attention": 12 * 2}


def _main_phase(out_dir):
    """The inference main paths → ({kernel: launches of the run of its path},
    (launch counts, paths) of the 13B int4 + int8 KV CLI run): 7B bf16, 13B
    int4 weights + int8 KV cache, 7B int8 weights, 7B beams through the CLI;
    7B with the flash-decode kernel and BEATs' row schedule, 13B int4 + int8
    KV with the flash-decode kernel and sampled beams through the library;
    BEATs' batched schedule through its op; the streaming probe through its
    entry point."""
    _main_run(os.path.join(out_dir, "7b"), "salmonn-7b", [], 8, {
        "flash_attention_noncausal": 32 * 2, "gated_bias_attention": 12 * 2,
        "flash_attention_causal": 32 * 2, "append_kv": 9 * 2})
    quant, quant_paths = _main_run(os.path.join(out_dir, "13b_int4"), "salmonn-13b",
                                   QUANT_13B_FLAGS, 8, QUANT_13B_NEED)
    _main_run(os.path.join(out_dir, "7b_int8"), "salmonn-7b", ["--quantize_int8"], 4, {
        "int8_matmul": 7 * 32 * 9, "append_kv": 9, "flash_attention_causal": 32})
    # (a) beam search, the repetition penalty and min_new_tokens through the
    # CLI (4 beams: 16 cache rows, reordered every step)
    _main_run(os.path.join(out_dir, "7b_beams"), "salmonn-7b",
              ["--num_beams", "4", "--repetition_penalty", "1.2", "--min_new_tokens", "2"], 4, {
                  "flash_attention_causal": 32, "flash_attention_noncausal": 32,
                  "gated_bias_attention": 12, "append_kv": 9})
    # (b) the flash-decode kernel (K7 ×32 a step) and BEATs' row schedule (K9
    # ×12 a batch)
    flash, _ = _api_run(os.path.join(out_dir, "7b_flash"), "salmonn-7b",
                        {"use_flash_decode": True}, {"lean_bias_flash": True}, None, 4, {
                            "flash_decode_attention": 32 * 9, "gated_bias_attention_rows": 12,
                            "flash_attention_causal": 32, "append_kv": 9})
    if flash["gated_bias_attention"] or flash["flash_decode_attention_q8"]:
        raise AssertionError(f"the 7B flash run took another route: {flash}")
    # (c) K7 on the int8 cache over 16 rows (4 sampled beams)
    flash_q8, _ = _api_run(os.path.join(out_dir, "13b_flash_q8"), "salmonn-13b",
                           {"use_flash_decode": True, "kv_int8": True, "num_beams": 4,
                            "do_sample": True}, {}, 4, 4, {
                               "flash_decode_attention_q8": 40 * 9,
                               "int4_matmul": 7 * 40 * 9, "append_kv_q8": 9})
    if quant["append_kv"] or flash_q8["append_kv"]:
        raise AssertionError("an int8-cache run launched the bf16 append (K4): "
                             f"{quant['append_kv']}, {flash_q8['append_kv']}")
    # (d) BEATs' batched schedule (K8 ×12, one a layer)
    batched = _beats_batched_run()
    # (e) the streaming probe (K11)
    probe = _probe_run()
    return {"int4_matmul": quant["int4_matmul"], "int8_matmul": quant["int8_matmul"],
            "append_kv_q8": quant["append_kv_q8"],
            "flash_decode_attention": flash["flash_decode_attention"],
            "gated_bias_attention_rows": flash["gated_bias_attention_rows"],
            "flash_decode_attention_q8": flash_q8["flash_decode_attention_q8"],
            "gated_bias_attention_batched": batched["gated_bias_attention_batched"],
            "stream_read": probe["stream_read"]}, (quant, quant_paths)


#: free disk the load phase needs under the repository: ~1.9 GB of fp16 HF
#: shards and a ~1.1 GB dir (13B widths, 2 layers), the ~7.5 GB int4 dir of
#: the full 13B decoder, with room to spare
LOAD_DISK_BYTES = 16 << 30
#: the least bound of the converted-dir CLI run's model build (the in-memory
#: build passes through 26 GB of bf16 decoder weights)
LOAD_PEAK_BYTES = 16 << 30


def _leaves_identical(label, got, want):
    """Two {tree path: array or tensor} maps: the same paths, and every leaf
    of the same dtype, shape and bits (compared on the card)."""
    import numpy as np
    import torch

    if set(got) != set(want):
        raise AssertionError(f"{label}: paths differ: {sorted(set(got) ^ set(want))}")
    for k in want:
        g, w = (torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
                for x in (got[k], want[k]))
        if g.dtype != w.dtype or not torch.equal(g.cuda(), w.cuda()):
            raise AssertionError(f"{label}: leaf {k} differs ({g.dtype} vs {w.dtype})")


def _convert_check(out_dir):
    """(a) The converters at full 13B width: HF shards of vicuna-13b's widths
    cut to 2 layers, written by ``write_hf_decoder_shards`` and converted by
    ``cli.convert --quantize_int4`` on the host, hold the bytes that
    ``quantize_decoder(bits=4)`` gives on the card over the same weights read
    back by ``TensorSource``; then a full-width ``salmonn_v1.pth`` (40 LoRA
    layers, the 13B Q-Former) through ``cli.convert --component salmonn``."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.cli import convert
    from icl_speech_text_llm_tpu_torch.models import llama
    from icl_speech_text_llm_tpu_torch.models.convert import (
        convert_hf_decoder,
        convert_salmonn_checkpoint,
        load_torch_state_dict,
    )
    from icl_speech_text_llm_tpu_torch.models.factory import _check_tree_shapes
    from icl_speech_text_llm_tpu_torch.models.qformer import init_qformer
    from icl_speech_text_llm_tpu_torch.models.salmonn import salmonn_13b
    from icl_speech_text_llm_tpu_torch.models.stream_convert import (
        TensorSource,
        flatten_tree,
        load_params_dir,
    )
    from icl_speech_text_llm_tpu_torch.models.synth_ckpt import (
        write_hf_decoder_shards,
        write_salmonn_v1,
    )
    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_decoder

    cut = dataclasses.replace(llama.DECODER_CONFIGS["vicuna-13b"], n_layers=2)
    hf, dst = os.path.join(out_dir, "hf_13b_2_layers"), os.path.join(out_dir, "int4_13b_2_layers")
    t0 = time.perf_counter()
    nbytes = write_hf_decoder_shards(hf, cut, seed=42)
    t_write = time.perf_counter() - t0
    llama.DECODER_CONFIGS["vicuna-13b-2-layers"] = cut
    t0 = time.perf_counter()
    convert.main(["--src", hf, "--dst", dst, "--model_type", "vicuna-13b-2-layers",
                  "--quantize_int4"])
    t_convert = time.perf_counter() - t0
    del llama.DECODER_CONFIGS["vicuna-13b-2-layers"]
    src = TensorSource(hf)
    ref = params_from_numpy(convert_hf_decoder({k: src.get(k) for k in src.keys()}, cut),
                            "cuda", torch.float32)
    quantize_decoder(ref, bits=4)
    got = flatten_tree(load_params_dir(dst))
    _leaves_identical("2-layer int4 dir vs quantize_decoder on the card", got, flatten_tree(ref))
    for k in ("layers/attn/wq/q4", "layers/mlp/w_down/q4", "lm_head/q"):
        if k not in got:
            raise AssertionError(f"the int4 dir has no {k}")
    print(f"  (a) vicuna-13b widths (dim 5120, hidden 13824, 40 heads, vocab 32000) cut to "
          f"2 layers: write_hf_decoder_shards {nbytes / 1e9:.3f} GB fp16 in {t_write:.2f} s, "
          f"cli.convert --quantize_int4 in {t_convert:.2f} s (host); {len(got)} leaves "
          f"byte-identical to quantize_decoder(bits=4) on the card over TensorSource's "
          f"weights", flush=True)
    del ref, src
    shutil.rmtree(hf)
    shutil.rmtree(dst)
    torch.cuda.empty_cache()

    cfg = salmonn_13b()
    pth, adapter = os.path.join(out_dir, "salmonn_v1.pth"), os.path.join(out_dir, "adapter_13b")
    n = write_salmonn_v1(pth, cfg.qformer, cfg.llm, whisper_dim=cfg.whisper.dim,
                         beats_dim=cfg.beats.dim, rank=cfg.lora.rank)
    t0 = time.perf_counter()
    convert.main(["--src", pth, "--dst", adapter, "--component", "salmonn",
                  "--model_type", "vicuna-13b"])
    t_adapter = time.perf_counter() - t0
    tree = load_params_dir(adapter)
    want = convert_salmonn_checkpoint(load_torch_state_dict(pth), cfg.qformer, cfg.llm)
    _leaves_identical("13B adapter dir vs convert_salmonn_checkpoint", flatten_tree(tree),
                      {k: np.asarray(v) for k, v in flatten_tree(want).items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for sub, init in (("qformer", init_qformer(cfg.qformer, gen, "cuda", torch.bfloat16)),
                      ("lora", llama.init_lora(cfg.llm, cfg.lora, gen, "cuda", torch.bfloat16))):
        if set(flatten_tree(init)) != set(flatten_tree(tree[sub])):
            raise AssertionError(f"the 13B adapter's {sub} paths differ from the preset's")
        _check_tree_shapes(sub, init, tree[sub])
    print(f"  (a) salmonn_v1.pth at 13B widths ({n} tensors, {cfg.llm.n_layers} LoRA layers) "
          f"through "
          f"cli.convert --component salmonn in {t_adapter:.2f} s: "
          f"{len(flatten_tree(tree))} leaves, equal to convert_salmonn_checkpoint, the "
          f"salmonn-13b preset's paths and shapes (LoRA wq a "
          f"{tuple(tree['lora']['wq']['a'].shape)})", flush=True)


def _load_run(out_dir, quant_run):
    """(b) The 13B int4 + int8 KV CLI run of phase main, with the decoder read
    from a converted dir: the in-memory model's int4 decoder written by
    ``_DirWriter``, then ``cli/inference.py --llm_params_dir`` with every
    other argument as phase main's. The same launches and predictions are
    required, and a model build under ``LOAD_PEAK_BYTES``. (c) The same CLI
    asking for int8 over the int4 dir exits; ``cli.reprocess`` of (b)'s
    results gives (b)'s metrics."""
    import gc

    import torch

    from icl_speech_text_llm_tpu_torch.cli import inference, reprocess
    from icl_speech_text_llm_tpu_torch.evaluation import to_json_compatible
    from icl_speech_text_llm_tpu_torch.models.factory import create_model
    from icl_speech_text_llm_tpu_torch.models.stream_convert import _DirWriter, flatten_tree
    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_decoder

    counts13, paths13 = quant_run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = create_model("salmonn-13b", seed=42, device="cuda")
    quantize_decoder(model.params["llm"], bits=4)
    torch.cuda.synchronize()
    mem_build_s, mem_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    dst = os.path.join(out_dir, "int4_13b")
    t0 = time.perf_counter()
    writer = _DirWriter(dst)
    for path, leaf in flatten_tree(model.params["llm"]).items():
        leaf = leaf.float() if leaf.dtype == torch.bfloat16 else leaf
        writer.put(path, leaf.cpu().numpy())
    writer.close()
    t_dir = time.perf_counter() - t0
    dir_bytes = sum(os.path.getsize(os.path.join(dst, f)) for f in os.listdir(dst))
    print(f"  (b) in-memory salmonn-13b build + quantize_decoder(bits=4): {mem_build_s:.2f} s, "
          f"peak {mem_peak / 2**30:.3f} GiB; its decoder written by _DirWriter: "
          f"{dir_bytes / 1e9:.3f} GB in {t_dir:.2f} s", flush=True)
    del model, leaf
    gc.collect()
    torch.cuda.empty_cache()

    build = {}
    create = inference.create_model

    def measured_create_model(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = create(*args, **kwargs)
        torch.cuda.synchronize()
        build.update(seconds=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated())
        return out

    inference.create_model = measured_create_model
    counts, paths = _main_run(os.path.join(out_dir, "13b_int4_dir"), "salmonn-13b",
                              [*QUANT_13B_FLAGS, "--llm_params_dir", dst], 8, QUANT_13B_NEED,
                              run_name="chip_smoke_load")
    inference.create_model = create
    print(f"  (b) converted-dir model build (create_model(llm_params_dir=)): "
          f"{build['seconds']:.2f} s host, peak {build['peak'] / 2**30:.3f} GiB "
          f"(in-memory build {mem_peak / 2**30:.3f} GiB)", flush=True)
    if build["peak"] >= LOAD_PEAK_BYTES:
        raise AssertionError(f"converted-dir build peak {build['peak']} >= {LOAD_PEAK_BYTES}")
    if counts != counts13:
        raise AssertionError(f"launches differ from phase main's 13B int4 run: "
                             f"{ {k: (counts[k], counts13[k]) for k in counts if counts[k] != counts13[k]} }")

    def results(p):
        with open(p["results"]) as f:
            return [(r["predicted_label"], r["tokens"]) for r in json.load(f)["results"]]

    if results(paths) != results(paths13):
        raise AssertionError("predictions differ from phase main's 13B int4 run")
    print(f"  (b) launches and the 8 predictions and tokens identical to phase main's 13B "
          f"int4 + int8 KV run", flush=True)

    argv = ["--model_type", "salmonn-13b", "--dataset_type", "voxceleb", "--synthetic",
            "--device", "cuda", "--results_dir", os.path.join(out_dir, "13b_int8_ask"),
            "--kv_int8", "--quantize_int8", "--llm_params_dir", dst]
    try:
        inference.main(argv)
    except SystemExit as e:
        if "already int4-quantized" not in str(e):
            raise
        print(f"  (c) --quantize_int8 over the int4 dir exits: {e}", flush=True)
    else:
        raise AssertionError("--quantize_int8 over an int4 dir did not exit")
    torch.cuda.empty_cache()
    rescored = reprocess.main(["--results", paths["results"], "--dataset_type", "voxceleb"])
    with open(paths["metrics"]) as f:
        written = json.load(f)["voxceleb"]
    if json.loads(json.dumps(to_json_compatible(rescored))) != written:
        raise AssertionError("cli.reprocess's metrics differ from the run's metrics file")
    print("  (c) cli.reprocess of (b)'s results: the metrics dict of (b)'s metrics file",
          flush=True)
    shutil.rmtree(dst)


def _encode_chunk_run():
    """(d) salmonn-7b's encoders over the main path's 24 clips (4 requests of
    6) with ``encode_chunk=6`` and without chunks: the outputs within the
    phase check's bound (5% of the largest |output|), and each one's peak
    memory."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.models.salmonn import (
        encode_speech,
        init_salmonn,
        salmonn_7b,
    )
    from icl_speech_text_llm_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim

    cfg = salmonn_7b()
    gen = torch.Generator(device="cuda").manual_seed(42)
    params = init_salmonn(cfg, gen, "cuda", torch.bfloat16, skip_llm=True)
    wavs = np.random.RandomState(42).randn(24, 5 * 16000).astype(np.float32) * 0.1
    flat = pad_or_trim(torch.from_numpy(wavs).cuda())
    mels = log_mel_spectrogram(flat)
    out = {}
    for c in (6, 0):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = encode_speech(dataclasses.replace(cfg, encode_chunk=c), params, mels, flat)
        torch.cuda.synchronize()
        out[c] = (y, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base)
    (y6, s6, p6), (y0, s0, p0) = out[6], out[0]
    err = (y6.float() - y0.float()).abs().max().item()
    tol = 5e-2 * y0.float().abs().max().item()
    if y6.shape != y0.shape or not torch.isfinite(y6.float()).all() or err > tol:
        raise AssertionError(f"encode_chunk=6 vs none: {tuple(y6.shape)}, max_abs_err {err} "
                             f"> {tol}")
    print(f"  (d) salmonn-7b encoders, 24 clips -> {tuple(y6.shape)}: encode_chunk=6 vs none "
          f"max_abs_err {err:.4e} (tolerance {tol:.4e} = 5% of max |output|); peak memory "
          f"above the weights {p6 / 2**30:.3f} GiB chunked, {p0 / 2**30:.3f} GiB unchunked; "
          f"{s6:.3f} s and {s0:.3f} s", flush=True)
    del params, out, y6, y0
    torch.cuda.empty_cache()


def _load_phase(out_dir, quant_run):
    """Converted weights on the card: (a) the converters at full 13B width,
    (b) phase main's 13B int4 + int8 KV CLI run from a converted dir, (c) the
    width check and the reprocess CLI, (d) ``encode_chunk``."""
    free = shutil.disk_usage(out_dir).free
    print(f"  free disk under the repository: {free / 2**30:.1f} GiB (need "
          f"{LOAD_DISK_BYTES / 2**30:.0f})", flush=True)
    if free < LOAD_DISK_BYTES:
        raise AssertionError(f"{free} bytes free < {LOAD_DISK_BYTES}")
    _convert_check(out_dir)
    _load_run(out_dir, quant_run)
    _encode_chunk_run()


def _train_run(out_dir, n_steps, extra, k1_per_step):
    """cli/train.py at salmonn-7b, full width, on the card; returns (result,
    launch counts of the run)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import train

    argv = ["--model_type", "salmonn-7b", "--dataset_type", "voxceleb", "--synthetic",
            "--fewshot_mode", "speech", "--num_examples", "5", "--batch_size", "4",
            "--max_samples", str(4 * n_steps), "--synthetic_size", "16", "--num_epochs", "1",
            "--seq_len", "1024", "--text_len", "448", "--val_max_samples", "4",
            "--warmup_steps", "0", "--device", "cuda", "--output_dir", out_dir, *extra]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    perf = result.perf
    print(f"  {' '.join(extra) or 'no remat'}: {perf['steps']} steps, losses "
          f"{[round(x, 4) for x in result.losses]}, skipped batches {result.skipped_batches}",
          flush=True)
    if perf["steps"] != n_steps or result.state.step != n_steps:
        raise AssertionError(f"expected {n_steps} steps, ran {perf['steps']}")
    if result.skipped_batches or not all(np.isfinite(result.losses)):
        raise AssertionError("a training batch was skipped or a loss is not finite")
    need = {"flash_attention_causal": k1_per_step, "flash_attention_bwd_dq": 32,
            "flash_attention_bwd_dkv": 32, "flash_attention_noncausal": 32,
            "gated_bias_attention": 12}
    for i, per in enumerate(perf["launches_per_step"]):
        print(f"  step {i}: {perf['step_seconds'][i]:.4f} s, launches "
              f"{ {k: per[k] for k in need} }", flush=True)
        for name, n in need.items():
            if per[name] < n:
                raise AssertionError(f"step {i}: {name} launched {per[name]} < {n} times")
    print(f"  median step {statistics.median(perf['step_seconds']):.4f} s, "
          f"{perf['examples_per_sec']:.4f} examples/s over the steps, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"run wall {wall:.3f} s (model build and validation included)", flush=True)
    return result, counts


def _train_phase(out_dir):
    """The training main path: 4 optimizer steps, then 2 with full remat."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.models.factory import create_model
    from icl_speech_text_llm_tpu_torch.training.checkpoint import copy_into, load_checkpoint

    result, counts = _train_run(os.path.join(out_dir, "plain"), 4, [], 32)
    # trainable weights moved and frozen ones did not: against the same seed's init
    fresh = create_model("salmonn-7b", seed=42, device="cuda", trainable_dtype=torch.float32)
    trained = _paths(result.state.trainable)
    init = _paths({k: fresh.params[k] for k in ("lora", "qformer")})
    unchanged = [n for n in trained if torch.equal(trained[n].detach(), init[n])]
    print(f"  trainable leaves changed: {len(trained) - len(unchanged)} of {len(trained)}; "
          f"unchanged {unchanged}", flush=True)
    if any(n.startswith("lora.") for n in unchanged) or \
            len([n for n in unchanged if n.startswith("qformer.")]) > len(trained) // 4:
        raise AssertionError("training left trainable weights unchanged")
    for name in ("llm.layers.attn.wq", "llm.lm_head", "whisper.blocks.mlp.w1",
                 "beats.layers.attn.wq"):
        live = _paths(result.model.params).get(name)
        if live is None or not torch.equal(live, _paths(fresh.params)[name]):
            raise AssertionError(f"frozen leaf {name} changed or missing")
    print("  frozen leaves bit-identical to the seed's init", flush=True)
    ck = load_checkpoint(result.checkpoints[0])
    copy_into({k: fresh.params[k] for k in ("lora", "qformer")}, ck["trainable"])
    for n, t in _paths({k: fresh.params[k] for k in ("lora", "qformer")}).items():
        if not (torch.equal(t, trained[n].detach()) and
                np.array_equal(_paths(ck["trainable"])[n], trained[n].detach().cpu().numpy())):
            raise AssertionError(f"checkpoint leaf {n} differs after reload")
    print(f"  checkpoint {os.path.basename(result.checkpoints[0])} reloads: "
          f"{len(trained)} leaves identical, step {ck['step']}", flush=True)
    del result, fresh, trained, init, ck
    torch.cuda.empty_cache()
    _train_run(os.path.join(out_dir, "remat"), 2, ["--gradient_checkpointing"], 64)
    torch.cuda.empty_cache()
    return counts


def main():
    smi = _device_phase()
    import torch

    from icl_speech_text_llm_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase build:", flush=True)
    t0 = time.perf_counter()
    kernels.lib()
    print(f"  built {kernels.library_path()} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_seconds:.2f} s)", flush=True)
    _build_report(kernels.library_path(),
                  (kernels.library_path().parent / "build.log").read_text())

    print("phase kernels:", flush=True)
    t0 = time.perf_counter()
    rows = _kernel_phase()
    print(f"  phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase check:", flush=True)
    t0 = time.perf_counter()
    _reference_phase()
    _train_check_phase()
    _quant_reference_phase()
    _step_launches()
    print(f"  phase check: {time.perf_counter() - t0:.1f} s", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    print("phase main:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        main_counts, quant_run = _main_phase(d)
        print(f"  phase main: {time.perf_counter() - t0:.1f} s", flush=True)
        print("phase load:", flush=True)
        t0 = time.perf_counter()
        _load_phase(d, quant_run)
        print(f"  phase load: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase train:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        counts = _train_phase(d)
    print(f"  phase train: {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        row["launches"] = main_counts.get(row["name"], counts[row["name"]])
        if "beam" in row:
            ms, bound = row["beam"]
            print(f"{row['name']} at the 16-row shape of its main-path run: {row['launches']} "
                  f"launches × (ms − bound) = {row['launches']} × ({ms:.4f} − {bound:.4f}) = "
                  f"{row['launches'] * (ms - bound):.3f} ms", flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
