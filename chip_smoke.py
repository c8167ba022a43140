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
               and rows at phase qwen's shapes: K1 at (4, 28, 2048, 128)
               over 4 kv heads (n_rep 7) with its prompts' lengths, K2 over
               its 24 clips with each clip's frame count as the key length,
               K5 + K6 at K1's shape, K4 and K4 q8 into its (28, 4, 4,
               2176, 128) cache, K7 q8 over it, K10 and K12 at its decode
               products and K12 at its 3584 × 156032 lm_head. The attention
               bounds count the query rows below each length and the keys
               below it (the rows past a length are padding no consumer
               reads), the bound over every query row printed beside;
  4. check   — one-layer-per-stack models, the bf16 kernel path on the card
               against the f32 plain path on the CPU with the same weights and
               inputs: at salmonn-7b widths the first-token logits and 3
               decode steps' logits through the flash-decode kernel, then the
               training loss and the LoRA / Q-Former gradients, then the symbol
               adapter's loss (soft quantization at T = 0.1 over the 32000-row
               vocabulary) on two MELD-emotion requests whose labels are a
               seeded SymbolManager's symbols, its LoRA and input_mlp
               gradients (5e-2 × max |plain gradient| besides the L2 and cosine
               bounds) and the hard ids wherever the top-two similarity gap
               is resolved; at salmonn-13b
               widths with int4 weights and an int8 KV cache the first-token
               logits and 3 decode steps' logits, with the default decode
               attention and with the flash-decode kernel, each step's one
               append through K4 q8; at qwen2-audio-7b widths (128-mel
               tower, Qwen2-7B: qkv biases, n_rep 7) the first-token
               logits, 3 decode steps through K7 and the train loss and
               LoRA gradients; then the kernels one full-depth decode
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
  7. serve   — the port's serving CLI (inference/serving.py, the slot pool) at
               full width on phase main's voxceleb requests, each run's launch
               counts read from that run alone: (1) salmonn-7b bf16, 8
               requests, 4 slots, waves of 4, blocks of 4 steps, bucket 1024:
               K2, K3, K1 in admission and K4 each step (no K4 q8), every
               first token equal to phase main's 7B bf16 run's (the same
               encoder batches and K1 shapes), the full sequences that agree
               and where the others first diverge (5 pool rows decode against
               4), and the synchronizing CUDA calls of each decode block
               (torch.cuda.set_sync_debug_mode, information only);
               (2) salmonn-13b --quantize_int4 --kv_int8 --shared_prefix
               (prefix bucket 1024, K1 × 40 once) with suffixes in bucket 256
               admitted in chunks of 128, 8 slots: K10, K12 and K4 q8 every
               decode step, no K4; the prefix length, waves, pool bytes and
               peak memory; (3) salmonn-7b --lora_bank of two checkpoints
               written by save_checkpoint (the seed's LoRA and a second draw):
               K1 and K4 with per-request adapters, the requests of adapter 0
               served run 1's tokens; (4) salmonn-7b --num_beams 4, 4 requests
               (the beam lane);
  8. train   — the port's training CLI on salmonn-7b at full width: 4 optimizer
               steps (batch 4, seq 1024), validation by generation and a
               checkpoint, with each step's kernel launches read; then 2 steps
               with full activation checkpointing;
  9. qwen    — Qwen2-Audio-7B at full width on the same requests in Qwen's
               chat format (each clip splicing its audio_output_length
               positions, prompts packed to 2048): the inference CLI bf16
               (8) and --quantize_int8 --kv_int8 (4), create_model +
               run_inference with int4 weights, an int8 KV cache and
               use_flash_decode=True (4), the serving CLI (8; first tokens
               equal to the bf16 CLI run's), and the train CLI (2 steps,
               then 2 with full remat), each run's launch counts read from
               that run alone (``_qwen_phase``);
 10. symbol  — BASELINE.md config 4 at salmonn-7b full width:
               cli/symbol_train.py --training_mode lora_mlp_joint on MELD
               emotion + SQA (8 samples each, batch 2; a LoRA step with the
               MLP bypassed, an MLP-only step whose gradient reaches the text
               embeddings through every layer's K6/K5, a joint step, each
               validated in three modes on 2 + 2 samples and checkpointed):
               every loss finite, the MLP adapter bit-identical through the
               LoRA step, LoRA through the MLP step, both changed by the
               joint step, each step's training launches (validation taken
               out) at least K2 ×32, K3 ×12, K1, K5, K6 ×32 a batch,
               each validation's K1 and K4 and no K5/K6, three checkpoints
               with the mappings; then cli/symbol_inference.py on the joint
               checkpoint: 4 predictions a mode, the no_mlp_symbols and
               no_mlp_original composites, and their MELD prediction rows
               (SQA draws new exemplars at each access), equal to the
               joint step's validation (the same weights, the restored
               mappings, greedy); no kernel's plain version called on the card in
               the phase. Prints s an optimizer step, examples/s, peak
               memory and the phase's seconds.
  11. util    — the last single-card entry points and data parallelism: (a)
               the inference CLI's --auto_batch search (utils/memory.py)
               over salmonn-7b's generation of phase main's request, each
               probed size's peak memory printed (every size up to 16 must
               fit), then again with the budget halfway between the peaks
               of 8 and 16 (it must pick the lower of the two sizes the
               budget falls between), then cli/inference.py --auto_batch
               --auto_batch_max 16 to the end at the pick; (b)
               cli/train.py --auto_batch --auto_batch_max 16 at salmonn-7b
               without remat: a probe runs out of memory and is caught, the
               search leaves the trainable leaves and moments bit-identical,
               the pick trains; (c) cli/train.py --mesh 1 under
               torch.distributed.run (one NCCL rank) with phase train's
               first run's arguments: the same losses, bit for bit; (d) two
               data-parallel ranks on the card over gloo at salmonn-7b's
               widths with one layer a stack (salmonn-tiny's head dims are
               not the kernels'), one request each with 5 and 1 label
               tokens: the step of the two equals one process's full-batch
               step within phase check's card bounds (loss 1e-2, gradients
               5e-2 × the group's max) while plain DDP averaging does not,
               the replicas stay bit-identical, a NaN on one rank skips the
               step on both, predictions gathered on both;
               (e) topk_similar (few-shot retrieval) on a 6000 × 512 hashed
               pool, k = 10: the CPU's indices, and its time; (f) one
               generation under utils/perf.py:torch_profile, whose trace
               must name K1's kernel. No kernel's plain version is called
               in (b) and (c).
  12. mesh    — FSDP, tensor, pipeline and sequence parallelism, ranks as
               processes sharing
               the card over gloo (``_dp_worker`` with a mesh, every
               collective staged through pinned host memory): (a) tp = 2
               static generation at salmonn-7b bf16 on phase main's
               requests, K7 on each rank's 16 heads: the logits that picked
               every token within 5% of max |logit| of one process
               teacher-forced on them, tokens by ``_gap_rule``; (b) the
               GENERIC decode in one process (K4 a layer; bf16 tokens
               against FLASH's, the int8 step bit-equal to its plain
               append); (c) tp = 2 serving at salmonn-13b's widths cut to
               8 layers, int8 pool (K4 q8, K7 q8), a prefix and 2 beams:
               half the pool a rank, tokens by ``_gap_rule``; (d) the train
               CLI at --mesh 1,1,2 and 1,2,1, phase train's first 2 steps:
               losses within 1e-3, the fsdp peak under phase train's; (e)
               four ranks at --mesh 1,2,2, 2 layers a stack: one step
               against one process's (``MESH_CARD_LIMITS``), collective
               calls against ``mesh_step_counts``; (f) pp = 2 at 7B
               widths, 4 layers, batch 4 at 1024 in 2 microbatches, 2
               steps: losses within 1e-3 of one process's, K1/K5/K6 on
               each stage its layers × microbatches × steps, half the
               layer bytes a stage; (g) sp = 2 at 7B widths, 2 layers,
               2048 positions: the ring's hidden within 2e-2 of K1's
               route, one step's loss within 1e-3 of one process's; (h)
               (c) with a 2-adapter LoRA bank whole on each rank. Each
               sub-phase prints its seconds. No plain version runs.
The line before the last is a JSON object of the fourteen kernels and the
Qwen-shape rows (launch counts from the run of each kernel's own path: the
salmonn-13b int4 run for the int4 and int8 matmuls and K4 q8, the
flash-decode runs of phase main for the flash-decode kernels and the K9
schedule, phase main's BEATs-layer run for the K8 schedule, its probe run
for K11, the train phase for the others; for a Qwen-shape row, the phase
qwen run that launches it at that shape),
after a line with K7 q8's launches × (ms − bound) at the 16-row shape; the
last
line is {"ok": true, "device": {...}} and is printed only when every phase
passed. Takes ~10 minutes on one H100.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
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


def _causal_pairs(lens):
    """(query row, key) pairs of a causal pass with key lengths that its
    result holds, per head: the rows below each sample's length, Σ n(n + 1)/2.
    The rows past a length (padding: no consumer reads them, the checks
    compare none) are work the kernels do, not work the function needs."""
    return sum(n * (n + 1) // 2 for n in lens)


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


#: (kernel, model, label, M, K, N, stacked copies) of the quantized matmuls:
#: the salmonn-13b int4 decode products (M = 4: w_gate/w_up, w_down,
#: wq/wk/wv/wo read as layer 17 of a stacked [40] weight) and an M = 256
#: prefill; K12 at the 13B lm_head and the 7B w_down; then qwen2-audio-7b's
#: decode products (runs (b) and (c) of phase qwen): w_gate/w_up, w_down,
#: wq/wo (layer 17 of a stacked [28]) and wk/wv, int4 and int8, and its
#: lm_head (3584 × 156032, int8 at either width: ``quantize_decoder`` keeps
#: the lm_head int8 under int4). Copies whose bytes exceed the 50 MB L2,
#: cycled, so that each timed call streams its weight from device memory.
#: Each model's first case of a kernel gives that kernel's row.
WQ_CASES = (
    ("int4_matmul", "salmonn", "13B w_gate M=4", 4, 5120, 13824, 4),
    ("int4_matmul", "salmonn", "13B w_down M=4", 4, 13824, 5120, 4),
    ("int4_matmul", "salmonn", "13B wq stacked [17] M=4", 4, 5120, 5120, 40),
    ("int4_matmul", "salmonn", "13B w_gate M=256", 256, 5120, 13824, 4),
    ("int8_matmul", "salmonn", "13B lm_head M=4", 4, 5120, 32000, 1),
    ("int8_matmul", "salmonn", "7B w_down M=4", 4, 11008, 4096, 4),
    ("int4_matmul", "qwen2-audio-7b", "Qwen w_gate M=4", 4, 3584, 18944, 4),
    ("int4_matmul", "qwen2-audio-7b", "Qwen w_down M=4", 4, 18944, 3584, 4),
    ("int4_matmul", "qwen2-audio-7b", "Qwen wq stacked [17] M=4", 4, 3584, 3584, 28),
    ("int4_matmul", "qwen2-audio-7b", "Qwen wk M=4", 4, 3584, 512, 64),
    ("int8_matmul", "qwen2-audio-7b", "Qwen w_gate M=4", 4, 3584, 18944, 2),
    ("int8_matmul", "qwen2-audio-7b", "Qwen w_down M=4", 4, 18944, 3584, 2),
    ("int8_matmul", "qwen2-audio-7b", "Qwen wq M=4", 4, 3584, 3584, 8),
    ("int8_matmul", "qwen2-audio-7b", "Qwen wk M=4", 4, 3584, 512, 32),
    ("int8_matmul", "qwen2-audio-7b", "Qwen lm_head M=4", 4, 3584, 156032, 1),
)

#: the phase qwen run whose launches a Qwen row reports: K12 in run (b)
#: (--quantize_int8), K10 in run (c) (int4)
QWEN_WQ_RUN = {"int8_matmul": "b", "int4_matmul": "c"}


def _wq_kernel_rows(report, gen):
    """K10 (int4) and W8A16 (int8, K12) at ``WQ_CASES``. Bound: 1e-2 × max
    |plain| over the output, the plain version computing in f32 from the
    same bf16 x. Every M = 4 shape is timed in turns with torch's
    weight-only matmul (``_wq_library``), which must meet the same bound;
    each prints its GB/s, column tile, cluster split, the busiest SM's share
    of the mean (``partition``'s model) and the weight bytes in flight an
    SM; at the end the int4 wrapper's host µs a call at the three 13B M = 4
    shapes, beside the two-launch wrapper's (``WQ_HOST_US_BEFORE``). Each
    kernel gets a row for each model, with that model's first case's
    numbers; a qwen2-audio-7b row reports the launches of its phase qwen
    run (``QWEN_WQ_RUN``)."""
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
    host_runs = []  # the 13B int4 M = 4 calls, timed on the host at the end
    for name, (kernel, plain, replaces) in kernels.items():
        for model in ("salmonn", "qwen2-audio-7b"):
            errs, timed = [], None
            for _, _, label, M, K, N, copies in (c for c in WQ_CASES
                                                 if c[0] == name and c[1] == model):
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                w, s = _wq_weights(gen, name, K, N, copies)
                first = 17 if copies > 17 else 0
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
                if M == 4:
                    libs = [_wq_library(name, w[c], s[c]) for c in range(copies)]
                    lib_err = (libs[first](x).float() - ref).abs().max().item()
                    print(f"  {name} {label}: library call vs plain {lib_err:.3e} (tolerance "
                          f"{tol:.1e}) {'ok' if lib_err <= tol else 'FAIL'}", flush=True)
                    if lib_err > tol:
                        raise AssertionError(f"{name} library call error {lib_err} > {tol}")
                    ms, lib_ms = _in_turns(f"{name} {label}", run,
                                           lambda i=0: libs[i % copies](x), bound,
                                           lib_name=f"aten._weight_{name[:4]}pack_mm")
                    del libs
                    if name == "int4_matmul" and model == "salmonn":
                        host_runs.append(run)
                else:
                    ms = _device_ms(run)
                plain_ms = _device_ms(lambda i=0: plain(x, w[i % copies], s[i % copies]),
                                      reps=5)
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
                      f"{nbytes / 1e6:.1f} MB) = {100 * bound[0] / ms:.1f}% of its bound, "
                      f"{tile_n}-column tiles, {splits} K splits a cluster, {blocks} blocks, "
                      f"busiest SM {max(work) * len(work) / sum(work):.3f}× the mean, "
                      f"{resident:.2f} blocks an SM at once: up to {in_flight / 1024:.0f} KB "
                      f"of weight in flight an SM; plain {plain_ms:.4f} ms", flush=True)
                if timed is None:
                    timed = (ms, plain_ms, bound, lib_ms)
                del x, w, s, y, ref
                torch.cuda.empty_cache()
            qwen = model != "salmonn"
            row = report(f"{name} (qwen2-audio-7b)" if qwen else name, "cuda",
                         "icl_speech_text_llm_tpu_torch/csrc/wq_matmul.cu", replaces, errs,
                         *timed)
            if qwen:
                row["counter"], row["qwen_run"] = name, QWEN_WQ_RUN[name]
    # the wrapper's host µs a call: the least of three rounds over the shapes
    hosts = [min(h) for h in zip(*[[_host_us(r) for r in host_runs] for _ in range(3)])]
    print(f"  int4_matmul host µs a call at 13B w_gate / w_down / wq: "
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
    for name, _, label, M, K, N, copies in WQ_CASES:
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
    # q, k, v and o rows below the lengths, and m and l of those rows
    nbytes = 4 * 2 * H * D * sum(lens) + 2 * 4 * H * sum(lens)
    bound = _bound(nbytes, 4.0 * D * H * _causal_pairs(lens))
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
            # counted over the rows below the lengths, as K1's bound
            pairs = H * _causal_pairs(lens)
            qo = 2 * H * D * sum(lens)  # bytes of one (B, H, S, D) bf16 tensor's rows
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
            stats = 3 * 4 * H * sum(lens)  # m, l, delta
            _, sdpa_bwd_ms = _in_turns(
                f"{label} backward K5 + K6 (4, 32, 1024, 128)",
                lambda i=0: (fa.flash_attention_bwd_dq(*args),
                             fa.flash_attention_bwd_dkv(*args_kv)),
                lambda i=0: torch.autograd.grad(out, leaves, do, retain_graph=True),
                _bound(4 * qo + 2 * kv_len + stats, 10.0 * D * pairs),
                lib_name="SDPA backward", reps=10)
            del leaves, out, sdpa_mask
            timed = {
                "dq": (_device_ms(lambda i=0: fa.flash_attention_bwd_dq(*args)),
                       _time_ms(lambda: fa.flash_attention_bwd_dq_plain(*args)),
                       _bound(4 * qo + kv_len + stats, 6.0 * D * pairs), sdpa_bwd_ms),
                "dkv": (_device_ms(lambda i=0: fa.flash_attention_bwd_dkv(*args_kv)),
                        _time_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args_kv)),
                        _bound(2 * qo + 2 * kv_len + stats, 8.0 * D * pairs), sdpa_bwd_ms)}
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
    seq_lens = _qwen_kernel_rows(report, randn, stat_errs, valid_rows_err)
    _qwen_cache_rows(report, gen, seq_lens)
    _wq_kernel_rows(report, gen)
    _probe_kernel_rows(report, gen)
    return rows


def _one_layer(cfg):
    """A SALMONN config with one layer per stack at the same widths."""
    return _n_layers(cfg, 1)


def _n_layers(cfg, n):
    """A SALMONN config with ``n`` layers per stack at the same widths."""
    return dataclasses.replace(
        cfg,
        whisper=dataclasses.replace(cfg.whisper, n_layers=n),
        beats=dataclasses.replace(cfg.beats, n_layers=n),
        llm=dataclasses.replace(cfg.llm, n_layers=n),
    )


def _check_batch(cfg, seed, n_audio=None, L=256):
    """One request: 20 text positions, clip 0, 20 text, clip 1 of 5 s clips,
    in an L-position prompt, each clip splicing ``n_audio`` positions of its
    slot (all of it when None; else ``audio_lengths`` of 5 s rides along)
    → (batch, lengths)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    B, n_slots, n_text = 1, 2, 40
    T_a = cfg.audio_tokens_per_slot
    n = T_a if n_audio is None else n_audio
    wavs = (rng.randn(B, n_slots, 5 * 16000) * 3000).astype(np.int16)
    text = rng.randint(3, cfg.llm.vocab_size, size=(B, n_text)).astype(np.int32)
    idx = np.concatenate([1 + np.arange(20), 1 + n_text + np.arange(n),
                          21 + np.arange(20), 1 + n_text + T_a + np.arange(n)])
    gather = np.zeros((B, L), np.int64)
    gather[0, :len(idx)] = idx
    batch = {"text_tokens": text, "gather_idx": gather, "wavs": wavs}
    if n_audio is not None:
        batch["audio_lengths"] = np.full((B, n_slots), 5 * 16000, np.int32)
    return batch, np.array([len(idx)], np.int32)


def _logits_run(cfg, params, batch, lengths, device, tokens, kv_int8, attention,
                sequence_fn=None):
    """First-token logits, then one decode step (``attention``) per given
    token → a list of (1, V) f32 CPU tensors. ``sequence_fn``: the family's
    prompt embeddings (SALMONN's ``speech_sequence`` when None)."""
    import torch

    from icl_speech_text_llm_tpu_torch.inference.engine import prefill, speech_sequence
    from icl_speech_text_llm_tpu_torch.models.llama import decode_step, embed_tokens, lm_logits

    with torch.inference_mode():
        seq = (sequence_fn or speech_sequence)(cfg, params, {
            k: torch.as_tensor(v, device=device) for k, v in batch.items()})
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


def _cpu_reference(cfg, params, batch, lengths, kv_int8, steps=3, sequence_fn=None):
    """The f32 plain path on the CPU and its greedy tokens → (logits list,
    tokens)."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import DecodeAttention

    cpu_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    cpu_params = _tree_to(params, torch.device("cpu"), torch.float32)
    toks = []
    ref = _logits_run(cpu_cfg, cpu_params, batch, lengths, "cpu", toks, kv_int8,
                      DecodeAttention.XLA, sequence_fn)
    for _ in range(steps):
        toks.append(int(ref[-1].argmax(-1)[0]))
        ref = _logits_run(cpu_cfg, cpu_params, batch, lengths, "cpu", toks, kv_int8,
                          DecodeAttention.XLA, sequence_fn)
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


def _qwen_one_layer(cfg):
    """A Qwen2-Audio config with one layer per stack at the same widths."""
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, n_layers=1),
                               llm=dataclasses.replace(cfg.llm, n_layers=1))


def _qwen_reference_phase():
    """qwen2-audio-7b widths with one layer per stack (the tower over 128
    mels, Qwen2-7B's decoder: qkv biases, 28 query heads over 4 kv heads,
    rope θ 1e6): the bf16 kernel path on the card against the f32 plain path
    on the CPU, same weights and inputs, each 5 s clip splicing its 125
    positions: the first-token logits, 3 decode steps through the
    flash-decode kernel (K7 at n_rep 7) fed the CPU path's greedy tokens,
    then the training loss and the LoRA gradients. The qkv biases and LoRA
    B are drawn non-zero."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import DecodeAttention
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import (
        audio_output_length,
        init_qwen_audio,
        qwen2_audio_7b,
        qwen_audio_train_loss,
        qwen_sequence,
    )

    cfg = _qwen_one_layer(qwen2_audio_7b())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    params = init_qwen_audio(cfg, gen, dev, torch.bfloat16, trainable_dtype=torch.float32)
    attn = params["llm"]["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (torch.randn(attn[name].shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=dev) * 0.02
    n_audio = audio_output_length(5 * 16000)
    batch, lengths = _check_batch(cfg, 5, n_audio, 384)
    ref, toks = _cpu_reference(cfg, params, batch, lengths, kv_int8=False,
                               sequence_fn=qwen_sequence)
    got = _checked_launches(
        "qwen2-audio-7b bf16 one-layer check with K7",
        lambda: _logits_run(cfg, params, batch, lengths, dev, toks, False,
                            DecodeAttention.FLASH, qwen_sequence),
        {"flash_decode_attention": 3, "flash_attention_causal": 1,
         "flash_attention_noncausal": 1, "append_kv": 3})
    _compare_logits("qwen2-audio-7b bf16", got, ref)
    _grad_check("qwen2-audio-7b ", cfg, params, _train_batch(cfg, n_audio, 384, 5 * 16000),
                qwen_audio_train_loss, {})
    del params
    torch.cuda.empty_cache()


#: phase qwen's packing (--seq_len, --text_len) and Qwen2-7B's vocabulary
QWEN_SEQ = (2048, 1024)
QWEN_VOCAB = 156032


def _qwen_batches(n_requests=8):
    """Phase qwen's requests as the CLI packs them, on the host: for each
    batch of 4, (prompt positions used, each clip's valid samples)."""
    from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
    from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
    from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import audio_output_length
    from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    ds = create_dataset(DatasetType.VOXCELEB, split=DatasetSplit.TEST,
                        input_mode="speech_only", fewshot_mode="speech", num_examples=5,
                        is_training=False, max_samples=n_requests, synthetic=True,
                        synthetic_size=32, seed=42, prompt_style="qwen")
    pack = PackConfig(seq_len=QWEN_SEQ[0], text_len=QWEN_SEQ[1], max_slots=6,
                      audio_tokens_per_slot=750, audio_len_fn=audio_output_length)
    out = []
    for start in range(0, n_requests, 4):
        b = collate_icl_batch([ds[i] for i in range(start, start + 4)], get_tokenizer(), pack)
        out.append((b.seq_lengths.tolist(), b.audio["audio_lengths"].reshape(-1).tolist()))
    return out


def _qwen_kernel_rows(report, randn, stat_errs, valid_rows_err):
    """K1, K2 and K5 + K6 at the shapes phase qwen gives them, from its first
    batch (``_qwen_batches``): K1 the Qwen2-7B prefill (4, 28, 2048, 128)
    over 4 kv heads (n_rep 7) with the prompts' lengths; K2 the tower's 24
    clips over the T' rows the tower runs (``tower_frames``: 256 for clips
    of 50-150 frames), (24, 20, 256, 64), with each clip's frame count as
    its key length (also checked at T' − 1, the most frames a clip of that
    bucket holds); K5 + K6 K1's shape. Each
    bound counts the rows the result holds: the query rows below each
    length (the rows past it are padding that no consumer reads: K1, K5
    and K6 are compared below the lengths, K2 on every row, as both sides
    compute them) and the keys below it, not all T' or 2048; the share
    of the bound over every query row the kernel computes is printed beside
    it. The library calls are SDPA with the same masks (``enable_gqa`` for
    n_rep 7) and its backward. Rows report run (a)'s launches (K1, K2) and
    run (e)'s (K5, K6). → the prompts' lengths."""
    import torch
    import torch.nn.functional as F

    from icl_speech_text_llm_tpu_torch.models.qwen_audio import (
        audio_feat_lengths,
        host_tower_frames,
    )
    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    seq_lens, clip_samples = _qwen_batches(4)[0]
    frames = [int(audio_feat_lengths(n)) for n in clip_samples]
    tower_rows = host_tower_frames(clip_samples)
    print(f"  qwen2-audio-7b shapes: prompt positions {seq_lens} of {QWEN_SEQ[0]}, clip "
          f"frames {frames} of 1500, the tower runs {tower_rows}", flush=True)

    def qwen_row(name, errs, ms, plain_ms, bound, lib_ms, every_row):
        print(f"  {name} qwen2-audio-7b: {100 * bound[0] / ms:.1f}% of its bound over the "
              f"valid rows {bound[0]:.4f} ms ({bound[1]}); {100 * every_row[0] / ms:.1f}% of "
              f"the bound over every query row the kernel computes {every_row[0]:.4f} ms "
              f"({every_row[1]})", flush=True)
        row = report(f"{name} (qwen2-audio-7b)", "cuda",
                     "icl_speech_text_llm_tpu_torch/csrc/" + (
                         "flash_bwd.cu" if "bwd" in name else "flash_fwd.cu"),
                     "icl_speech_text_llm_tpu/ops/flash_attention.py:" + {
                         "flash_attention_causal": "145", "flash_attention_noncausal": "238",
                         "flash_attention_bwd_dq": "432", "flash_attention_bwd_dkv": "455"}[name],
                     errs, ms, plain_ms, bound, lib_ms)
        row["counter"], row["qwen_run"] = name, "e" if "bwd" in name else "a"

    # K1: the prefill, n_rep 7
    B, H, Hkv, S, D = 4, 28, 4, QWEN_SEQ[0], 128
    lengths = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q, do = randn(B, H, S, D), randn(B, H, S, D)
    k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    keep = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    do = do * keep[:, None, :, None].to(do.dtype)
    o, m, l = fa.flash_attention_causal(q, k, v, lengths)
    errs = stat_errs((o, m, l), fa.flash_attention_plain(q, k, v, lengths, causal=True),
                     seq_lens)
    rows_i = torch.arange(S, device=dev)
    sdpa_mask = ((rows_i[None, :] <= rows_i[:, None])[None]
                 & (rows_i[None, None, :] < lengths[:, None, None]))[:, None]
    n_valid = sum(seq_lens)
    pairs = H * _causal_pairs(seq_lens)
    pairs_all = H * sum(n * (n + 1) // 2 + (S - n) * n for n in seq_lens)
    qo = 2 * H * D * n_valid  # bytes of a (B, H, S, D) bf16 tensor's valid rows
    qo_all = 2 * B * H * S * D
    kv_len = 2 * 2 * Hkv * D * n_valid  # k and v rows below the lengths
    bound = _bound(2 * qo + kv_len + 2 * 4 * H * n_valid, 4.0 * D * pairs)
    every_row = _bound(2 * qo_all + kv_len + 2 * 4 * B * H * S, 4.0 * D * pairs_all)
    ms, lib_ms = _in_turns(
        f"flash_attention_causal qwen2-audio-7b ({B}, {H}, {S}, {D}) over {Hkv} kv heads",
        lambda i=0: fa.flash_attention_causal(q, k, v, lengths),
        lambda i=0: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                   enable_gqa=True), bound)
    qwen_row("flash_attention_causal", errs, ms,
             _time_ms(lambda: fa.flash_attention_plain(q, k, v, lengths, True)), bound, lib_ms,
             every_row)

    # K5 + K6 at K1's shape
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, m, l, do, lengths, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, m, l, delta, do, lengths, True)
    f = [t.float() for t in (q, k, v, o)]
    dq_p, delta_p = fa.flash_attention_bwd_dq_plain(*f, m, l, do.float(), lengths, True)
    dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(*f[:3], m, l, delta_p, do.float(), lengths,
                                                  True)
    del f

    def rel_bound(what, ker, ref, scale=2e-2):
        return (f"n_rep 7 {what} (bound {scale:g} × max |plain|)",
                valid_rows_err(ker, ref, seq_lens),
                scale * valid_rows_err(ref, torch.zeros_like(ref), seq_lens))

    dq_errs = [rel_bound("dq", dq, dq_p),
               rel_bound("delta", delta[..., None], delta_p[..., None], 1e-3)]
    dkv_errs = [rel_bound("dk", dk, dk_p), rel_bound("dv", dv, dv_p)]
    del dq_p, dk_p, dv_p, delta_p
    args = (q, k, v, o, m, l, do, lengths, True)
    args_kv = (q, k, v, m, l, delta, do, lengths, True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask, enable_gqa=True)
    stats, stats_all = 3 * 4 * H * n_valid, 3 * 4 * B * H * S  # m, l, delta
    kv_all = 2 * 2 * B * Hkv * S * D  # dk and dv, every row
    _, sdpa_bwd_ms = _in_turns(
        f"backward K5 + K6 qwen2-audio-7b ({B}, {H}, {S}, {D}) over {Hkv} kv heads",
        lambda i=0: (fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args_kv)),
        lambda i=0: torch.autograd.grad(out, leaves, do, retain_graph=True),
        _bound(4 * qo + 2 * kv_len + stats, 10.0 * D * pairs),
        lib_name="SDPA backward", reps=10)
    del leaves, out, sdpa_mask
    dq_ms = _device_ms(lambda i=0: fa.flash_attention_bwd_dq(*args))
    dkv_ms = _device_ms(lambda i=0: fa.flash_attention_bwd_dkv(*args_kv))
    print(f"  backward alone qwen2-audio-7b: K5 {dq_ms:.4f} ms, K6 {dkv_ms:.4f} ms", flush=True)
    qwen_row("flash_attention_bwd_dq", dq_errs, dq_ms,
             _time_ms(lambda: fa.flash_attention_bwd_dq_plain(*args)),
             _bound(4 * qo + kv_len + stats, 6.0 * D * pairs), sdpa_bwd_ms,
             _bound(4 * qo_all + kv_len + stats_all, 6.0 * D * pairs_all))
    qwen_row("flash_attention_bwd_dkv", dkv_errs, dkv_ms,
             _time_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args_kv)),
             _bound(2 * qo + 2 * kv_len + stats, 8.0 * D * pairs), sdpa_bwd_ms,
             _bound(2 * qo_all + kv_len + kv_all + stats_all, 8.0 * D * pairs_all))
    del q, k, v, do, o, m, l, dq, dk, dv, delta, args, args_kv
    torch.cuda.empty_cache()

    # K2: the audio tower over the rows it runs, each clip's keys below its
    # frame count
    B, H, S, D = len(frames), 20, tower_rows, 64
    lengths = torch.tensor(frames, dtype=torch.int32, device=dev)
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    # every query row compared: both sides compute the rows past a clip's
    # frames over the same keys
    errs = stat_errs(fa.flash_attention_noncausal(q, k, v, lengths),
                     fa.flash_attention_plain(q, k, v, lengths, causal=False), [S] * B)
    edge = torch.full((B,), S - 1, dtype=torch.int32, device=dev)  # the bucket's longest
    errs += [(f"clips of {S - 1} frames {what}", e, tol) for what, e, tol in stat_errs(
        fa.flash_attention_noncausal(q, k, v, edge),
        fa.flash_attention_plain(q, k, v, edge, causal=False), [S] * B)]
    key_mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    # valid: q, k, v and o rows below each clip's frames, m and l of those
    # rows, every such query row against its clip's keys; every row: all
    # S query rows of q, o, m and l against the clip's keys
    n_valid = sum(frames)
    bound = _bound(4 * 2 * H * D * n_valid + 2 * 4 * H * n_valid,
                   4.0 * D * H * sum(n * n for n in frames))
    every_row = _bound(2 * 2 * B * H * S * D + 2 * 2 * H * D * n_valid + 2 * 4 * B * H * S,
                       4.0 * D * H * S * n_valid)
    ms, lib_ms = _in_turns(
        f"flash_attention_noncausal qwen2-audio-7b ({B}, {H}, {S}, {D}), keys {n_valid} "
        f"of {B * S}",
        lambda i=0: fa.flash_attention_noncausal(q, k, v, lengths),
        lambda i=0: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask), bound)
    qwen_row("flash_attention_noncausal", errs, ms,
             _time_ms(lambda: fa.flash_attention_plain(q, k, v, lengths, False)), bound, lib_ms,
             every_row)
    del q, k, v, key_mask
    torch.cuda.empty_cache()
    return seq_lens


#: the static engine's cache length at phase qwen's packing: the 2048
#: positions and 10 new tokens, rounded up to 128 (``generate_tokens``)
QWEN_CACHE_LEN = -(-(QWEN_SEQ[0] + 10) // 128) * 128


def _qwen_cache_rows(report, gen, seq_lens):
    """K4, K4 q8 and K7 q8 at qwen2-audio-7b's static cache (28, 4, 4, 2176,
    128), n_rep 7, the first decode step of phase qwen's first batch: rows
    written at the prompts' lengths, attention over the rows below them
    plus the current token's column. K4 and K4 q8 bit-exact against their
    plain versions, K7 q8 per output row (``_row_case``); K4 timed in turns
    with two ``index_put_`` (which must write the same bytes), K7 q8 one
    layer a call cycling over the 28; bounds as ``_append_kernel_rows``'s
    and ``_decode_kernel_rows``'. Rows report run (a)'s K4 launches and run
    (c)'s K4 q8 and K7 q8 launches."""
    import torch

    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    dev, bf = torch.device("cuda"), torch.bfloat16
    L, B, H, Hkv, S, D = 28, 4, 28, 4, QWEN_CACHE_LEN, 128
    pos = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    shape = f"({L}, {B}, {Hkv}, {S}, {D})"

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev).to(bf)

    def same(a, b):
        return 0.0 if all(torch.equal(x, y) for x, y in zip(a, b)) else max(
            (x.float() - y.float()).abs().max().item() for x, y in zip(a, b))

    def row(name, errs, ms, plain_ms, bound, lib_ms, run):
        r = report(f"{name} (qwen2-audio-7b)", "cuda",
                   "icl_speech_text_llm_tpu_torch/csrc/" + (
                       "flash_decode.cu" if "decode" in name else "append_kv.cu"),
                   "icl_speech_text_llm_tpu/ops/flash_attention.py:" + (
                       "1281" if "decode" in name else "1438"), errs, ms, plain_ms, bound,
                   lib_ms)
        r["counter"], r["qwen_run"] = name, run

    # K4: bf16 rows into the bf16 cache
    ck, cv = randn(L, B, Hkv, S, D), randn(L, B, Hkv, S, D)
    nk, nv = randn(L, B, Hkv, 1, D), randn(L, B, Hkv, 1, D)
    plain, lib_copy = [ck.clone(), cv.clone()], [ck.clone(), cv.clone()]
    fa.append_kv(ck, cv, nk, nv, pos)
    fa.append_kv_plain(*plain, nk, nv, pos)
    b_idx, pos_l = torch.arange(B, device=dev), pos.long()
    rows_k, rows_v = (t[:, :, :, 0].permute(1, 0, 2, 3).contiguous() for t in (nk, nv))

    def index_put(i=0, ck=ck, cv=cv):
        ck.permute(1, 3, 0, 2, 4).index_put_((b_idx, pos_l), rows_k)
        cv.permute(1, 3, 0, 2, 4).index_put_((b_idx, pos_l), rows_v)

    index_put(0, *lib_copy)
    errs = [(f"bf16 cache {shape} (bit-exact)", same([ck, cv], plain), 0.0),
            ("index_put_ (library) vs kernel (bit-exact)", same([ck, cv], lib_copy), 0.0)]
    del plain, lib_copy
    bound = _bound(4 * L * B * Hkv * D * 2, 0.0)
    ms, lib_ms = _in_turns(f"append_kv qwen2-audio-7b {shape}",
                           lambda i=0: fa.append_kv(ck, cv, nk, nv, pos), index_put, bound,
                           lib_name="index_put_ ×2", reps=50)
    row("append_kv", errs, ms,
        _device_ms(lambda i=0: fa.append_kv_plain(ck, cv, nk, nv, pos), reps=50), bound, lib_ms,
        "a")
    del ck, cv, rows_k, rows_v

    # K4 q8: the same bf16 rows quantized into the int8 cache and its scales
    cache = [torch.randint(-127, 128, (L, B, Hkv, S, D), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    cache += [torch.rand((L, B, Hkv, S), generator=gen, device=dev) for _ in range(2)]
    plain = [t.clone() for t in cache]
    fa.append_kv_q8(*cache, nk, nv, pos)
    fa.append_kv_q8_plain(*plain, nk, nv, pos)
    errs = [(f"int8 cache {shape}, bf16 rows, rows and scales (bit-exact)",
             same(cache, plain), 0.0)]
    del plain
    bound = _bound(2 * L * B * Hkv * D * 2 + 2 * L * B * Hkv * D + 2 * L * B * Hkv * 4 + 4 * B,
                   0.0)
    ms = _device_ms(lambda i=0: fa.append_kv_q8(*cache, nk, nv, pos), reps=50)
    print(f"  append_kv_q8 qwen2-audio-7b {shape}: kernel {ms:.4f} ms = "
          f"{100 * bound[0] / ms:.1f}% of its bound {bound[0]:.4f} ms", flush=True)
    row("append_kv_q8", errs, ms,
        _device_ms(lambda i=0: fa.append_kv_q8_plain(*cache, nk, nv, pos), reps=5), bound,
        None, "c")
    del cache, nk, nv
    torch.cuda.empty_cache()

    # K7 q8: one token's attention over the int8 cache, n_rep 7
    q, cache, lengths, self_kv = _decode_case(gen, L, B, H, Hkv, S, seq_lens, True)

    def kernel(i=0):
        return fa.flash_decode_attention_q8(q, *cache, lengths, self_kv=self_kv, layer=i % L)

    def plain(i=0):
        c = [t[i % L] for t in cache]
        return fa.flash_decode_attention_plain(q, c[0], c[1], lengths, self_kv=self_kv,
                                               k_s=c[2], v_s=c[3])

    errs = [_row_case(f"int8 cache {shape}, H {H}, layer {layer}", kernel(layer),
                      plain(layer)) for layer in (0, L - 1)]
    nbytes = Hkv * sum(seq_lens) * (2 * D + 8) + 2 * 2 * B * H * D + 2 * 2 * B * Hkv * D
    bound = _bound(nbytes, 4.0 * D * H * sum(n + 1 for n in seq_lens))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = fa.decode_splits(B, Hkv, sms, fa.decode_resident(0, H // Hkv))
    ms = _device_ms(kernel)
    print(f"  flash_decode_attention_q8 qwen2-audio-7b {shape}, H {H}: clusters of {splits}, "
          f"{B * Hkv * splits} blocks; kernel {ms:.4f} ms = {100 * bound[0] / ms:.1f}% of its "
          f"bound {bound[0]:.4f} ms", flush=True)
    row("flash_decode_attention_q8", errs, ms, _device_ms(plain, reps=5), bound, None, "c")
    del q, cache, lengths, self_kv
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
    import torch

    from icl_speech_text_llm_tpu_torch.models.salmonn import (
        init_salmonn,
        salmonn_7b,
        salmonn_train_loss,
    )

    cfg = _one_layer(salmonn_7b())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    params = init_salmonn(cfg, gen, dev, torch.bfloat16, trainable_dtype=torch.float32)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=dev) * 0.02
    _grad_check("", cfg, params, _train_batch(cfg, cfg.audio_tokens_per_slot, 256),
                salmonn_train_loss, {"qformer": lambda n: n.startswith("qformer.")})
    del params
    torch.cuda.empty_cache()


def _symbol_batch(cfg, seq=(768, 512)):
    """Two MELD-emotion train requests (k = 5 text exemplars, one clip) with
    every label replaced by the symbols of a ``SymbolManager`` seeded 0,
    packed to ``seq``, and the label mask over each symbol's tokens (bare
    and space-prefixed, as the trainer builds it)."""
    from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
    from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
    from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
    from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
    from icl_speech_text_llm_tpu_torch.symbol_adapter import (
        SymbolManager,
        extract_dataset_labels,
        label_token_mask,
        replace_symbols_in_sample,
    )
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    tok = get_tokenizer()
    sm = SymbolManager(extract_dataset_labels([DatasetType.MELD_EMOTION]), tok, seed=0)
    ds = create_dataset(DatasetType.MELD_EMOTION, split=DatasetSplit.TRAIN, is_training=True,
                        input_mode="speech_only", fewshot_mode="text", num_examples=5,
                        max_samples=2, synthetic=True, seed=0)
    samples = [replace_symbols_in_sample(ds[i], sm.fixed_mappings) for i in range(2)]
    b = collate_icl_batch(samples, tok, PackConfig(seq_len=seq[0], text_len=seq[1], max_slots=1,
                                                   audio_tokens_per_slot=cfg.audio_tokens_per_slot))
    ids = [i for sym in sm.fixed_mappings.values()
           for i in tok.encode(sym, add_special_tokens=False)
           + tok.encode(" " + sym, add_special_tokens=False)]
    mask = label_token_mask(b.text_tokens, ids)
    if b.labels_shifted.max() >= cfg.llm.vocab_size or not mask.any():
        raise AssertionError("symbol batch: a label past the vocabulary, or no symbol token")
    print(f"  symbol batch: mappings {sm.fixed_mappings}; {int(mask.sum())} masked text "
          f"positions, prompts of {b.seq_lengths.tolist()} positions", flush=True)
    return {"text_tokens": b.text_tokens, "gather_idx": b.gather_idx, "seq_mask": b.seq_mask,
            "shifted_labels": b.labels_shifted, "wavs": b.audio["wavs"], "label_mask": mask}


def _symbol_check_phase():
    """salmonn-7b widths with one layer per stack: the symbol loss
    (``mlp_salmonn_train_loss``, soft quantization at T = 0.1 over the
    32000-row vocabulary) and the LoRA and ``input_mlp`` gradients of the
    bf16 kernel path on the card against the f32 plain path on the CPU, the
    same weights and batch (``_grad_check``'s bounds, plus each element
    within 5e-2 × max |plain gradient|); then the hard ids of the masked
    positions, equal wherever the CPU's top-two similarity gap exceeds the
    resolution: twice the card's largest similarity error, at least one
    bf16 step (2^-8 on these unit-norm products), that error itself at
    most 2^-6."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import embed_tokens
    from icl_speech_text_llm_tpu_torch.models.salmonn import init_salmonn, salmonn_7b
    from icl_speech_text_llm_tpu_torch.symbol_adapter import (
        init_mlp_adapter,
        transform_label_embeddings,
    )
    from icl_speech_text_llm_tpu_torch.symbol_adapter.losses import mlp_salmonn_train_loss
    from icl_speech_text_llm_tpu_torch.symbol_adapter.mlp_adapter import _unit, mlp_forward

    cfg = _one_layer(salmonn_7b())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    params = init_salmonn(cfg, gen, dev, torch.bfloat16, trainable_dtype=torch.float32)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=dev) * 0.02
    params["mlp_adapter"] = init_mlp_adapter(gen, cfg.llm.dim, 8, device=dev)
    batch = _symbol_batch(cfg)

    def loss_fn(cfg, p, b):
        return mlp_salmonn_train_loss(cfg, p, b, mlp_params=p["mlp_adapter"], temperature=0.1)[0]

    _grad_check("symbol ", cfg, params, batch, loss_fn,
                {"mlp_adapter.input_mlp": lambda n: n.startswith("mlp_adapter.input_mlp.")},
                trainable_keys=("lora", "mlp_adapter"), max_abs=True)

    cpu = torch.device("cpu")
    tokens, mask = (torch.as_tensor(batch[k]) for k in ("text_tokens", "label_mask"))
    with torch.no_grad():
        got, want = [], []
        for device, dt, out in ((dev, torch.bfloat16, got), (cpu, torch.float32, want)):
            mlp = _tree_to(params["mlp_adapter"], device, torch.float32)
            vocab = params["llm"]["tok_embed"].to(device, dt)
            emb = embed_tokens({"tok_embed": vocab}, tokens.to(device), dtype=dt)
            _, ids, _ = transform_label_embeddings(mlp, emb, mask.to(device), vocab, hard=True)
            x = (emb + mlp_forward(mlp["input_mlp"], emb))[mask.to(device)]
            sims = _unit(x) @ _unit(vocab).T.to(x.dtype)
            out += [ids[mask.to(device)].cpu(), sims.float().cpu()]
    err = (got[1] - want[1]).abs().max().item()
    top2 = want[1].topk(2, dim=-1).values
    res = max(2 * err, 2.0 ** -8)
    clear = (top2[:, 0] - top2[:, 1]) > res
    same = got[0] == want[0]
    print(f"  symbol hard ids: {int(mask.sum())} masked positions, similarity error "
          f"{err:.3e} (bound {2.0 ** -6:.3e}); {int(clear.sum())} with a top-two gap over "
          f"{res:.3e}, all equal: {bool(same[clear].all())}; {int(same.sum())} equal in all",
          flush=True)
    if err > 2.0 ** -6 or not same[clear].all():
        raise AssertionError("symbol hard ids differ where the similarity gap is resolved")
    del params
    torch.cuda.empty_cache()


def _train_batch(cfg, n_audio, L, clip_samples=None):
    """Two requests of text, clip 0, text, clip 1 (5 s clips, ragged text
    lengths) in an L-position prompt, ``n_audio`` positions spliced from
    each clip's slot, labels on 5 positions before each end.
    ``clip_samples``: each clip's valid samples (``audio_lengths``), for a
    family that splices per clip."""
    import numpy as np

    rng = np.random.RandomState(1)
    B, n_slots, n_text = 2, 2, 40
    T_a = cfg.audio_tokens_per_slot
    wavs = (rng.randn(B, n_slots, 5 * 16000) * 3000).astype(np.int16)
    text = rng.randint(3, cfg.llm.vocab_size, size=(B, n_text)).astype(np.int32)
    gather = np.zeros((B, L), np.int64)
    mask = np.zeros((B, L), np.int32)
    labels = np.full((B, L), -100, np.int64)
    for b, n in enumerate((20, 10)):  # text, clip 0, text, clip 1; ragged lengths
        idx = np.concatenate([1 + np.arange(n), 1 + n_text + np.arange(n_audio),
                              1 + n + np.arange(n), 1 + n_text + T_a + np.arange(n_audio)])
        gather[b, :len(idx)] = idx
        mask[b, :len(idx)] = 1
        labels[b, len(idx) - 6:len(idx) - 1] = rng.randint(3, cfg.llm.vocab_size, 5)
    batch = {"text_tokens": text, "gather_idx": gather, "seq_mask": mask,
             "shifted_labels": labels, "wavs": wavs}
    if clip_samples is not None:
        batch["audio_lengths"] = np.full((B, n_slots), clip_samples, np.int32)
    return batch


#: the LoRA gradient groups of the training checks
LORA_GROUPS = {"lora.*.a": lambda n: n.startswith("lora.") and n.endswith(".a"),
               "lora.*.b": lambda n: n.startswith("lora.") and n.endswith(".b")}


def _grad_check(label, cfg, params, batch, loss_fn, groups,
                trainable_keys=("lora", "qformer"), max_abs=False):
    """The training loss and the trainable gradients of the bf16 kernel path
    on the card (one K1, K5 and K6 launch: one layer) against the f32 plain
    path on the CPU, the same weights and batch: the loss within 1e-2
    relative, each group of gradients (``LORA_GROUPS`` and ``groups``)
    within 5e-2 relative (L2) with a cosine of 0.99 or more, and with
    ``max_abs`` each element within 5e-2 × the group's max |plain
    gradient|. The subtrees ``trainable_keys`` get gradients (a leaf the
    loss does not reach gets zeros)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.training.step import merge_params, split_params, tree_map

    def loss_and_grads(cfg, params, device):
        trainable, frozen = split_params(params, trainable_keys)
        trainable = tree_map(lambda t: t.detach().clone().requires_grad_(), trainable)
        loss = loss_fn(cfg, merge_params(frozen, trainable),
                       {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
        named = _paths(trainable)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return loss.item(), {n: (torch.zeros(p.shape) if g is None else g.float().cpu())
                             for (n, p), g in zip(named.items(), grads)}

    before = kernels.launch_counts()
    got_loss, got = loss_and_grads(cfg, params, torch.device("cuda"))
    after = kernels.launch_counts()
    for name in ("flash_attention_causal", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if after[name] - before[name] != 1:
            raise AssertionError(f"{name}: {after[name] - before[name]} launches, expected 1")
    cpu_params = _tree_to(params, torch.device("cpu"), torch.float32)
    want_loss, want = loss_and_grads(dataclasses.replace(cfg, compute_dtype=torch.float32),
                                     cpu_params, torch.device("cpu"))
    del cpu_params
    rel = abs(got_loss - want_loss) / abs(want_loss)
    print(f"  {label}train loss: card {got_loss:.6f} vs f32 CPU {want_loss:.6f}, relative "
          f"error {rel:.3e} (bound 1e-2)", flush=True)
    if not (np.isfinite(got_loss) and rel <= 1e-2):
        raise AssertionError(f"{label}train loss check failed: {got_loss} vs {want_loss}")
    for gname, member in {**LORA_GROUPS, **groups}.items():
        names = [n for n in want if member(n)]
        g = torch.cat([got[n].flatten() for n in names]).double()
        w = torch.cat([want[n].flatten() for n in names]).double()
        rel = ((g - w).norm() / w.norm()).item()
        cos = (g @ w / (g.norm() * w.norm())).item()
        elem = ((g - w).abs().max() / w.abs().max()).item()
        print(f"  {label}grad {gname} ({len(names)} leaves, |g| {w.norm().item():.4e}): "
              f"relative error {rel:.3e} (bound 5e-2), cosine {cos:.6f} (bound 0.99), "
              f"max abs error / max |g| {elem:.3e}"
              + (" (bound 5e-2)" if max_abs else ""), flush=True)
        if not (w.norm() > 0 and rel <= 5e-2 and cos >= 0.99) or (max_abs and elem > 5e-2):
            raise AssertionError(f"{label}train gradient check failed for {gname}")


def _tree_to(tree, device, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def _checked_run(label, run, n_requests, need, max_new=10, vocab=32000, none=()):
    """One inference run at full width on the card: ``run()`` → the paths of
    its results and metrics JSON. Launch counts are set to 0 just before the
    run and read just after; every token in the ``vocab``, each ``need``
    floor met, no launch of a kernel in ``none``; returns (counts, paths)."""
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
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
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
    for name in none:
        if counts[name]:
            raise AssertionError(f"{label} launched {name} {counts[name]} times (needs none)")
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
              run_name="chip_smoke", seq=(1024, 448), vocab=32000, none=()):
    """cli/inference.py at full width on the card, prompts packed to
    ``seq`` = (seq_len, text_len); returns the run's kernel launch counts
    and the paths of its results and metrics JSON."""
    from icl_speech_text_llm_tpu_torch.cli import inference

    argv = ["--model_type", model_type, "--dataset_type", "voxceleb", "--synthetic",
            "--input_mode", "speech_only", "--fewshot_mode", "speech",
            "--num_examples", "5", "--batch_size", "4", "--max_samples", str(n_requests),
            "--seq_len", str(seq[0]), "--text_len", str(seq[1]),
            "--max_new_tokens", str(max_new),
            "--device", "cuda", "--results_dir", out_dir, "--run_name", run_name, *extra]
    return _checked_run(f"{model_type} {' '.join(extra) or 'bf16'}",
                        lambda: inference.main(argv), n_requests, need, max_new, vocab, none)


def _api_run(out_dir, model_type, gen_kw, beats_kw, bits, n_requests, need, max_new=10,
             seq=(1024, 448), vocab=32000, none=()):
    """The library entry points a user calls for what the CLI has no flag
    for: ``create_model(generation=GenerationConfig(**gen_kw))``, the BEATs
    options ``beats_kw`` (None: no BEATs) set on the model's config,
    ``quantize_decoder`` when ``bits``, then ``run_inference`` +
    ``save_final_results`` on voxceleb requests as the CLI builds them
    (packed to ``seq``); returns the run's launch counts and paths."""
    from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
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
        cfg = model.cfg
        if beats_kw is not None:
            cfg = dataclasses.replace(cfg, beats=dataclasses.replace(cfg.beats, **beats_kw))
            model.cfg = model.engine.cfg = cfg
        pack_cfg = dataclasses.replace(model.pack_cfg, seq_len=seq[0], text_len=seq[1],
                                       max_slots=6)
        dataset = create_dataset(
            DatasetType.VOXCELEB, split=DatasetSplit.TEST, input_mode="speech_only",
            fewshot_mode="speech", num_examples=5, is_training=False, max_samples=n_requests,
            synthetic=True, synthetic_size=32, seed=42,
            prompt_style="qwen" if model_type.startswith("qwen") else "salmonn")
        settings = InferenceSettings(
            batch_size=4, max_new_tokens=max_new, results_dir=out_dir, run_name="chip_smoke",
            input_mode="speech_only", fewshot_mode="speech", num_examples=5,
            max_samples=n_requests)
        payload = run_inference(model.engine, dataset, pack_cfg, settings)
        return save_final_results(payload, [DatasetType.VOXCELEB], settings)

    label = f"{model_type} {gen_kw} BEATs {beats_kw}" + (f" int{bits}" if bits else "")
    return _checked_run(label, run, n_requests, need, max_new, vocab, none)


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
    (launch counts, paths) of the 13B int4 + int8 KV CLI run, the paths of
    the 7B bf16 CLI run): 7B bf16, 13B
    int4 weights + int8 KV cache, 7B int8 weights, 7B beams through the CLI;
    7B with the flash-decode kernel and BEATs' row schedule, 13B int4 + int8
    KV with the flash-decode kernel and sampled beams through the library;
    BEATs' batched schedule through its op; the streaming probe through its
    entry point."""
    _, bf16_paths = _main_run(os.path.join(out_dir, "7b"), "salmonn-7b", [], 8, {
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
            "stream_read": probe["stream_read"]}, (quant, quant_paths), bf16_paths


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


def _train_argv(out_dir, n_steps, extra, model_type="salmonn-7b", seq=(1024, 448)):
    """cli/train.py's arguments of the train phase's runs: ``n_steps``
    batches of 4 voxceleb requests (k = 5 speech exemplars) packed to
    ``seq``, one epoch, validation on 4 requests."""
    return ["--model_type", model_type, "--dataset_type", "voxceleb", "--synthetic",
            "--fewshot_mode", "speech", "--num_examples", "5", "--batch_size", "4",
            "--max_samples", str(4 * n_steps), "--synthetic_size", "16", "--num_epochs", "1",
            "--seq_len", str(seq[0]), "--text_len", str(seq[1]), "--val_max_samples", "4",
            "--warmup_steps", "0", "--device", "cuda", "--output_dir", out_dir, *extra]


def _train_run(out_dir, n_steps, extra, need, model_type="salmonn-7b", seq=(1024, 448)):
    """cli/train.py at ``model_type``, full width, on the card, prompts
    packed to ``seq``; each step's launches at least ``need``; returns
    (result, launch counts of the run)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import train

    argv = _train_argv(out_dir, n_steps, extra, model_type, seq)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    perf = result.perf
    print(f"  {model_type} {' '.join(extra) or 'no remat'}: {perf['steps']} steps, losses "
          f"{[round(x, 4) for x in result.losses]}, skipped batches {result.skipped_batches}",
          flush=True)
    if perf["steps"] != n_steps or result.state.step != n_steps:
        raise AssertionError(f"expected {n_steps} steps, ran {perf['steps']}")
    if result.skipped_batches or not all(np.isfinite(result.losses)):
        raise AssertionError("a training batch was skipped or a loss is not finite")
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


#: the least launches of one salmonn-7b training step: the encoders' K2 and
#: K3, and K1, K5 and K6 in each of the 32 decoder layers
SALMONN_7B_STEP = {"flash_attention_causal": 32, "flash_attention_bwd_dq": 32,
                   "flash_attention_bwd_dkv": 32, "flash_attention_noncausal": 32,
                   "gated_bias_attention": 12}


def _train_phase(out_dir):
    """The training main path: 4 optimizer steps, then 2 with full remat;
    returns the first run's launch counts and losses."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.models.factory import create_model
    from icl_speech_text_llm_tpu_torch.training.checkpoint import copy_into, load_checkpoint

    result, counts = _train_run(os.path.join(out_dir, "plain"), 4, [], SALMONN_7B_STEP)
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
    losses = list(result.losses)
    del result, fresh, trained, init, ck
    torch.cuda.empty_cache()
    _train_run(os.path.join(out_dir, "remat"), 2, ["--gradient_checkpointing"],
               {**SALMONN_7B_STEP, "flash_attention_causal": 64})
    torch.cuda.empty_cache()
    return counts, losses


#: the serving CLI's requests: phase main's voxceleb requests (6 clips, k =
#: 5 speech exemplars, packed to 1024 positions), 10 new tokens
SERVE_ARGS = ["--dataset_type", "voxceleb", "--synthetic", "--input_mode", "speech_only",
              "--fewshot_mode", "speech", "--num_examples", "5", "--seq_len", "1024",
              "--text_len", "448", "--max_new_tokens", "10", "--device", "cuda"]
#: run 1's pool: phase main's batch of 4 as one admission wave at K1's
#: (4, 32, 1024, 128)
SERVE_7B_POOL = ["--num_slots", "4", "--admit_batch", "4", "--sync_every", "4",
                 "--prompt_buckets", "1024"]


def _serve_run(label, model_type, extra, n_requests, need, none=(), max_new=10,
               base=None, vocab=32000):
    """cli/serve.py at full width on the card, its output captured: launch
    counts set to 0 just before the run and read just after, the peak memory
    reset before. Every request answered with 1..max_new tokens of the
    vocabulary (none ends on EOS's id), each ``need`` floor met (a callable
    floor reads the run's summary), no launch of a kernel in ``none``. →
    (results, counts, summary line, wall seconds)."""
    import contextlib
    import io

    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import serve

    argv = ["--model_type", model_type, "--max_samples", str(n_requests),
            *(base or SERVE_ARGS), *extra]
    print(f"  {label}: cli.serve {' '.join(extra)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    lines = out.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    if sorted(results) != list(range(n_requests)):
        raise AssertionError(f"expected requests 0..{n_requests - 1}, got {sorted(results)}")
    for toks in results.values():
        if not (1 <= len(toks) <= max_new and all(0 <= t < vocab for t in toks)):
            raise AssertionError(f"bad served tokens {toks}")
    for name, floor in need.items():
        n = floor(summary) if callable(floor) else floor
        print(f"    launches {name}: {counts[name]} (need >= {n})", flush=True)
        if counts[name] < n:
            raise AssertionError(f"{name} launched {counts[name]} < {n} times")
    for name in none:
        if counts[name]:
            raise AssertionError(f"{label} launched {name} {counts[name]} times (needs none)")
    print(f"    {n_requests} requests in {wall:.3f} s wall (model build included); serving "
          f"{summary['throughput_req_s']} req/s over {summary['elapsed_s']} s; decode blocks "
          f"{summary['decode_blocks']}, admission waves {summary['prefill_waves']}, beam waves "
          f"{summary['beam_waves']}, flushes {summary['flushes']}, chunk prefills "
          f"{summary['chunk_dispatches']}; pool {summary['pool_bytes'] / 2**30:.3f} GiB; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    print(f"    {lines[0]}", flush=True)
    torch.cuda.empty_cache()
    return results, counts, summary, wall


def _serve_syncs():
    """Wraps the engine's decode block so that each one's synchronizing CUDA
    calls are counted (``torch.cuda.set_sync_debug_mode("warn")`` inside the
    block only) → (the list the counts go to, a function that unwraps)."""
    import warnings

    import torch

    from icl_speech_text_llm_tpu_torch.inference.serving import ContinuousBatchingEngine

    counts, plain = [], ContinuousBatchingEngine._decode_once

    def counted(self):
        before = self.stats["decode_blocks"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            plain(self)
            torch.cuda.set_sync_debug_mode(0)
        if self.stats["decode_blocks"] > before:
            counts.append(sum("synchroniz" in str(w.message) for w in caught))

    ContinuousBatchingEngine._decode_once = counted

    def unwrap():
        ContinuousBatchingEngine._decode_once = plain

    return counts, unwrap


def _serve_lora_dirs(out_dir):
    """Two trainable checkpoints written by the port's save_checkpoint: d0
    the LoRA of salmonn-7b drawn from seed 42 (the one phase main's and run
    1's model carry), d1 a second draw (seed 43) with its B drawn too (a
    drawn adapter starts with B = 0, which would serve d0's tokens)."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.factory import create_model
    from icl_speech_text_llm_tpu_torch.models.llama import init_lora
    from icl_speech_text_llm_tpu_torch.training.checkpoint import save_checkpoint

    model = create_model("salmonn-7b", seed=42, device="cuda")
    cfg, lora = model.cfg, model.params["lora"]
    gen = torch.Generator(device="cuda").manual_seed(43)
    second = init_lora(cfg.llm, cfg.lora, gen, "cuda", lora["wq"]["a"].dtype)
    for leaf in second.values():
        leaf["b"] = torch.randn(leaf["b"].shape, generator=gen, device="cuda").to(
            leaf["b"].dtype) * 0.02
    dirs = [os.path.join(out_dir, "lora_d0"), os.path.join(out_dir, "lora_d1")]
    # f32 on disk (numpy has no bf16), as the train CLI's f32 LoRA is saved
    save_checkpoint(dirs[0], {"lora": _tree_to(lora, "cuda", torch.float32)})
    save_checkpoint(dirs[1], {"lora": _tree_to(second, "cuda", torch.float32)})
    del model, lora, second
    torch.cuda.empty_cache()
    return dirs


def _served_against_static(label, served, static, eos=2):
    """Every served request's first token equal to the static engine's on
    the same request (an EOS first token serves nothing); prints how many
    full sequences agree and where the others first diverge."""
    n = len(static)
    firsts = [r["tokens"][0] for r in static]
    got = [served[i][0] if served[i] else eos for i in range(n)]
    print(f"    first tokens: served {got}, the static engine's {firsts}", flush=True)
    if got != firsts:
        raise AssertionError(f"{label}'s first tokens differ from the static engine's run")
    agree, diverge = 0, {}
    for i, r in enumerate(static):
        want = r["tokens"][:r["tokens"].index(eos)] if eos in r["tokens"] else r["tokens"]
        if served[i] == want:
            agree += 1
        else:
            diverge[i] = next(t for t in range(len(want) + 1)
                              if t >= len(served[i]) or t >= len(want) or served[i][t] != want[t])
    print(f"    full sequences equal to the static engine's: {agree} of {n}; first "
          f"divergent step {diverge}", flush=True)


def _serve_phase(out_dir, bf16_paths):
    """The serving CLI (inference/serving.py's slot pool) at full width, on
    phase main's voxceleb requests:
    1. salmonn-7b bf16, 8 requests, 4 slots, waves of 4, blocks of 4 steps,
       bucket 1024: K2/K3 in the encoders, K1 in admission, K4 a step; every
       first token equal to phase main's 7B bf16 CLI run (the same encoder
       batches and K1 at (4, 32, 1024, 128)), how many full sequences agree
       (the decode batch is 5 pool rows against 4), the synchronizing CUDA
       calls of each decode block;
    2. salmonn-13b int4 + int8 KV pool, the exemplar header registered once
       (prefix bucket 1024, K1 × 40), suffixes in bucket 256 admitted in
       chunks of 128, 8 slots: K10, K12 and K4 q8 every decode step, no K4;
    3. salmonn-7b with a bank of two LoRA checkpoints (requests alternate):
       K1 and K4 with per-request adapters; the adapter-0 requests (the
       model's own LoRA) give run 1's tokens;
    4. salmonn-7b with 4 beams (the beam lane), 4 requests."""
    with open(bf16_paths["results"]) as f:
        static = json.load(f)["results"]
    syncs, unwrap = _serve_syncs()
    served, _, summary, wall = _serve_run("salmonn-7b bf16", "salmonn-7b", SERVE_7B_POOL, 8, {
        "flash_attention_noncausal": 32 * 2, "gated_bias_attention": 12 * 2,
        "flash_attention_causal": 32 * 2, "append_kv": 9 * 2}, none=("append_kv_q8",))
    unwrap()
    print(f"    wall {wall:.3f} s, {8 / wall:.4f} req/s with the model build; synchronizing "
          f"CUDA calls per decode block {syncs} (information, no gate)", flush=True)
    _served_against_static("run 1", served, static)

    _, _, summary, _ = _serve_run(
        "salmonn-13b int4 + int8 KV, shared prefix, chunked", "salmonn-13b",
        ["--quantize_int4", "--kv_int8", "--shared_prefix", "--prefix_buckets", "1024",
         "--prompt_buckets", "256", "--chunk_len", "128", "--num_slots", "8",
         "--admit_batch", "4"], 8,
        {"int4_matmul": lambda s: 7 * 40 * 4 * s["decode_blocks"],
         "int8_matmul": lambda s: 4 * s["decode_blocks"],
         "append_kv_q8": lambda s: 4 * s["decode_blocks"], "flash_attention_causal": 40},
        none=("append_kv",))
    print(f"    prefix {summary['prefix_len']} positions, waves {summary['prefill_waves']}, "
          f"pool {summary['pool_bytes']} bytes", flush=True)

    dirs = _serve_lora_dirs(out_dir)
    banked, _, _, _ = _serve_run("salmonn-7b LoRA bank", "salmonn-7b",
                                 SERVE_7B_POOL + ["--lora_bank", ",".join(dirs)], 8,
                                 {"flash_attention_causal": 32 * 2, "append_kv": 9 * 2},
                                 none=("append_kv_q8",))
    same = [banked[i] == served[i] for i in range(8)]
    print(f"    tokens equal to run 1's: adapter 0 (requests 0, 2, 4, 6) {same[0::2]}, "
          f"adapter 1 {same[1::2]}", flush=True)
    if not all(same[0::2]):
        raise AssertionError("the bank's adapter 0 (the model's LoRA) changed run 1's tokens")

    _serve_run("salmonn-7b 4 beams", "salmonn-7b", SERVE_7B_POOL + ["--num_beams", "4"], 4,
               {"flash_attention_causal": 32, "append_kv": 9, "flash_attention_noncausal": 32,
                "gated_bias_attention": 12}, none=("append_kv_q8",))



#: the least launches of one qwen2-audio-7b training step: the tower's K2
#: in each of its 32 layers, and K1, K5 and K6 in each of the 28 decoder
#: layers
QWEN_STEP = {"flash_attention_noncausal": 32, "flash_attention_causal": 28,
             "flash_attention_bwd_dq": 28, "flash_attention_bwd_dkv": 28}


def _qwen_phase(out_dir):
    """Qwen2-Audio-7B at full width (the tower over 128 mels, Qwen2-7B with
    28 query heads over 4 kv heads; random weights from seed 42) on phase
    main's voxceleb requests in Qwen's chat format, each clip splicing its
    ``audio_output_length`` positions, packed to 2048 positions; each run's
    launch counts read from that run alone:
    (a) the inference CLI, bf16, 8 requests: K2 ×32 and K1 ×28 a batch, K4
        a step;
    (b) the CLI with --quantize_int8 --kv_int8, 4 requests: K12 ×(7 × 28)
        + 1 and K4 q8 a step;
    (c) create_model + run_inference with int4 weights, an int8 KV cache
        and use_flash_decode=True, 4 requests: K10 ×7 × 28, K7 q8 ×28 and
        K4 q8 a step;
    (d) the serving CLI, bf16, 8 requests, 4 slots, waves of 4, blocks of 4
        steps, bucket 2048: every first token equal to (a)'s;
    (e) the train CLI, batch 4: 2 steps (K2 ×32, K1, K5 and K6 ×28 each),
        then 2 with full remat (K1 ×56); every loss finite.
    → {"a" | "b" | "c" | "e": that run's launch counts}."""
    for i, (lens, clips) in enumerate(_qwen_batches()):
        print(f"  batch {i}: prompt positions used {lens} of {QWEN_SEQ[0]}; clip samples "
              f"{sorted(set(clips))}", flush=True)
    qwen = dict(seq=QWEN_SEQ, vocab=QWEN_VOCAB)
    counts = {}
    counts["a"], bf16_paths = _main_run(
        os.path.join(out_dir, "qwen_bf16"), "qwen2-audio-7b", [], 8,
        {"flash_attention_noncausal": 32 * 2, "flash_attention_causal": 28 * 2,
         "append_kv": 9 * 2}, none=("append_kv_q8", "gated_bias_attention"), **qwen)
    counts["b"], _ = _main_run(
        os.path.join(out_dir, "qwen_int8"), "qwen2-audio-7b", ["--quantize_int8", "--kv_int8"],
        4, {"int8_matmul": (7 * 28 + 1) * 9, "append_kv_q8": 9, "flash_attention_causal": 28,
            "flash_attention_noncausal": 32}, none=("append_kv",), **qwen)
    counts["c"], _ = _api_run(
        os.path.join(out_dir, "qwen_int4_flash_q8"), "qwen2-audio-7b",
        {"use_flash_decode": True, "kv_int8": True}, None, 4, 4,
        {"int4_matmul": 7 * 28 * 9, "flash_decode_attention_q8": 28 * 9, "append_kv_q8": 9},
        none=("append_kv", "flash_decode_attention"), **qwen)
    with open(bf16_paths["results"]) as f:
        static = json.load(f)["results"]
    base = list(SERVE_ARGS)
    base[base.index("--seq_len") + 1], base[base.index("--text_len") + 1] = map(str, QWEN_SEQ)
    served, _, _, _ = _serve_run(
        "qwen2-audio-7b bf16", "qwen2-audio-7b",
        ["--num_slots", "4", "--admit_batch", "4", "--sync_every", "4", "--prompt_buckets",
         str(QWEN_SEQ[0])], 8,
        {"flash_attention_noncausal": 32 * 2, "flash_attention_causal": 28 * 2,
         "append_kv": 9 * 2}, none=("append_kv_q8",), base=base, vocab=QWEN_VOCAB)
    _served_against_static("run (d)", served, static)
    # 32 synthetic samples, as the inference runs draw: every request then
    # has its 5 exemplar clips (from 16, some lack one, and a missing clip
    # takes its slot's whole 750 positions, as in JAX)
    full = ["--synthetic_size", "32"]
    _, counts["e"] = _train_run(os.path.join(out_dir, "qwen_train"), 2, full, QWEN_STEP,
                                "qwen2-audio-7b", QWEN_SEQ)
    _train_run(os.path.join(out_dir, "qwen_remat"), 2, full + ["--gradient_checkpointing"],
               {**QWEN_STEP, "flash_attention_causal": 56}, "qwen2-audio-7b", QWEN_SEQ)
    return counts


#: phase symbol's datasets and sample counts (BASELINE.md config 4)
SYMBOL_ARGS = ["--model_type", "salmonn-7b", "--dataset_type", "meld_emotion-sqa",
               "--val_dataset_type", "meld_emotion-sqa", "--synthetic", "--max_samples", "8",
               "--val_max_samples", "2", "--device", "cuda"]
#: the kernels' plain versions: none may run on the card
PLAIN_ROUTES = {"ops.flash_attention": (
    "flash_attention_plain", "flash_attention_bwd_plain", "flash_attention_bwd_dq_plain",
    "flash_attention_bwd_dkv_plain", "gated_bias_attention_plain", "gated_bias_rows_plain",
    "gated_bias_batched_plain", "append_kv_plain", "append_kv_q8_plain",
    "flash_decode_attention_plain"),
    "ops.int4_matmul": ("int4_matmul_plain", "int8_matmul_plain")}


def _count_plain_routes():
    """Count every call of a kernel's plain version (their wrappers call
    them by module name) → (counts, undo)."""
    import importlib

    counts, saved = {}, []
    for mod_name, names in PLAIN_ROUTES.items():
        mod = importlib.import_module(f"icl_speech_text_llm_tpu_torch.{mod_name}")
        for name in names:
            fn = getattr(mod, name)
            counts[name] = 0
            saved.append((mod, name, fn))

            def counted(*a, _name=name, _fn=fn, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)

            setattr(mod, name, counted)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return counts, undo


def _symbol_train_run(out_dir):
    """cli/symbol_train.py lora_mlp_joint at salmonn-7b full width; each
    schedule step's training launches (its validations' taken out), the
    trainable leaves it changed, and each validation's launches and
    prediction rows by mode."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import symbol_train
    from icl_speech_text_llm_tpu_torch.symbol_adapter import trainer as strainer
    from icl_speech_text_llm_tpu_torch.symbol_adapter import validation as sval

    steps, vals, rows = [], [], []
    train_step, validate = strainer.UnifiedTrainer.train_step, sval.ValidationManager.validate_model
    run_mode = sval.ValidationManager._run_mode

    def validate_counted(self, epoch=0):
        before = kernels.launch_counts()
        rows.append({})
        out = validate(self, epoch)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        vals.append({k: after[k] - before[k] for k in after})
        return out

    def run_mode_kept(self, mode, epoch, collect_predictions=False):
        out = run_mode(self, mode, epoch, collect_predictions=True)
        rows[-1][mode] = out["predictions"]
        return out

    def step_counted(self, step, dataset):
        def snap():
            return {"lora": {n: t.clone() for n, t in _paths(self.model.params["lora"]).items()},
                    "mlp": {n: t.clone() for n, t in _paths(self.mlp_params).items()}}

        before, n_val, c0 = snap(), len(vals), kernels.launch_counts()
        summary = train_step(self, step, dataset)
        torch.cuda.synchronize()
        c1, after = kernels.launch_counts(), snap()
        steps.append({
            "phase": step.phase, "summary": summary,
            "launches": {k: c1[k] - c0[k] - sum(v[k] for v in vals[n_val:]) for k in c1},
            "changed": {sub: [n for n in before[sub] if not torch.equal(before[sub][n],
                                                                          after[sub][n])]
                        for sub in before}})
        return summary

    strainer.UnifiedTrainer.train_step = step_counted
    sval.ValidationManager.validate_model = validate_counted
    sval.ValidationManager._run_mode = run_mode_kept
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        symbol_train.main(["--training_mode", "lora_mlp_joint", "--total_cycles", "1",
                           "--lora_epochs", "1", "--mlp_epochs", "1", "--batch_size", "2",
                           *SYMBOL_ARGS, "--output_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        strainer.UnifiedTrainer.train_step = train_step
        sval.ValidationManager.validate_model = validate
        sval.ValidationManager._run_mode = run_mode
    return steps, vals, rows, wall, torch.cuda.max_memory_allocated()


def _symbol_phase(out_dir):
    """BASELINE.md config 4 at full width: cli/symbol_train.py
    (lora_mlp_joint on salmonn-7b, MELD emotion + SQA, batch 2, validation
    in three modes after each epoch), then cli/symbol_inference.py on the
    joint step's checkpoint; see the module docstring."""
    import gc

    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import symbol_inference
    from icl_speech_text_llm_tpu_torch.training.checkpoint import load_checkpoint

    plain, undo = _count_plain_routes()
    try:
        kernels.reset_launch_counts()
        steps, vals, rows, wall, peak = _symbol_train_run(os.path.join(out_dir, "train"))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  symbol_train: {len(steps)} schedule steps, {len(vals)} validations, "
              f"{wall:.3f} s wall (model build included), peak {peak / 2**30:.3f} GiB",
              flush=True)
        if [s["phase"] for s in steps] != ["lora", "mlp", "joint"]:
            raise AssertionError(f"schedule {[s['phase'] for s in steps]}")
        trains = {"lora": ("lora",), "mlp": ("mlp",), "joint": ("lora", "mlp")}
        for s in steps:
            summ, perf = s["summary"], s["summary"]["perf"]
            losses = [e["loss"] for e in summ["epochs"]]
            n = perf["steps"]
            need = {k: v * n for k, v in SALMONN_7B_STEP.items()}
            print(f"  {s['phase']} step: {n} batches, final loss {summ['final_loss']:.6f}, "
                  f"{perf['avg_step_time']:.4f} s an optimizer step, "
                  f"{perf['examples_per_sec']:.4f} examples/s; launches "
                  f"{ {k: s['launches'][k] for k in need} }; changed: lora "
                  f"{len(s['changed']['lora'])}, mlp {len(s['changed']['mlp'])} leaves; "
                  f"validation {summ['epochs'][-1]['val']}", flush=True)
            if not np.all(np.isfinite(losses + [summ["final_loss"]])):
                raise AssertionError(f"{s['phase']} step: a loss is not finite")
            if any(s["launches"][k] < v for k, v in need.items()):
                raise AssertionError(f"{s['phase']} step launched too few kernels")
            for sub in ("lora", "mlp"):
                if bool(s["changed"][sub]) != (sub in trains[s["phase"]]):
                    raise AssertionError(f"{s['phase']} step: {sub} changed "
                                         f"{len(s['changed'][sub])} leaves")
        for i, v in enumerate(vals):
            if v["flash_attention_causal"] < 32 or v["append_kv"] < 1 or \
                    v["flash_attention_bwd_dq"] or v["flash_attention_bwd_dkv"]:
                raise AssertionError(f"validation {i} launches {v}")
        print(f"  validation launches (each): K1 {[v['flash_attention_causal'] for v in vals]}, "
              f"K4 {[v['append_kv'] for v in vals]}, K2 "
              f"{[v['flash_attention_noncausal'] for v in vals]}, no K5/K6", flush=True)
        ckpts = {}
        for s in steps:
            d = os.path.join(out_dir, "train", f"{s['phase']}_step{steps.index(s)}_cycle0")
            ck = load_checkpoint(d)
            meta = ck["meta"]["metadata"]
            if set(ck["trainable"]) != {"lora", "mlp_adapter"} or \
                    sorted(meta["symbol_mappings"]) != sorted(
                        ["neutral", "joy", "sadness", "anger", "fear", "disgust", "surprise"]):
                raise AssertionError(f"checkpoint {d}: {sorted(ck['trainable'])}, {meta}")
            ckpts[s["phase"]] = d
        print(f"  checkpoints: {sorted(os.path.basename(d) for d in ckpts.values())}, mappings "
              f"{meta['symbol_mappings']}", flush=True)

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        symbol_inference.main(["--checkpoint", ckpts["joint"], *SYMBOL_ARGS, "--batch_size", "1",
                               "--output_dir", os.path.join(out_dir, "infer")])
        torch.cuda.synchronize()
        infer_wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        undo()
    with open(os.path.join(out_dir, "infer", "symbol_inference_inference_results.json")) as f:
        results = json.load(f)
    last = steps[-1]["summary"]["epochs"][-1]["val"]
    for mode in ("no_mlp_symbols", "no_mlp_fresh", "no_mlp_original"):
        preds = results[mode]["predictions"]
        per = {dt: sum(p["dataset_type"] == dt for p in preds) for dt in ("meld_emotion", "sqa")}
        # SQA draws its exemplars anew at every access of a sample (the
        # reference's lookup sampling), so only MELD's prompts repeat
        same = {dt: [p for p in preds if p["dataset_type"] == dt]
                == [p for p in rows[-1][mode] if p["dataset_type"] == dt]
                for dt in ("meld_emotion", "sqa")}
        print(f"  symbol_inference {mode}: {results[mode]['composite']} (training's last "
              f"epoch: {last[mode]}); predictions per dataset {per}, rows equal to "
              f"training's last validation: {same}; predicted "
              f"{[p['predicted_label'] for p in preds]}", flush=True)
        if per != {"meld_emotion": 2, "sqa": 2}:
            raise AssertionError(f"{mode}: predictions per dataset {per}")
        if mode != "no_mlp_fresh" and (results[mode]["composite"] != last[mode]
                                       or not same["meld_emotion"]):
            raise AssertionError(f"{mode}: inference differs from training's last validation")
    print(f"  symbol_inference: {infer_wall:.3f} s wall; launches K1 "
          f"{counts['flash_attention_causal']}, K4 {counts['append_kv']}, K2 "
          f"{counts['flash_attention_noncausal']}, K3 {counts['gated_bias_attention']}, K5 "
          f"{counts['flash_attention_bwd_dq']}, K6 {counts['flash_attention_bwd_dkv']}; plain "
          f"routes on the card {sum(plain.values())}", flush=True)
    if counts["flash_attention_causal"] < 32 or counts["append_kv"] < 1 or \
            counts["flash_attention_bwd_dq"] or any(plain.values()):
        raise AssertionError(f"symbol_inference launches {counts}, plain routes {plain}")
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase util
#: the optimizer of the data-parallel step checks (``_dp_worker``). Clipping
#: to 1e-9, below AdamW's eps (1e-8), keeps its first step linear in the
#: gradient (each weight moves by about lr · g / (10 ‖g‖)), so the updated
#: leaves are a well-conditioned function of the summed gradients; above
#: eps the first step moves every weight by ±lr wherever |g| ≫ eps, and
#: rounding noise in a near-zero gradient flips it.
DP_OPT = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1e-9)
#: their limits at f32 on the CPU (``_check_dp_ranks``), ``tests/test_torch_training.py``'s
DP_LIMITS = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4, "leaves": 1e-5}
#: and on the card, where the model computes in bf16 through the kernels:
#: phase check's card bounds (loss 1e-2; gradients 5e-2 × the group's max);
#: the ranks' replicas must be bit-identical.
DP_CARD_LIMITS = {"loss": 1e-2, "grad_norm": 1e-2, "grads": 5e-2}
#: the least launches of one salmonn-7b generation batch: K2 and K3 over
#: the clips, K1 in each of the 32 decoder layers, K4 each decode step
SALMONN_7B_GENERATE = {"flash_attention_noncausal": 32, "gated_bias_attention": 12,
                       "flash_attention_causal": 32, "append_kv": 9}


def _unpaths(flat):
    """{'a.b.c': leaf} → the nested dict (``_paths``' inverse)."""
    tree = {}
    for name, leaf in flat.items():
        *parents, key = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = leaf
    return tree


def _dp_batch(cfg):
    """phase check's two-request train batch (``_train_batch``) at ``cfg``,
    row 1 keeping 1 of its 5 labels: 5 against 1 label tokens (the
    data-parallel step must weight each rank's mean loss by them)."""
    batch = _train_batch(cfg, cfg.audio_tokens_per_slot, 256)
    labels = batch["shifted_labels"]
    labels[1, (labels[1] != -100).nonzero()[0][1:]] = -100
    return batch


def _dp_model(model, out_dir, device):
    """(cfg, params) of a ``_dp_worker`` model: ``"file"`` is salmonn-tiny
    from ``out_dir/params.npz`` (f32; the CPU test's JAX weights), with
    ``out_dir/salmonn.json``'s overrides where there is one
    (``_salmonn_variant``);
    ``"salmonn-7b-1layer"`` salmonn-7b's widths, one layer per stack, bf16
    with f32 trainable weights and LoRA B non-zero, drawn from seed 2 on
    ``device`` (every process draws the same; the kernels take its shapes)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.models.salmonn import (
        init_salmonn,
        salmonn_7b,
        salmonn_tiny,
    )

    if model == "file":
        cfg = salmonn_tiny()
        variant = os.path.join(out_dir, "salmonn.json")
        if os.path.exists(variant):
            with open(variant) as f:
                cfg = _salmonn_variant(json.load(f))
        with np.load(os.path.join(out_dir, "params.npz")) as f:
            return cfg, params_from_numpy(_unpaths(dict(f)), device=device)
    cfg = _one_layer(salmonn_7b())
    if model != "salmonn-7b-1layer":  # "salmonn-7b" at full depth, or "salmonn-7b-Nlayer"
        depth = int(model.split("-")[2][:-len("layer")]) if model.count("-") == 2 else None
        cfg = salmonn_7b() if depth is None else _n_layers(salmonn_7b(), depth)
    gen = torch.Generator(device=device).manual_seed(2)
    params = init_salmonn(cfg, gen, torch.device(device), torch.bfloat16,
                          trainable_dtype=torch.float32)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=device) * 0.02
    return cfg, params


def _salmonn_variant(spec, family=None):
    """salmonn-tiny in the port's (or with ``family``, that package's)
    salmonn module, each of ``spec``'s components ("whisper", "beats",
    "llm") with its fields replaced."""
    if family is None:
        from icl_speech_text_llm_tpu_torch.models import salmonn as family
    base = family.salmonn_tiny()
    return dataclasses.replace(base, **{k: dataclasses.replace(getattr(base, k), **v)
                                        for k, v in spec.items()})


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dp_spawn(out_dir, model, params, batch, device, world=2, timeout=50, mesh=None,
              tasks=()):
    """Run ``world`` ranks of ``_dp_worker`` (gloo, one process each) on the
    ``model`` of ``_dp_model`` (``params``: the numpy tree of ``"file"``)
    and the global ``batch`` (``world`` × the rows of a rank; None: the
    inputs are in ``out_dir`` already); returns each rank's (result dict,
    {"trainable.*" / "mu.*": array}). With ``mesh`` ('dp,fsdp,tp') each
    rank runs ``tasks`` of ``MESH_TASKS`` on that mesh instead."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    if params is not None:
        np.savez(os.path.join(out_dir, "params.npz"), **_paths(params))
    if batch is not None:
        np.savez(os.path.join(out_dir, "batch.npz"), **batch)
    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    extra = [mesh, ",".join(tasks)] if mesh else []
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp_worker",
                               str(r), str(world), str(port), out_dir, device, model, *extra],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [r for r, proc in enumerate(procs) if proc.returncode != 0]
    if failed:  # every failed rank's tail: the first may only have lost a peer
        raise AssertionError("\n".join(f"dp rank {r} failed ({procs[r].returncode}):\n"
                                        f"{outs[r][-3000 // len(failed):]}" for r in failed))
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            ranks.append((res, dict(f)))
    return ranks


def _dp_worker(rank, world, port, out_dir, device, model, mesh=None, tasks=""):
    """One rank of the data-parallel step (``python3 chip_smoke.py
    --dp_worker RANK WORLD PORT DIR DEVICE MODEL [MESH TASKS]``; with a
    MESH 'dp,fsdp,tp', ``_mesh_worker``'s TASKS instead): ``_dp_model(MODEL)``,
    its rows of ``DIR/batch.npz``, over gloo (two ranks may share one card). Steps once (``DP_OPT``), then once more with a
    label past the vocabulary on the last rank alone (every rank must skip),
    gathers prediction rows and broadcasts from rank 0; writes
    ``DIR/rank{RANK}.json`` and, after the first step, the trainable leaves
    and AdamW's first moments (``trainable.*``, ``mu.*``) to
    ``DIR/rank{RANK}.npz``."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.data.packing import IGNORE_INDEX
    from icl_speech_text_llm_tpu_torch.parallel import (
        broadcast_from_main,
        gather_predictions,
        initialize_distributed,
        make_mesh,
        process_count,
        shard_indices,
        shutdown_distributed,
        sync_hosts,
    )
    from icl_speech_text_llm_tpu_torch.training.loop import local_rows
    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_step,
    )

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device=device, backend="gloo")
    if mesh:
        torch.backends.cuda.matmul.allow_tf32 = False  # as ``main`` sets it
        torch.backends.cudnn.allow_tf32 = False
        try:
            return _mesh_worker(rank, world, out_dir, device, model, mesh, tasks)
        finally:
            shutdown_distributed()
    try:
        mesh = make_mesh(dp=world, device=device)
        cfg, params = _dp_model(model, out_dir, device)
        with np.load(os.path.join(out_dir, "batch.npz")) as f:
            batch = {k: torch.as_tensor(local_rows(f[k], rank, world), device=device)
                     for k in f.files}
        opt = AdamW(OptimizerSettings(**DP_OPT))
        state, frozen = init_train_state(params, opt)
        step = make_train_step(cfg, opt, mesh=mesh)
        state, m1 = step(state, frozen, batch)
        leaves = {k: t.detach().cpu().numpy() for k, t in _paths(
            {"trainable": state.trainable, "mu": state.opt_state["mu"]}).items()}
        labels = batch["shifted_labels"].clone()
        if rank == world - 1:
            first = (labels != IGNORE_INDEX).nonzero()[0]
            labels[first[0], first[1]] = cfg.llm.vocab_size
        state, m2 = step(state, frozen, {**batch, "shifted_labels": labels})
        kept = all(np.array_equal(t.detach().cpu().numpy(), leaves[f"trainable.{k}"])
                   for k, t in _paths(state.trainable).items())
        rows = [{"rank": rank, "index": int(i), "pred": f"p{int(i)}"}
                for i in shard_indices(5, shuffle=False)]
        gathered = gather_predictions(rows)
        sent = broadcast_from_main({"rank": rank, "order": [int(i) for i in
                                                            shard_indices(7, epoch=rank)]})
        sync_hosts("dp_worker")
        res = {"world": process_count(), "loss": m1["loss"], "grad_norm": m1["grad_norm"],
               "skipped": m1["skipped_nonfinite"], "nan_loss": m2["loss"],
               "nan_skipped": m2["skipped_nonfinite"], "kept_after_nan": kept,
               "label_count": int((batch["shifted_labels"] != IGNORE_INDEX).sum()),
               "gathered": gathered, "broadcast": sent}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **leaves)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        shutdown_distributed()


def _group_max(tree, name):
    """max |x| over the leaf's group of ``tree`` ({path: array}): lora.*.a,
    lora.*.b or qformer. Some trainable gradients are zero up to rounding
    (a key bias shifts every score of a softmax row alike), so their
    updates are noise too and a leaf's own max is no scale for them
    (``tests/test_torch_training.py``)."""
    import numpy as np

    group = ("lora", name[-1]) if name.startswith("lora") else ("qformer", "")
    return max(np.abs(v).max() for n, v in tree.items()
               if n.startswith(group[0]) and n.endswith(group[1]))


def _dp_grads(mu, grad_norm):
    """The step's (reduced) gradients from AdamW's first moments after one
    update: ``mu = (1 − b1) · clip(g)``, ``clip(g) = g · max_norm / ‖g‖``
    when ‖g‖ ≥ max_norm (``DP_OPT``)."""
    scale = max(grad_norm / DP_OPT["max_grad_norm"], 1.0) / 0.1
    return {k: v * scale for k, v in mu.items()}


def _check_dp_ranks(ranks, world, want_loss, want_norm, want_leaves, want_grads, label,
                    limits=DP_LIMITS):
    """Every rank of ``_dp_spawn`` against the global batch's step: the loss
    and grad norm (relative), the gradients the ranks summed (as AdamW's
    moments hold them; × the max |g| of the leaf's group) and, where
    ``want_leaves``, the updated leaves (× the max |x| of the leaf's group),
    each within ``limits``; the ranks' replicas bit-identical, the NaN step
    skipped on every rank, every gathered row on every rank, rank 0's
    broadcast. Prints and returns the errors."""
    import numpy as np

    errs = {k: 0.0 for k in limits}
    for r, (res, arrays) in enumerate(ranks):
        if res["world"] != world or res["skipped"]:
            raise AssertionError(f"{label} rank {r}: {res}")
        errs["loss"] = max(errs["loss"], abs(res["loss"] - want_loss) / abs(want_loss))
        errs["grad_norm"] = max(errs["grad_norm"],
                                abs(res["grad_norm"] - want_norm) / abs(want_norm))
        leaves = {k[len("trainable."):]: v for k, v in arrays.items()
                  if k.startswith("trainable.")}
        grads = _dp_grads({k[len("mu."):]: v for k, v in arrays.items() if k.startswith("mu.")},
                         res["grad_norm"])
        if set(grads) != set(want_grads) or set(leaves) != set(want_grads):
            raise AssertionError(f"{label} rank {r}: leaves {sorted(leaves)}")
        if any(not np.array_equal(v, ranks[0][1][k]) for k, v in arrays.items()):
            raise AssertionError(f"{label} rank {r}: the replicas differ from rank 0's")
        for name, want in (want_leaves or {}).items():
            errs["leaves"] = max(errs["leaves"], np.abs(leaves[name] - want).max()
                                 / _group_max(want_leaves, name))
        for name, want in want_grads.items():
            errs["grads"] = max(errs["grads"], np.abs(grads[name] - want).max()
                                / _group_max(want_grads, name))
        if not (res["nan_skipped"] == 1.0 and res["kept_after_nan"]
                and not np.isfinite(res["nan_loss"])):
            raise AssertionError(f"{label} rank {r}: the NaN step was not skipped: {res}")
        got = res["gathered"]
        if len(got) != 5 + (-5) % world or {row["index"] for row in got} != set(range(5)) \
                or {row["rank"] for row in got} != set(range(world)):
            raise AssertionError(f"{label} rank {r}: gathered {got}")
        if res["broadcast"] != ranks[0][0]["broadcast"] or res["broadcast"]["rank"] != 0:
            raise AssertionError(f"{label} rank {r}: broadcast {res['broadcast']}")
    if len({res["label_count"] for res, _ in ranks}) < 2:
        raise AssertionError(f"{label}: the ranks hold the same label counts")
    print(f"  {label}: {world} ranks, label tokens "
          f"{[res['label_count'] for res, _ in ranks]}; loss {ranks[0][0]['loss']:.8f} "
          f"(full batch {want_loss:.8f}), grad norm {ranks[0][0]['grad_norm']:.8f} "
          f"({want_norm:.8f}); relative errors loss {errs['loss']:.3e}, grad norm "
          f"{errs['grad_norm']:.3e}, gradients {errs['grads']:.3e} and leaves "
          f"{errs.get('leaves', float('nan')):.3e} of their group's max; replicas "
          f"bit-identical; the NaN step skipped on every rank; "
          f"{len(ranks[0][0]['gathered'])} rows gathered on each", flush=True)
    if any(errs[k] > limits[k] for k in errs):
        raise AssertionError(f"{label}: the data-parallel step is not the full batch's: "
                             f"{errs} against {limits}")
    return errs


# ------------------------------------------------------------------ phase mesh
#: the tasks a mesh rank of ``_dp_worker`` runs, by name (``_mesh_worker``)
MESH_TASKS = {}
#: the microbatches of a mesh task's pipeline (the train CLI's default, JAX's)
PP_MICRO = 2


def _mesh_task(fn):
    MESH_TASKS[fn.__name__[len("_mt_"):]] = fn
    return fn


class _MeshRank:
    """One rank of a ``--mesh`` spawn: its mesh and shard context, the
    inputs the spawner wrote to ``out_dir`` and the outputs it returns
    (``res`` to ``rank{r}.json``, ``arrays`` to ``rank{r}.npz``)."""

    def __init__(self, rank, out_dir, device, model, mesh):
        from icl_speech_text_llm_tpu_torch.parallel.sharding import context_of

        self.rank, self.dir, self.model = rank, out_dir, model
        self.device, self.mesh, self.ctx = device, mesh, context_of(mesh)
        self.res, self.arrays, self._params = {}, {}, {}

    def npz(self, name):
        import numpy as np

        with np.load(os.path.join(self.dir, f"{name}.npz")) as f:
            return dict(f)

    def json(self, name):
        with open(os.path.join(self.dir, f"{name}.json")) as f:
            return json.load(f)

    def rows(self, arrays):
        """This rank's rows over (dp, fsdp) of a global batch, on its device."""
        import torch

        from icl_speech_text_llm_tpu_torch.parallel.sharding import batch_rows

        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch_rows(arrays, self.mesh).items()}

    def params(self, bits=None, qwen=False):
        """(cfg, this rank's blocks and pipeline stage) of
        ``_dp_model(model)``, or with ``qwen`` of ``_qwen_model``; with
        ``bits`` the LLM quantized first (its leaves then stay whole)."""
        import torch

        from icl_speech_text_llm_tpu_torch.ops.quant import quantize_decoder
        from icl_speech_text_llm_tpu_torch.parallel.sharding import shard_params, stage_params

        if (bits, qwen) not in self._params:
            cfg, params = (_qwen_model(self.json("qwen"), self.dir, self.device) if qwen
                           else _dp_model(self.model, self.dir, self.device))
            if bits:
                quantize_decoder(params["llm"], bits=bits)
            self._params[bits, qwen] = (cfg, stage_params(shard_params(params, self.mesh),
                                                          self.mesh))
            del params
            if torch.device(self.device).type == "cuda":  # the whole tree's blocks back
                torch.cuda.empty_cache()  # to the ranks that share the card
        return self._params[bits, qwen]

    @property
    def pipeline(self):
        """The train loss's ``pipeline`` on this mesh (None where pp is 1)."""
        return (self.mesh, PP_MICRO) if self.ctx.pp > 1 else None


def _global_loss(r, cfg, params, batch, loss_fn=None):
    """The token-mean loss of the global batch from this rank's rows under
    the mesh (each (dp, fsdp) coordinate's mean weighted by its label
    count), as ``training/step.py`` weighs them; through the pipeline
    where pp > 1."""
    import torch

    from icl_speech_text_llm_tpu_torch.data.packing import IGNORE_INDEX
    from icl_speech_text_llm_tpu_torch.models.salmonn import salmonn_train_loss
    from icl_speech_text_llm_tpu_torch.parallel.sharding import shard_context
    from icl_speech_text_llm_tpu_torch.training.step import _sum_over

    kw = {} if r.pipeline is None else {"pipeline": r.pipeline}
    with shard_context(r.ctx), torch.no_grad():
        loss = (loss_fn or salmonn_train_loss)(cfg, params, batch, **kw).float()
    count = (batch["shifted_labels"] != IGNORE_INDEX).sum().float()
    axes = ("fsdp", "dp")
    return (_sum_over(loss * count, r.ctx, *axes) / _sum_over(count, r.ctx, *axes)).item()


@_mesh_task
def _mt_loss(r):
    """``salmonn_train_loss`` of the global batch (``batch.npz``)."""
    cfg, params = r.params()
    return {"loss": _global_loss(r, cfg, params, r.rows(r.npz("batch")))}


@_mesh_task
def _mt_step(r, sp=False, qwen=False):
    """One train step (``DP_OPT``) on ``batch.npz``: its metrics and
    collective counts, the gathered trainable leaves and first moments
    after it; then a step with a label past the vocabulary on the last
    (dp, fsdp) coordinate's rows, which every rank must skip. Where pp > 1
    the decoder is the GPipe pipeline over ``PP_MICRO`` microbatches;
    ``sp``: the decoder sequence-parallel over the mesh's tp axis, the
    weights whole on every rank; ``qwen``: ``_qwen_model``'s
    Qwen2-Audio on ``qbatch.npz``, its arrays named ``qwen_step.*``."""
    import torch

    from icl_speech_text_llm_tpu_torch.data.packing import IGNORE_INDEX
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import qwen_audio_train_loss
    from icl_speech_text_llm_tpu_torch.models.salmonn import salmonn_train_loss
    from icl_speech_text_llm_tpu_torch.parallel import collectives
    from icl_speech_text_llm_tpu_torch.parallel.sharding import batch_shard, gather_params
    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_step,
    )

    cfg, params = _dp_model(r.model, r.dir, r.device) if sp else r.params(qwen=qwen)
    batch = r.rows(r.npz("qbatch" if qwen else "batch"))
    opt = AdamW(OptimizerSettings(**DP_OPT))
    state, frozen = init_train_state(params, opt)
    if sp:
        step = make_train_step(cfg, opt, sp=(r.mesh, "tp"))
    else:
        step = make_train_step(cfg, opt, qwen_audio_train_loss if qwen else salmonn_train_loss,
                               mesh=r.mesh, pipeline=r.pipeline)
    cuda = torch.device(r.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        process_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    collectives.reset_counts()
    t0 = time.perf_counter()
    state, m1 = step(state, frozen, batch)
    seconds = time.perf_counter() - t0
    counts = collectives.counts()
    memory = {}
    if cuda:  # the step's peak above what the rank held before it
        memory = {"held_gib": held / 2**30, "process_peak_gib": process_peak / 2**30,
                  "step_peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
    gather = (lambda t: t) if sp else (lambda t: gather_params(t, r.mesh))
    leaves = {("qwen_step." if qwen else "") + k: t.detach().float().cpu().numpy()
              for k, t in _paths({"trainable": gather(state.trainable),
                                  "mu": gather(state.opt_state["mu"])}).items()}
    r.arrays.update(leaves)
    before = [t.detach().clone() for t in _paths(state.trainable).values()]
    labels = batch["shifted_labels"].clone()
    index, n = batch_shard(r.mesh)
    if index == n - 1:
        first = (labels != IGNORE_INDEX).nonzero()[0]
        labels[first[0], first[1]] = cfg.llm.vocab_size
    state, m2 = step(state, frozen, {**batch, "shifted_labels": labels})
    kept = all(torch.equal(a, b) for a, b in zip(before, _paths(state.trainable).values()))
    return {"loss": m1["loss"], "grad_norm": m1["grad_norm"], "skipped": m1["skipped_nonfinite"],
            "nan_loss": m2["loss"], "nan_skipped": m2["skipped_nonfinite"],
            "kept_after_nan": kept, "counts": counts, "seconds": seconds,
            "label_count": int((batch["shifted_labels"] != IGNORE_INDEX).sum()), **memory}


#: the optimizer of phase mesh (f) and (g): AdamW at the train CLI's
#: learning rate without its warmup, so a second step's loss reads the first
#: update
MESH_STEP_OPT = dict(learning_rate=1e-5)


def _layer_bytes(params):
    """Bytes of the decoder's stacked layers and of the LoRA in ``params``."""
    return sum(t.numel() * t.element_size() for p, t in _paths(params).items()
               if p.startswith(("llm.layers.", "lora.")))


def _train_steps(cfg, params, batch, n, **step_kw):
    """``n`` steps of ``make_train_step(**step_kw)`` (``MESH_STEP_OPT``) from
    a fresh state on ``batch``: each step's loss (none may be skipped), the
    steps' peak GiB on the card above what was allocated before them (so a
    rank and a process holding other phases' tensors compare), the layer
    and LoRA bytes held, seconds."""
    import torch

    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_step,
    )

    opt = AdamW(OptimizerSettings(**MESH_STEP_OPT))
    state, frozen = init_train_state(params, opt)
    step = make_train_step(cfg, opt, **step_kw)
    held = _layer_bytes({**frozen, **state.trainable})
    cuda = batch["text_tokens"].device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    losses = []
    for _ in range(n):
        state, m = step(state, frozen, batch)
        if m["skipped_nonfinite"]:
            raise AssertionError(f"a step was skipped: {m}")
        losses.append(m["loss"])
    out = {"losses": losses, "seconds": time.perf_counter() - t0, "layer_bytes": held}
    if cuda:
        out["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
    return out


@_mesh_task
def _mt_train_steps(r):
    """``_train_steps`` of ``_dp_model(model)`` on ``batch.npz`` under the
    mesh (``steps.json``: the count ``n``; ``sp``: the decoder
    sequence-parallel over tp, the weights whole on every rank, and the
    hidden of ``decoder_forward(ring=)`` on the batch's sequence before the
    steps, ``steps.ring_hidden``; else the GPipe pipeline where pp > 1)."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import decoder_forward
    from icl_speech_text_llm_tpu_torch.models.salmonn import _train_sequence

    spec = r.json("steps")
    batch = r.rows(r.npz("batch"))
    if not spec.get("sp"):
        cfg, params = r.params()
        return _train_steps(cfg, params, batch, spec["n"], mesh=r.mesh, pipeline=r.pipeline)
    cfg, params = _dp_model(r.model, r.dir, r.device)
    with torch.no_grad():
        seq = _train_sequence(cfg, params, batch)
        lengths = batch["seq_mask"].sum(dim=1).to(torch.int32)
        hidden = decoder_forward(cfg.llm, params["llm"], seq, lengths, lora=params["lora"],
                                 lora_scaling=cfg.lora.scaling, ring=(r.mesh, "tp"))[0]
    r.arrays["steps.ring_hidden"] = hidden.float().cpu().numpy()
    del seq, hidden
    return _train_steps(cfg, params, batch, spec["n"], sp=(r.mesh, "tp"))


@_mesh_task
def _mt_qwen_step(r):
    """``_mt_step`` on ``_qwen_model``'s Qwen2-Audio and ``qbatch.npz``."""
    return _mt_step(r, qwen=True)


@_mesh_task
def _mt_sp_step(r):
    """``_mt_step`` with the decoder sequence-parallel over tp."""
    return _mt_step(r, sp=True)


def _decoder_inputs(r, name):
    """(config, params, lora) of a tiny decoder in ``{name}.npz``
    (``params.*``, ``lora.*``; ``{name}.json``: the config's overrides of
    ``tiny``), on the rank's device, and the npz's other arrays."""
    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.models.llama import DECODER_CONFIGS

    spec, arrays = r.json(name), r.npz(name)
    cfg = dataclasses.replace(DECODER_CONFIGS["tiny"], **spec["cfg"])
    params = params_from_numpy(_unpaths(_prefixed(arrays, "params.")), device=r.device)
    lora = params_from_numpy(_unpaths(_prefixed(arrays, "lora.")), device=r.device)
    return cfg, params, lora, spec, arrays


def _guard(fn):
    """The message of the ValueError ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@_mesh_task
def _mt_pipeline(r):
    """``pipeline_decoder_forward`` on a (dp, fsdp, tp, pp) mesh of its own
    (``pipe.json``: its sizes, the decoder's overrides of ``tiny``, the LoRA
    scaling; ``pipe.npz``: ``params.*``, ``lora.*`` whole, and x, lengths
    and w of the global batch), on the rank's rows: the hidden without
    LoRA, with it, with it under remat; the gradients of Σ hidden · w with
    respect to the rows' input and every LoRA leaf, without and with remat
    (the rank's own: the input's on stage 0, a leaf's on the stage that
    holds its layers); the layer and batch guards' messages; the
    point-to-point transfers of a forward, and of a forward and backward."""
    import torch

    from icl_speech_text_llm_tpu_torch.parallel import collectives, make_mesh
    from icl_speech_text_llm_tpu_torch.parallel.pipeline import pipeline_decoder_forward
    from icl_speech_text_llm_tpu_torch.parallel.sharding import batch_rows, batch_shard, context_of

    cfg, params, lora, spec, arrays = _decoder_inputs(r, "pipe")
    dp, fsdp, tp, pp = spec["mesh"]
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, pp=pp, device=r.device)
    rows = {k: torch.as_tensor(v, device=r.device) for k, v in batch_rows(
        {k: arrays[k] for k in ("x", "lengths", "w")}, mesh).items()}
    x, lengths, w = rows["x"], rows["lengths"], rows["w"]
    scaling = spec["scaling"]

    def forward(x, lo=None, remat=False):
        return pipeline_decoder_forward(mesh, cfg, params, x, lengths, PP_MICRO, lora=lo,
                                        lora_scaling=scaling, remat=remat)

    out = {"stage": context_of(mesh).pp_rank, "rows": list(batch_shard(mesh))}
    with torch.no_grad():
        collectives.reset_counts()
        r.arrays["pipe.plain"] = forward(x).cpu().numpy()
        out["p2p_forward"] = collectives.counts()["p2p"]
        r.arrays["pipe.lora"] = forward(x, lora).cpu().numpy()
        r.arrays["pipe.remat"] = forward(x, lora, True).cpu().numpy()
    for remat in (False, True):
        xg = x.clone().requires_grad_()
        lo = {k: {n: t.clone().requires_grad_() for n, t in sub.items()}
              for k, sub in lora.items()}
        collectives.reset_counts()
        (forward(xg, lo, remat) * w).sum().backward()
        out["p2p_step"] = collectives.counts()["p2p"]
        tag = "remat" if remat else "plain"
        for k, t in _paths({"x": xg, "lora": lo}).items():
            g = torch.zeros_like(t) if t.grad is None else t.grad
            r.arrays[f"pipe.grad_{tag}.{k}"] = g.cpu().numpy()
    with torch.no_grad():
        out["layer_guard"] = _guard(lambda: pipeline_decoder_forward(
            mesh, dataclasses.replace(cfg, n_layers=cfg.n_layers + 2), params, x, lengths,
            PP_MICRO))
        out["batch_guard"] = _guard(lambda: forward(x[:1]))
    return out


@_mesh_task
def _mt_sp(r):
    """Ring attention and the sequence-parallel decoder over the mesh's tp
    axis (``sp.npz``: a tiny decoder's ``params.*``, ``lora.*`` (``sp.json``:
    its overrides of ``tiny``, the LoRA scaling), x and lengths whole, and
    q, k, v for the ring alone): ``ring_attention`` causal with lengths and
    full without; ``decoder_forward(ring=)`` without and with remat;
    ``sp_decoder_forward`` without LoRA and with it under remat; the guard
    of a length the axis does not divide."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import decoder_forward
    from icl_speech_text_llm_tpu_torch.parallel.ring_attention import ring_attention
    from icl_speech_text_llm_tpu_torch.parallel.sequence_parallel import sp_decoder_forward

    cfg, params, lora, spec, arrays = _decoder_inputs(r, "sp")
    t = {k: torch.as_tensor(arrays[k], device=r.device)
         for k in ("x", "lengths", "q", "k", "v", "ring_lengths")}
    mesh, scaling = r.mesh, spec["scaling"]
    with torch.no_grad():
        for name, kw in (("ring_causal", dict(lengths=t["ring_lengths"], causal=True)),
                         ("ring_full", dict(causal=False))):
            r.arrays[f"sp.{name}"] = ring_attention(t["q"], t["k"], t["v"], mesh, "tp",
                                                    **kw).cpu().numpy()
        for remat in (False, True):
            r.arrays[f"sp.dec_ring_{remat}"] = decoder_forward(
                cfg, params, t["x"], t["lengths"], ring=(mesh, "tp"), remat=remat)[0].cpu().numpy()
        r.arrays["sp.sp_plain"] = sp_decoder_forward(mesh, "tp", cfg, params, t["x"],
                                                     t["lengths"]).cpu().numpy()
    # under grad, so that remat checkpoints (no_grad would run it plain)
    r.arrays["sp.sp_lora_remat"] = sp_decoder_forward(
        mesh, "tp", cfg, params, t["x"], t["lengths"], lora=lora, lora_scaling=scaling,
        remat=True).detach().cpu().numpy()
    with torch.no_grad():
        guard = _guard(lambda: sp_decoder_forward(mesh, "tp", cfg, params, t["x"][:, :-2],
                                                  t["lengths"]))
    return {"guard": guard}


@contextlib.contextmanager
def _recorded_logits(*modules):
    """Every ``lm_logits`` call the ``modules`` make inside the block, its
    output (rows, V) f32 on the host, appended to the yielded list in call
    order (gathered over tp under a mesh)."""
    seen, fn = [], modules[0].lm_logits

    def recorded(*args, **kw):
        out = fn(*args, **kw)
        seen.append(out.float().reshape(out.shape[0], -1).cpu())
        return out

    for m in modules:
        m.lm_logits = recorded
    try:
        yield seen
    finally:
        for m in modules:
            m.lm_logits = fn


@_mesh_task
def _mt_generate(r, bits=None, name="generate", qwen=False):
    """Static generation of ``gen.npz``'s rows (``gen.json``: the
    ``GenerationConfig`` keywords ``kw``), ``bits`` for a quantized LLM,
    ``qwen`` for ``_qwen_model``'s Qwen2-Audio on ``qgen.npz``:
    this rank's tokens (``{name}.tokens``), the logits that picked each of
    them (``{name}.step_logits`` (T, B, V): the prefill's, then each
    decode step's, gathered over tp), its prefill and decode-step ms (CUDA
    events; not a claim) and peak GiB."""
    import torch

    from icl_speech_text_llm_tpu_torch.inference import engine
    from icl_speech_text_llm_tpu_torch.parallel.sharding import batch_shard, shard_context

    from icl_speech_text_llm_tpu_torch.models.qwen_audio import qwen_sequence

    spec = r.json("gen")
    cfg, params = r.params(bits, qwen)
    batch = r.rows(r.npz("qgen" if qwen else "gen"))
    cuda = torch.device(r.device).type == "cuda"
    events = engine.StepEvents() if cuda else None
    with _recorded_logits(engine) as seen, shard_context(r.ctx):
        toks = engine.generate_batch(cfg, engine.GenerationConfig(**spec["kw"]), params,
                                     batch, qwen_sequence if qwen else engine.speech_sequence,
                                     events)
    r.arrays[f"{name}.tokens"] = toks.cpu().numpy()
    r.arrays[f"{name}.step_logits"] = torch.stack(seen).numpy()
    out = {"rows": list(batch_shard(r.mesh))}
    if cuda:
        torch.cuda.synchronize()
        ms = events.millis()
        out.update(prefill_ms=ms[0], step_ms=statistics.median(ms[1:]),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


@_mesh_task
def _mt_qwen_generate(r):
    """``_mt_generate`` on ``_qwen_model``'s Qwen2-Audio and ``qgen.npz``."""
    return _mt_generate(r, name="qwen_generate", qwen=True)


@_mesh_task
def _mt_generate_int8(r):
    """``_mt_generate`` with the LLM int8 (its quantized leaves whole on
    every rank)."""
    return _mt_generate(r, 8, "generate_int8")


@_mesh_task
def _mt_roundtrip(r):
    """``gather_params(shard_params(params))`` against ``params``, leaf by
    leaf, bit for bit; and each leaf's local shape."""
    import torch

    from icl_speech_text_llm_tpu_torch.parallel.sharding import gather_params, tree_paths

    _, full = _dp_model(r.model, r.dir, r.device)
    _, local = r.params()
    back = dict(tree_paths(gather_params(local, r.mesh)))
    return {"exact": all(torch.equal(back[p], t) for p, t in tree_paths(full)),
            "shapes": {p: list(t.shape) for p, t in tree_paths(local)}}


@_mesh_task
def _mt_decode(r):
    """One decode step of a decoder (``decode.npz``: ``params.*``, x,
    cur_len; ``decode.json``: its config's overrides of ``tiny`` and the
    cache length) through each route, the XLA, FLASH and GENERIC
    attention, from an empty cache: each route's final-normed hidden."""
    import torch

    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.models.llama import (
        DECODER_CONFIGS,
        DecodeAttention,
        decode_step,
        init_kv_cache,
    )
    from icl_speech_text_llm_tpu_torch.parallel.sharding import shard_context, shard_params

    spec, arrays = r.json("decode"), r.npz("decode")
    cfg = dataclasses.replace(DECODER_CONFIGS["tiny"], **spec["cfg"])
    flat = {k[len("params."):]: v for k, v in arrays.items() if k.startswith("params.")}
    params = shard_params({"llm": params_from_numpy(_unpaths(flat), device=r.device)},
                          r.mesh)["llm"]
    x = torch.as_tensor(arrays["x"], device=r.device)
    pos = torch.as_tensor(arrays["cur_len"], device=r.device)
    with shard_context(r.ctx), torch.no_grad():
        for route in DecodeAttention:
            cache = init_kv_cache(cfg, x.shape[0], spec["S"], dtype=torch.float32,
                                  device=r.device)
            out, cache = decode_step(cfg, params, x, cache, pos, attention=route)
            r.arrays[f"decode.{route.value}"] = out.cpu().numpy()
    return {"kv_heads": int(cache["k"].shape[2])}


@_mesh_task
def _mt_serve(r, name="serve"):
    """The continuous-batching engine under the mesh (``{name}.npz``:
    ``params.*`` of a decoder, requests ``req.*``, ``prefix``, and a LoRA
    bank ``bank.*`` where one is given, whole on every rank;
    ``{name}.json``: the decoder config, ``ServingConfig``, the request
    lengths, which request takes the prefix and which the beams, each
    request's adapter): each request's tokens, every logits row the
    engine decoded from (``{name}.logits`` (N, V): admissions, decode
    steps, the beam lane's prefill and steps), the rank's pool bytes and
    peak GiB."""
    import torch

    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.inference.serving import (
        ContinuousBatchingEngine,
        ServingConfig,
    )
    from icl_speech_text_llm_tpu_torch.models.llama import DECODER_CONFIGS
    from icl_speech_text_llm_tpu_torch.parallel.sharding import shard_params

    spec, arrays = r.json(name), r.npz(name)
    cfg = dataclasses.replace(DECODER_CONFIGS[spec["decoder"]], **spec.get("cfg", {}))
    dtype = getattr(torch, spec.get("dtype", "float32"))
    if "params.tok_embed" in arrays:
        params = params_from_numpy(_unpaths(_prefixed(arrays, "params.")), device=r.device,
                                   dtype=dtype)
    else:  # drawn from the spec's seed on the rank's device
        from icl_speech_text_llm_tpu_torch.models.llama import init_decoder

        params = init_decoder(cfg, torch.Generator(device=r.device).manual_seed(spec["seed"]),
                              torch.device(r.device), dtype)
    params = shard_params({"llm": params}, r.mesh)["llm"]
    bank = _serve_bank(spec, arrays, r.device, dtype)
    engine = ContinuousBatchingEngine(cfg, params, ServingConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in spec["serving"].items()}),
        lora=bank, lora_scaling=spec.get("lora_scaling", 1.0), dtype=dtype, device=r.device,
        mesh=r.mesh)
    with _recorded_logits(*_serve_logits_modules()) as seen:
        results = _serve_requests(engine, spec, arrays, r.device)
    r.arrays[f"{name}.logits"] = torch.cat(seen).numpy()
    return {"results": results,
            "pool_bytes": sum(t.numel() * t.element_size() for t in engine._cache.values()),
            **_peak(r.device)}


@_mesh_task
def _mt_serve_bank(r):
    """``_mt_serve`` of ``serve_bank.*``: a LoRA bank under the mesh."""
    return _mt_serve(r, "serve_bank")


def _prefixed(arrays, prefix):
    """{name: array} of the ``arrays`` whose names start with ``prefix``,
    the prefix dropped."""
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _serve_bank(spec, arrays, device, dtype):
    """The LoRA bank of a serving spec: ``bank.*`` arrays, or ``bank_seed``'s
    ``_lora_bank`` drawn on ``device``; None without one."""
    import torch

    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.models.llama import DECODER_CONFIGS

    if any(k.startswith("bank.") for k in arrays):
        return params_from_numpy(_unpaths(_prefixed(arrays, "bank.")), device=device,
                                 dtype=dtype)
    if "bank_seed" not in spec:
        return None
    cfg = dataclasses.replace(DECODER_CONFIGS[spec["decoder"]], **spec.get("cfg", {}))
    return _lora_bank(cfg, spec["bank_seed"], torch.device(device), dtype)


def _lora_bank(cfg, seed, device, dtype, n=2):
    """A ``stack_lora_bank`` of ``n`` adapters of ``LoraConfig()``'s rank
    and targets on decoder ``cfg``, A and B random from ``seed``."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import LoraConfig, init_lora, stack_lora_bank

    gen = torch.Generator(device=device).manual_seed(seed)
    adapters = []
    for _ in range(n):
        lo = init_lora(cfg, LoraConfig(), gen, device, dtype)
        for sub in lo.values():
            sub["b"] = (torch.randn(sub["b"].shape, generator=gen, device=device) * 0.02).to(dtype)
        adapters.append(lo)
    return stack_lora_bank(adapters)


def _serve_logits_modules():
    """The modules whose ``lm_logits`` the serving engine decodes through:
    the slot pool's, the beam lane's steps and its prefill."""
    from icl_speech_text_llm_tpu_torch.inference import beam, engine, serving

    return serving, beam, engine


def _serve_requests(engine, spec, arrays, device):
    """``serve.json``'s requests through ``engine``: the prefix registered
    first (under ``prefix_adapter``), request ``prefix_request`` on it,
    ``beam_request`` with 2 beams, request i under adapter
    ``adapters[i]`` where a bank serves; → each request's tokens in
    submission order. A request given as token ids enters as their
    embeddings (the vocab-sharded lookup under a mesh)."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import embed_tokens
    from icl_speech_text_llm_tpu_torch.parallel.sharding import shard_context

    def emb(name):
        x = torch.as_tensor(arrays[name], device=device)
        if x.is_floating_point():
            return x
        with shard_context(engine._shard), torch.no_grad():
            return embed_tokens(engine.params, x[None], dtype=engine._dtype)[0]

    adapters = spec.get("adapters", [0] * len(spec["lengths"]))
    pid = engine.register_prefix(emb("prefix"), len(arrays["prefix"]),
                                 adapter_id=spec.get("prefix_adapter", 0))
    rids = [engine.submit(emb(f"req.{i}"), n, num_beams=2 if i == spec["beam_request"] else 1,
                          prefix_id=pid if i == spec["prefix_request"] else None,
                          adapter_id=adapters[i])
            for i, n in enumerate(spec["lengths"])]
    res = engine.run()
    return [res[i] for i in rids]


def _peak(device):
    import torch

    if torch.device(device).type != "cuda":
        return {}
    torch.cuda.synchronize()
    return {"peak_gib": torch.cuda.max_memory_allocated() / 2**30}


@_mesh_task
def _mt_qwen(r):
    """Qwen2-Audio's train loss (``qwen.npz``: the params, ``qbatch.npz``;
    ``qwen.json``: the LLM config name and depth, the tower's widths) under
    the mesh: the tower whole, the decoder sharded, tied vocab-sharded
    logits."""
    from icl_speech_text_llm_tpu_torch.models import qwen_audio

    cfg, params = r.params(qwen=True)
    return {"loss": _global_loss(r, cfg, params, r.rows(r.npz("qbatch")),
                                 qwen_audio.qwen_audio_train_loss)}


def _qwen_mesh_cfg(spec, family=None):
    """The Qwen2-Audio config of ``qwen.json`` in the port's (or with
    ``family``, that package's) qwen_audio module: ``base`` (a config
    function's name, ``qwen2_audio_smoke`` by default) with ``llm`` at
    ``n_layers`` and a Whisper tower of ``tower`` widths."""
    if family is None:
        from icl_speech_text_llm_tpu_torch.models import qwen_audio as family
    base = getattr(family, spec.get("base", "qwen2_audio_smoke"))()
    llm = dataclasses.replace(base.llm, n_layers=spec["n_layers"])
    tower = dataclasses.replace(base.encoder, **spec["tower"])
    return dataclasses.replace(base, llm=llm, encoder=tower)


def _qwen_model(spec, out_dir, device):
    """(cfg, params) of ``qwen.json``'s Qwen2-Audio (``_qwen_mesh_cfg``):
    from ``out_dir/qwen.npz`` (the CPU tests' JAX weights), or where
    ``spec`` has a ``seed``, drawn from it on ``device`` in the config's
    compute dtype, the LoRA in f32 with B non-zero (every process draws the
    same)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import init_qwen_audio

    cfg = _qwen_mesh_cfg(spec)
    if "seed" not in spec:
        with np.load(os.path.join(out_dir, "qwen.npz")) as f:
            return cfg, params_from_numpy(_unpaths(dict(f)), device=device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params = init_qwen_audio(cfg, gen, torch.device(device), cfg.compute_dtype,
                             trainable_dtype=torch.float32)
    for sub in params["lora"].values():
        sub["b"] = torch.randn(sub["b"].shape, generator=gen, device=device) * 0.02
    return cfg, params



@_mesh_task
def _mt_train_cli(r):
    """cli/train.py's ``main(cli.json argv + --mesh)`` in this rank (the
    process group this worker started; ``batch.npz``, when given, is then
    scored with the trained weights); ``auto_batch`` in ``cli.json`` stubs
    the peak measure with ``(3 + 2 rank) GiB`` a row, so that the ranks'
    own verdicts differ and only their agreement gives one pick."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import train
    from icl_speech_text_llm_tpu_torch.utils import memory

    spec = r.json("cli")
    picks = []
    if spec.get("auto_batch"):
        def stub(fn, make_args, device="cuda"):
            args = make_args()
            fn(*args)
            return (3 + 2 * r.rank) * args[2]["text_tokens"].shape[0] << 30

        memory.peak_bytes = stub
        search = memory.BatchSizeOptimizer.find_optimal_batch_size

        def recorded(self, start=1):
            picks.append(search(self, start))
            return picks[-1]

        memory.BatchSizeOptimizer.find_optimal_batch_size = recorded
    cuda = torch.device(r.device).type == "cuda"
    built = {}
    if spec.get("max_steps"):  # the run's first batches only, in its data order
        import itertools

        from icl_speech_text_llm_tpu_torch.training import loop

        batches = loop.iter_batches

        def first_batches(*a, **k):
            for i, b in enumerate(itertools.islice(batches(*a, **k), spec["max_steps"])):
                if i == 0 and cuda:  # the model is built: the steps' peak from here
                    built.update(_peak(r.device))
                    torch.cuda.reset_peak_memory_stats()
                yield b

        loop.iter_batches = first_batches
    kernels.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train.main(spec["argv"])
    params = {**result.model.params, **result.state.trainable}
    held = sum(t.numel() * t.element_size() for t in _paths(params).values()
               if isinstance(t, torch.Tensor))
    out = {"losses": result.losses, "steps": result.state.step,
           "skipped": result.skipped_batches, "checkpoints": result.checkpoints,
           "picks": picks, "seconds": time.perf_counter() - t0,
           "launches": kernels.launch_counts(), "held_gib": held / 2**30}
    if cuda:  # the whole run's peak: the build's before the first batch
        step = _peak(r.device)["peak_gib"]
        out.update(step_peak_gib=step, peak_gib=max(step, built.get("peak_gib", step)))
    if os.path.exists(os.path.join(r.dir, "batch.npz")):
        out["loss_after"] = _global_loss(r, result.model.cfg, params, r.rows(r.npz("batch")),
                                         result.model.loss_fn)
    return out


#: the attention ops the model code calls, by module: the kernels K1/K2
#: (``flash_attention``), K3 and K9 take q (B, H, T, hd)
HEAD_OPS = {"llama": ("flash_attention",), "whisper": ("flash_attention",),
            "beats": ("flash_attention", "gated_bias_attention", "gated_bias_attention_rows")}


@contextlib.contextmanager
def _recorded_heads():
    """The head counts (q's dim 1) of every ``HEAD_OPS`` call the model
    code makes inside the block: {"module.op": set of H}."""
    import importlib

    seen, saved = {}, []
    for mod_name, names in HEAD_OPS.items():
        mod = importlib.import_module(f"icl_speech_text_llm_tpu_torch.models.{mod_name}")
        for name in names:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def recorded(q, *a, _key=f"{mod_name}.{name}", _fn=fn, **kw):
                seen.setdefault(_key, set()).add(int(q.shape[1]))
                return _fn(q, *a, **kw)

            setattr(mod, name, recorded)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _mesh_worker(rank, world, out_dir, device, model, mesh_spec, tasks):
    """The ``--dp_worker`` rank of a ``--mesh`` spawn: the (dp, fsdp, tp)
    mesh of ``mesh_spec`` over the gloo group, then each of ``tasks``
    (``MESH_TASKS``) in order; writes ``rank{r}.json`` (each task's result,
    seconds, kernel launches and attention head counts (``_recorded_heads``),
    the rank's coordinates and the collectives' transport) and
    ``rank{r}.npz``."""
    import numpy as np

    from icl_speech_text_llm_tpu_torch.parallel import collectives, make_mesh, parse_mesh

    from icl_speech_text_llm_tpu_torch import kernels

    dp, fsdp, tp, pp = parse_mesh(mesh_spec)
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, pp=pp, device=device)
    r = _MeshRank(rank, out_dir, device, model, mesh)
    r.res.update(world=world, ranks=r.ctx.ranks,
                 transport=collectives.transport(r.ctx.groups["tp"], device))
    plain, undo = _count_plain_routes()
    try:
        for task in tasks.split(","):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with _recorded_heads() as heads:
                r.res[task] = MESH_TASKS[task](r)
            r.res[task + "_seconds"] = time.perf_counter() - t0
            r.res[task + "_launches"] = kernels.launch_counts()
            r.res[task + "_heads"] = {k: sorted(v) for k, v in heads.items()}
    finally:
        undo()
    r.res["plain"] = plain
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **r.arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(r.res, f)


def _train_worker(out_json, argv):
    """``python3 chip_smoke.py --train_worker OUT.json ARGV...``: cli/train.py's
    ``main(ARGV)`` in this process (TF32 off, as ``main`` sets it; launched
    by ``torch.distributed.run`` in phase util); rank 0 writes the losses,
    the run's kernel launches and its calls of a kernel's plain version."""
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain, undo = _count_plain_routes()
    kernels.reset_launch_counts()
    try:
        result = train.main(argv)
    finally:
        undo()
    if int(os.environ.get("RANK", 0)) == 0:
        with open(out_json, "w") as f:
            json.dump({"losses": result.losses, "steps": result.state.step,
                       "skipped": result.skipped_batches,
                       "launches": kernels.launch_counts(), "plain": plain}, f)


#: the largest batch size phase util's searches try
UTIL_MAX_BATCH = 16


def _util_generate_probe():
    """(model, fn, make_args) of the inference CLI's --auto_batch probe on
    phase main's first voxceleb request at salmonn-7b (k = 5 speech
    exemplars, packed to 1024 / 448)."""
    from icl_speech_text_llm_tpu_torch.cli.inference import generation_probe
    from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
    from icl_speech_text_llm_tpu_torch.models.factory import create_model
    from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType

    model = create_model("salmonn-7b", seed=42, device="cuda")
    dataset = create_dataset(
        DatasetType.VOXCELEB, split=DatasetSplit.TEST, input_mode="speech_only",
        fewshot_mode="speech", num_examples=5, is_training=False, max_samples=8,
        synthetic=True, synthetic_size=32, seed=42)
    pack_cfg = dataclasses.replace(model.pack_cfg, seq_len=1024, text_len=448, max_slots=6)
    return (model, *generation_probe(model, dataset[0], pack_cfg))


def _util_inference_search(smi):
    """(a) BatchSizeOptimizer over salmonn-7b's generation of phase main's
    request, each probed size's measured peak printed (every size up to
    ``UTIL_MAX_BATCH`` must fit); a second search, from half that size,
    with the budget halfway between the peaks of the two must pick the
    lower of the two sizes the budget falls between. Returns (numbers
    printed, model, fn, make_args)."""
    from icl_speech_text_llm_tpu_torch.utils import memory

    top = UTIL_MAX_BATCH
    model, fn, make_args = _util_generate_probe()
    out = {}
    for label in ("search", "search at a set budget"):
        probed = []

        def measure(bs):
            t0 = time.perf_counter()
            need = memory.peak_bytes(fn, lambda: make_args(bs))
            probed.append((bs, need, time.perf_counter() - t0))
            return need

        budget, start = None, 1
        if "peaks" in out:
            budget, start = (out["peaks"][top // 2] + out["peaks"][top]) // 2, top // 2
        sizer = memory.BatchSizeOptimizer(fn, make_args, memory_budget_bytes=budget,
                                          max_batch=top, measure=measure)
        pick = sizer.find_optimal_batch_size(start)
        print(f"  (a) {label}: budget {sizer.budget / 2**30:.3f} GiB, probed "
              + ", ".join(f"{bs}: {'OOM' if need is None else f'{need / 2**30:.3f} GiB'} "
                          f"({sec:.2f} s)" for bs, need, sec in probed)
              + f" → pick {pick}  [{smi}]", flush=True)
        need = {bs: n for bs, n, _ in probed}
        if "peaks" not in out:
            want = [1 << i for i in range(top.bit_length())]
            if list(need) != want or pick != top:
                raise AssertionError(f"expected every size of {want} to fit, probed {probed}")
            out.update(peaks=need, pick=pick, budget_gib=sizer.budget / 2**30)
        else:
            if not (top // 2 <= pick < top and need[pick] <= sizer.budget < need[pick + 1]):
                raise AssertionError(f"pick {pick} is not the lower size around the budget "
                                     f"{sizer.budget}: {probed}")
            out["pick_at_budget"] = pick
    return out, model, fn, make_args


def _util_trace(out_dir, model, fn, make_args):
    """(f) one generation of one request under ``utils/perf.py:torch_profile``:
    one Chrome trace, which must name K1's kernel."""
    import torch

    from icl_speech_text_llm_tpu_torch.utils.perf import torch_profile

    trace_dir = os.path.join(out_dir, "trace")
    with torch.inference_mode():
        _, batch = make_args(1)
        with torch_profile(trace_dir):
            fn(model.params, batch)
            torch.cuda.synchronize()
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(traces[0]) as f:
        text = f.read()
    n_k1 = text.count("flash_fwd_wgmma_kernel")
    print(f"  (f) torch_profile: {len(traces)} trace, {len(text) / 2**20:.1f} MiB, {n_k1} "
          f"mentions of flash_fwd_wgmma_kernel (K1/K2)", flush=True)
    if len(traces) != 1 or not n_k1:
        raise AssertionError(f"the trace {traces} does not name K1's kernel")
    return {"trace_mib": len(text) / 2**20, "k1_mentions": n_k1}


def _util_inference_cli(out_dir, pick):
    """(a) cli/inference.py --auto_batch on phase main's 8 requests at
    salmonn-7b: it must run them at the size the search picked."""
    _, paths = _main_run(os.path.join(out_dir, "auto"), "salmonn-7b",
                         ["--auto_batch", "--auto_batch_max", str(UTIL_MAX_BATCH)], 8,
                         SALMONN_7B_GENERATE)
    with open(paths["metrics"]) as f:
        batches = json.load(f)["perf"]["batches"]
    print(f"  (a) cli/inference.py --auto_batch --auto_batch_max {UTIL_MAX_BATCH}: {batches} "
          f"batch(es) for 8 requests (the search's pick {pick})", flush=True)
    if batches != -(-8 // pick):
        raise AssertionError(f"the CLI ran {batches} batches, not at batch size {pick}")
    return batches


def _util_train_search(out_dir, smi):
    """(b) cli/train.py --auto_batch at salmonn-7b, no remat, phase train's
    1024 / 448 and 16 requests: a probe runs out of memory and is caught,
    the search leaves the trainable leaves and the AdamW moments
    bit-identical, and the pick trains (finite losses)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.cli import train
    from icl_speech_text_llm_tpu_torch.utils import memory

    cls = memory.BatchSizeOptimizer
    measure, search = cls._peak_bytes, cls.find_optimal_batch_size
    probed, held = [], {}

    def recorded(self, bs):
        t0 = time.perf_counter()
        need = measure(self, bs)
        probed.append((bs, need, time.perf_counter() - t0))
        return need

    def state_leaves(self, start):
        state = self.make_args(start)[0]
        return {k: t.detach().cpu().clone() for k, t in _paths(
            {"trainable": state.trainable, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}).items()}

    def checked(self, start=1):
        before = state_leaves(self, start)
        pick = search(self, start)
        after = state_leaves(self, start)
        held["leaves"] = len(before)
        held["identical"] = all(torch.equal(after[k], v) for k, v in before.items())
        return pick

    cls._peak_bytes, cls.find_optimal_batch_size = recorded, checked
    plain, undo = _count_plain_routes()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        result = train.main(_train_argv(os.path.join(out_dir, "train_auto"), 4, [
            "--auto_batch", "--auto_batch_max", str(UTIL_MAX_BATCH)]))
    finally:
        cls._peak_bytes, cls.find_optimal_batch_size = measure, search
        undo()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    perf = result.perf
    pick = perf["examples"] // max(perf["steps"], 1)
    print(f"  (b) cli/train.py --auto_batch --auto_batch_max {UTIL_MAX_BATCH} (salmonn-7b, no "
          f"remat, 1024 / 448, 16 requests): probed "
          + ", ".join(f"{bs}: {'OOM' if need is None else f'{need / 2**30:.3f} GiB'} "
                      f"({sec:.2f} s)" for bs, need, sec in probed)
          + f" → pick {pick}; {held.get('leaves')} leaves of the trainable tree and its "
          f"moments bit-identical after the search: {held.get('identical')}; trained "
          f"{result.state.step} steps, losses {[round(x, 4) for x in result.losses]}, "
          f"median step {perf['p50_step_seconds']:.4f} s, {perf['examples_per_sec']:.4f} "
          f"examples/s; run {wall:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{smi}]", flush=True)
    if not any(need is None for _, need, _ in probed):
        raise AssertionError(f"no probe ran out of memory: {probed}")
    if not held.get("identical"):
        raise AssertionError("the batch-size search changed the trainable state")
    if result.skipped_batches or not result.losses or not all(np.isfinite(result.losses)) \
            or result.state.step != -(-16 // pick):
        raise AssertionError(f"the picked size {pick} did not train: {result.losses}")
    if sum(plain.values()):
        raise AssertionError(f"a kernel's plain version ran on the card: {plain}")
    for name, n in SALMONN_7B_STEP.items():
        if counts[name] < n * result.state.step:
            raise AssertionError(f"{name} launched {counts[name]} times")
    del result
    torch.cuda.empty_cache()
    return {"probed": probed, "pick": pick}


def _util_dp_one(out_dir, smi, train_losses):
    """(c) --mesh 1 under ``torch.distributed.run --nproc_per_node=1`` (a
    group of one over NCCL) with the arguments of phase train's first run:
    the same losses, bit for bit, and no plain kernel version called."""
    out_json = os.path.join(out_dir, "mesh1.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.abspath(__file__), "--train_worker", out_json,
           *_train_argv(os.path.join(out_dir, "mesh1"), 4, ["--mesh", "1"])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"--mesh 1 under torch.distributed.run failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    with open(out_json) as f:
        res = json.load(f)
    print(f"  (c) --mesh 1, one NCCL rank under torch.distributed.run: {res['steps']} steps, "
          f"losses {res['losses']} against phase train's {train_losses}; launches "
          f"{ {k: res['launches'][k] for k in SALMONN_7B_STEP} }; {wall:.1f} s with the "
          f"process start  [{smi}]", flush=True)
    if res["losses"] != train_losses or res["skipped"] or res["steps"] != 4:
        raise AssertionError("--mesh 1 did not reproduce phase train's losses")
    if sum(res["plain"].values()):
        raise AssertionError(f"a kernel's plain version ran on the card: {res['plain']}")
    for name, n in SALMONN_7B_STEP.items():
        if res["launches"][name] < 4 * n:
            raise AssertionError(f"--mesh 1 launched {name} {res['launches'][name]} times")
    return res


def _util_dp_two(out_dir, smi):
    """(d) two data-parallel ranks on the one card over gloo: salmonn-7b's
    widths with one layer per stack (``_dp_model``; salmonn-tiny's head dims
    16 and 32 are not the kernels'), phase check's two requests with 5 and 1
    label tokens. Their step must be one process's full-batch step on the
    card within ``DP_CARD_LIMITS``, and the mean of the two requests' own
    gradients (plain DDP averaging) must not be."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_probe,
        make_train_step,
    )

    model = "salmonn-7b-1layer"
    cfg, params = _dp_model(model, out_dir, "cuda")
    batch = _dp_batch(cfg)
    t0 = time.perf_counter()
    ranks = _dp_spawn(os.path.join(out_dir, "dp2"), model, None, batch, "cuda", timeout=240)
    wall = time.perf_counter() - t0
    opt = AdamW(OptimizerSettings(**DP_OPT))
    state, frozen = init_train_state(params, opt)
    probe = make_train_probe(cfg)

    def grads_of(rows):
        _, g = probe(state, frozen, {k: torch.as_tensor(v[rows], device="cuda")
                                     for k, v in batch.items()})
        return dict(zip(_paths(state.trainable), (t.float().cpu().numpy() for t in g)))

    want = grads_of(slice(0, 2))
    one, two = grads_of(slice(0, 1)), grads_of(slice(1, 2))
    plain_ddp = max(np.abs((one[k] + two[k]) / 2 - want[k]).max() / _group_max(want, k)
                    for k in want)
    state, m = make_train_step(cfg, opt)(
        state, frozen, {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()})
    errs = _check_dp_ranks(ranks, 2, m["loss"], m["grad_norm"], None, want,
                           f"(d) two gloo ranks on the card, salmonn-7b widths, one layer a "
                           f"stack ({wall:.1f} s)  [{smi}]", DP_CARD_LIMITS)
    print(f"  (d) the mean of the two requests' own gradients (plain DDP) is "
          f"{plain_ddp:.3e} of the group's max away (limit {DP_CARD_LIMITS['grads']})",
          flush=True)
    if plain_ddp <= DP_CARD_LIMITS["grads"]:
        raise AssertionError("the card check cannot tell the global step from plain DDP")
    del params, state, frozen
    torch.cuda.empty_cache()
    return {**errs, "plain_ddp": plain_ddp}


def _util_retrieval(smi, n=6000, k=10):
    """(e) ``topk_similar`` on the card over a 6000 × 512 hashed pool of
    voxceleb-like texts (train→train, each text's own row excluded): the
    CPU version's indices; its time (CUDA events, median of 10)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.data.fewshot_retrieval import (
        HashedNGramEmbedder,
        topk_similar,
    )

    rng = np.random.RandomState(0)
    words = ["positive", "negative", "neutral", "the", "speaker", "says", "that", "movie",
             "was", "great", "terrible", "fine", "really", "not", "quite", "good", "bad"]
    texts = [" ".join(rng.choice(words, rng.randint(3, 12))) for _ in range(n)]
    t0 = time.perf_counter()
    emb = HashedNGramEmbedder()(texts)
    embed_s = time.perf_counter() - t0
    exclude = np.arange(n)
    cpu = topk_similar(emb, emb, k, exclude, device="cpu")
    card = topk_similar(emb, emb, k, exclude, device="cuda")
    ms = _time_ms(lambda: topk_similar(emb, emb, k, exclude, device="cuda"))
    diff = int((cpu != card).any(axis=1).sum())
    dup = n - len(set(texts))
    print(f"  (e) topk_similar {n} × 512, k = {k}, own row excluded: {ms:.3f} ms on the "
          f"card (host copies in and out included; embedding {embed_s:.2f} s on the host); "
          f"{diff} rows differ from the CPU's indices; {dup} repeated texts  [{smi}]",
          flush=True)
    if diff:
        raise AssertionError(f"topk_similar on the card differs from the CPU in {diff} rows")
    return {"ms": ms, "rows": n}


def _util_phase(out_dir, train_losses, smi):
    """Phase util: the last single-card entry points and data parallelism,
    (a)-(f) as the module docstring lists them."""
    import torch

    a, model, fn, make_args = _util_inference_search(smi)
    f = _util_trace(out_dir, model, fn, make_args)
    del model, fn, make_args
    torch.cuda.empty_cache()
    a["cli_batches"] = _util_inference_cli(out_dir, a["pick"])
    b = _util_train_search(out_dir, smi)
    c = _util_dp_one(out_dir, smi, train_losses)
    d = _util_dp_two(out_dir, smi)
    e = _util_retrieval(smi)
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f}


#: phase mesh's bf16 token tolerance: a sharded run's tokens must equal the
#: one-process run's up to the first generated position whose top-1/top-2
#: logit gap, read from one teacher-forced forward of the one-process model,
#: is under it (a near tie that bf16 rounding may flip)
MESH_TAU = 0.1
#: phase mesh (e)'s limits against one process's step on the card: the loss
#: to 1e-3 relative; the grad norm and the gradients to phase util (d)'s
#: card limits (``DP_CARD_LIMITS``). Both runs compute in bf16, and the
#: sharded one rounds other partial products (the Q-Former's gradient too:
#: it flows back through every sharded layer). PERF.md (PR 17) has the
#: readings the gradients' 5e-2 sits between: a sound step ~1.1e-2, one
#: whose tp-replicated LoRA factors miss their sum over tp far above it
MESH_CARD_LIMITS = {"loss": 1e-3, "grad_norm": DP_CARD_LIMITS["grad_norm"],
                    "grads": DP_CARD_LIMITS["grads"]}
#: and against the same step in f32 on the host: the sharded bf16 step's
#: gradients no farther from it than this many times one process's
MESH_ROUNDING = 2.0
#: phase train's first run's peak on an H100 80GB HBM3 at 700 W (batch 4,
#: no remat: its step's, the weights held whole). An fsdp = 2 rank holds
#: half the weights and steps half the rows, so (d) holds its steps' peak
#: under half of it plus ``FSDP_SLACK_GIB``: the layer in hand gathered
#: whole (0.39 GiB at 7B), transient copies of a gather and the allocator's
#: rounding. A rank that kept every gathered layer for the backward (13
#: GiB more) or held the weights whole (7 GiB more) would not fit.
TRAIN_PEAK_GIB = 34.245
FSDP_SLACK_GIB = 2.0


def mesh_step_counts(cfg, sizes):
    """Collective calls of one SALMONN train step on mesh ``sizes`` (dp,
    fsdp, tp) by family, from the layer code: under tp the forward sums the
    embedding lookup, every row-parallel product (Whisper's and BEATs' 2 a
    layer, the decoder's wo and w_down) and the vocab-parallel CE's max,
    denominator and label logit; the backward sums the two column-block
    inputs of every decoder layer, its tp-replicated LoRA factors (one a
    target) and the LM head's input; the step sums the non-finite flag over
    tp. The label count and the gradients are summed over dp (a group of
    one too), and over fsdp where it is > 1: there FSDP gathers each
    layer's 7 decoder matrices, its LoRA A's and the encoders' 6 matrices
    a layer, gathers the 7 decoder matrices again in the backward (their
    shards are what it keeps), reduce-scatters the LoRA A gradients, and
    sums those over dp in a buffer of their own. The norm, taken once for
    the metric and the clip, sums each cut group's squares over its axis.
    A model on the split-head path (tp does not divide its heads, or the
    decoder's KV heads: ``ShardContext.split_heads``) all-gathers its q/k/v
    column blocks once a layer in the forward; the decoder's layers
    reduce-scatter that gather's gradient once each in the backward (the
    encoders run without grad). Qwen2-Audio's tower is whole (no rule
    matches it) and adds nothing, and its frozen projector leaves the
    decoder's input without grad, so the first layer's attention input
    sums nothing in the backward. No remat (a checkpointed layer gathers
    anew in its recompute); no pipeline, so no point-to-point transfer."""
    _, fsdp, tp = sizes
    llm, Ll = cfg.llm, cfg.llm.n_layers
    encoders = [m for m in (getattr(cfg, "whisper", None), getattr(cfg, "beats", None)) if m]
    Le = sum(m.n_layers for m in encoders)
    n_lora = len(cfg.lora.targets)

    def split(*heads):
        return tp > 1 and any(n % tp for n in heads)

    ar = 0
    if tp > 1:
        ar += 1 + 2 * Le + 2 * Ll + 3  # forward
        ar += Ll * (2 + n_lora) + 1 - (not hasattr(cfg, "qformer"))  # backward
        ar += 1  # the non-finite flag
    ar += 2 * (fsdp > 1) + 2 + (fsdp > 1)  # count, gradients (over dp always)
    ar += (fsdp > 1) + (tp > 1)  # the norm
    ag = (fsdp > 1) * (Ll * (7 + n_lora + 7) + 6 * Le)
    rs = (fsdp > 1) * Ll * n_lora
    split_llm = split(llm.n_heads, llm.n_kv_heads)
    ag += sum(m.n_layers for m in encoders if split(m.n_heads)) + Ll * split_llm
    rs += Ll * split_llm
    return {"all_reduce": ar, "all_gather": ag, "reduce_scatter": rs, "p2p": 0}


def _mesh_gen_batch(cfg, n=4):
    """phase main's voxceleb requests (k = 5 speech exemplars, seed 42),
    the first ``n``, packed to 1024 / 448."""
    from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
    from icl_speech_text_llm_tpu_torch.data.factory import create_dataset
    from icl_speech_text_llm_tpu_torch.data.packing import PackConfig
    from icl_speech_text_llm_tpu_torch.registry import DatasetSplit, DatasetType
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    ds = create_dataset(DatasetType.VOXCELEB, split=DatasetSplit.TEST,
                        input_mode="speech_only", fewshot_mode="speech", num_examples=5,
                        is_training=False, max_samples=n, synthetic=True, synthetic_size=32,
                        seed=42, prompt_style="salmonn")
    pack = PackConfig(seq_len=1024, text_len=448, max_slots=6,
                      audio_tokens_per_slot=cfg.audio_tokens_per_slot)
    p = collate_icl_batch([ds[i] for i in range(n)], get_tokenizer(None), pack)
    return {"text_tokens": p.text_tokens, "gather_idx": p.gather_idx,
            "seq_lengths": p.seq_lengths, "wavs": p.audio["wavs"]}


def _teacher_gaps(llm_cfg, llm, prompts, tokens, lora, scaling, dt):
    """The top-1 − top-2 gap of ``_teacher_logits`` at every generated
    position, (B, T) numpy."""
    import numpy as np

    top = _teacher_logits(llm_cfg, llm, prompts, tokens, lora, scaling, dt).topk(2, dim=-1)
    return (top.values[..., 0] - top.values[..., 1]).numpy().astype(np.float64)


def _teacher_logits(llm_cfg, llm, prompts, tokens, lora, scaling, dt):
    """The one-process model fed each prompt (n_b, D) then the tokens (B, T)
    (teacher forcing): the logits that pick each token, (B, T, V) f32 on
    the host."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import decoder_forward, embed_tokens, lm_logits

    B, T = tokens.shape
    D = prompts[0].shape[-1]
    lengths = [p.shape[0] for p in prompts]
    L = -(-(max(lengths) + T) // 128) * 128
    dev = prompts[0].device
    full = torch.zeros((B, L, D), dtype=dt, device=dev)
    emb = embed_tokens(llm, tokens.long().to(dev), dtype=dt)
    for b, p in enumerate(prompts):
        full[b, :lengths[b]] = p.to(dt)
        full[b, lengths[b]:lengths[b] + T] = emb[b]
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        hidden, _ = decoder_forward(llm_cfg, llm, full, n + T, lora=lora, lora_scaling=scaling)
        idx = n.long()[:, None] - 1 + torch.arange(T, device=dev)
        logits = lm_logits(llm_cfg, llm, hidden[torch.arange(B, device=dev)[:, None], idx])
    return logits.float().cpu()


def _gap_rule(label, got, want, gaps, tau=MESH_TAU):
    """Rows of ``got`` equal ``want`` up to the first position whose gap is
    under ``tau``; prints and returns the positions each row was compared
    over."""
    import numpy as np

    compared, equal = [], []
    for b, (g, w) in enumerate(zip(got, want)):
        low = np.nonzero(np.asarray(gaps[b][:len(w)]) < tau)[0]
        n = int(low[0]) if len(low) else len(w)
        if list(g[:n]) != list(w[:n]):
            raise AssertionError(f"{label} row {b}: {list(g)} against one process's {list(w)} "
                                 f"before its first gap under {tau} (position {n}; gaps "
                                 f"{np.round(gaps[b], 4).tolist()})")
        compared.append(n)
        same = [int(x) == int(y) for x, y in zip(g, w)] + [False]
        equal.append(same.index(False))
    print(f"  {label}: tokens equal to one process's over {compared} positions of "
          f"{[len(w) for w in want]} (up to each row's first top-1/top-2 gap under "
          f"tau = {tau}; first gaps {[round(float(g[0]), 4) for g in gaps]}); equal in "
          f"fact over the first {equal}", flush=True)
    return compared


def _need_launches(label, launches, need, plain):
    """A rank's kernel launches at least ``need``; no plain version ran."""
    short = {k: launches[k] for k, n in need.items() if launches[k] < n}
    if short or sum(plain.values()):
        raise AssertionError(f"{label}: launches {short} under {need}, or a kernel's plain "
                             f"version ran on the card: { {k: v for k, v in plain.items() if v} }")


def _mesh_static(d, smi):
    """(a) tp = 2 static generation at salmonn-7b bf16 (K7 on 16 of the 32
    heads a rank) against one process: the logits that picked each rank's
    every token against the one-process model teacher-forced on those
    tokens, and the tokens by ``_gap_rule``; (b) GENERIC in one process,
    its bf16 tokens against FLASH's and its int8-cache step against the
    plain version of its append."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.inference.engine import (
        GenerationConfig,
        generate_batch,
        prefill,
        speech_sequence,
    )
    from icl_speech_text_llm_tpu_torch.models import llama
    from icl_speech_text_llm_tpu_torch.models.llama import DecodeAttention, embed_tokens
    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    model = "salmonn-7b"
    cfg, params = _dp_model(model, d, "cuda")
    arrays = _mesh_gen_batch(cfg)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()}
    kw = dict(max_new_tokens=10, eos_token_id=2, pad_token_id=0, use_flash_decode=True)
    llm, lora, scaling, dt = params["llm"], params["lora"], cfg.lora.scaling, cfg.compute_dtype
    with torch.inference_mode():
        want = generate_batch(cfg, GenerationConfig(**kw), params, batch, speech_sequence)
        seq = speech_sequence(cfg, params, batch)
    lengths = arrays["seq_lengths"]
    prompts = [seq[b, :lengths[b]] for b in range(len(lengths))]
    gaps = _teacher_gaps(cfg.llm, llm, prompts, want, lora, scaling, dt)
    want = want.cpu().numpy()

    # (b) GENERIC: every layer appends before it attends (K4 a layer)
    generic = _checked_launches(
        "(b) GENERIC bf16 cache, 9 decode steps", lambda: generate_batch(
            cfg, GenerationConfig(**{**kw, "use_flash_decode": False}), params, batch,
            speech_sequence), {"append_kv": 9 * cfg.llm.n_layers},
        ("flash_decode_attention", "append_kv_q8"))
    _gap_rule("(b) GENERIC against FLASH, one process", generic.cpu().numpy(), want, gaps)
    with torch.inference_mode():
        logits, cache = prefill(cfg.llm, llm, seq, batch["seq_lengths"].int(),
                                seq.shape[1] + 128, lora, scaling, dt, kv_int8=True)
        emb = embed_tokens(llm, logits.argmax(-1)[:, None], dtype=dt)
        pos = batch["seq_lengths"].int()
        kernel_cache = {k: v.clone() for k, v in cache.items()}
        out = _checked_launches("(b) GENERIC int8 cache, one decode step", lambda: llama.decode_step(
            cfg.llm, llm, emb, kernel_cache, pos, lora, scaling, DecodeAttention.GENERIC),
            {"append_kv_q8": cfg.llm.n_layers}, ("append_kv",))[0]
        llama.append_kv_q8 = fa.append_kv_q8_plain
        try:
            ref, ref_cache = llama.decode_step(cfg.llm, llm, emb, cache, pos, lora, scaling,
                                               DecodeAttention.GENERIC)
        finally:
            llama.append_kv_q8 = fa.append_kv_q8
    err = (out.float() - ref.float()).abs().max().item()
    same = all(torch.equal(kernel_cache[k], ref_cache[k]) for k in cache)
    print(f"  (b) GENERIC int8 step through K4 q8 against its plain version on the card: "
          f"hidden max_abs_err {err:.3e} (tolerance 0: the append is bit for bit), caches "
          f"{'identical' if same else 'DIFFER'}  [{smi}]", flush=True)
    if err or not same:
        raise AssertionError("(b) the GENERIC int8 step differs from its plain version")
    del cache, kernel_cache, ref_cache, out, ref, batch
    torch.cuda.empty_cache()

    # (a) two tp ranks on the one card, the one-process model kept for the
    # teacher-forced check
    out_dir = os.path.join(d, "static")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "gen.npz"), **arrays)
    with open(os.path.join(out_dir, "gen.json"), "w") as f:
        json.dump({"kw": kw}, f)
    t0 = time.perf_counter()
    ranks = _dp_spawn(out_dir, model, None, None, "cuda", world=2, timeout=300, mesh="1,1,2",
                      tasks=("generate",))
    wall = time.perf_counter() - t0
    for r, (res, got) in enumerate(ranks):
        _need_launches(f"(a) rank {r}", res["generate_launches"],
                       {"flash_decode_attention": 9 * cfg.llm.n_layers,
                        "flash_attention_causal": cfg.llm.n_layers,
                        "flash_attention_noncausal": cfg.whisper.n_layers,
                        "gated_bias_attention": cfg.beats.n_layers}, res["plain"])
        steps = torch.as_tensor(got["generate.step_logits"])  # (T, B, V)
        ref = _teacher_logits(cfg.llm, llm, prompts, torch.as_tensor(got["generate.tokens"]),
                              lora, scaling, dt).transpose(0, 1)
        errs = (steps - ref).abs().amax(dim=(1, 2))
        tols = 5e-2 * ref.abs().amax(dim=(1, 2))
        g = res["generate"]
        print(f"  (a) rank {r} of tp = 2 (16 of 32 heads, K7 on them): the logits that picked "
              f"each token (prefill, then 9 decode steps) against one process teacher-forced "
              f"on them: max_abs_err {[round(e, 4) for e in errs.tolist()]} (tolerance 5% of "
              f"max |logit|: {[round(t, 4) for t in tols.tolist()]}); prefill "
              f"{g['prefill_ms']:.1f} ms, decode step {g['step_ms']:.2f} ms (median; not a "
              f"claim), peak {g['peak_gib']:.3f} GiB; transport {res['transport']}  [{smi}]",
              flush=True)
        if bool((errs > tols).any()):
            raise AssertionError(f"(a) rank {r}: step logits off by {errs.tolist()}")
        _gap_rule(f"(a) rank {r}, tp = 2", got["generate.tokens"], want, gaps)
        if not np.array_equal(got["generate.tokens"], ranks[0][1]["generate.tokens"]):
            raise AssertionError(f"(a) rank {r}'s tokens are not rank 0's")
    print(f"  (a) two ranks, the same tokens on both: {wall:.1f} s with the process starts "
          f"({ranks[0][0]['generate_seconds']:.1f} s of model build and generation)",
          flush=True)
    del params, llm, lora, seq, prompts
    torch.cuda.empty_cache()


def _mesh_serve(d, smi, depth=8, bank=False):
    """(c) the continuous-batching engine at tp = 2: salmonn-13b's decoder
    (vicuna-13b widths, ``depth`` layers) in bf16, 4 slots, int8 KV pool on
    20 of 40 KV heads a rank (K4 q8, K7 q8), a registered prefix and a
    2-beam request, against the one-process engine (run first): every
    token's logits against the one-process decoder teacher-forced on the
    rank's tokens (``_matched_logits``), then the tokens by ``_gap_rule``.
    ``bank``: (h), the same with a 2-adapter LoRA bank (``_lora_bank``,
    whole on every rank), requests, the prefix and the beam request each
    under its adapter, the teacher forced with each request's adapter."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.inference.serving import (
        ContinuousBatchingEngine,
        ServingConfig,
    )
    from icl_speech_text_llm_tpu_torch.models.llama import (
        DECODER_CONFIGS,
        LoraConfig,
        embed_tokens,
        init_decoder,
    )
    from icl_speech_text_llm_tpu_torch.training.step import tree_map

    label, name = ("(h)", "serve_bank") if bank else ("(c)", "serve")
    rng = np.random.RandomState(7)
    lengths = [int(n) for n in rng.randint(96, 256, size=6)]
    spec = {"decoder": "vicuna-13b", "cfg": {"n_layers": depth}, "dtype": "bfloat16",
            "seed": 3, "lengths": lengths, "prefix_request": 0, "beam_request": 5,
            "serving": dict(num_slots=4, max_new_tokens=10, prompt_buckets=[256],
                            prefix_buckets=[128], kv_int8=True, eos_token_id=2)}
    adapters = [0] * len(lengths)
    if bank:
        adapters = [1, 0, 1, 0, 0, 1]
        spec.update(bank_seed=11, adapters=adapters, prefix_adapter=adapters[0],
                    lora_scaling=LoraConfig().scaling)
    arrays = {f"req.{i}": rng.randint(3, 32000, size=n).astype(np.int64)
              for i, n in enumerate(lengths)}
    arrays["prefix"] = rng.randint(3, 32000, size=100).astype(np.int64)
    cfg = dataclasses.replace(DECODER_CONFIGS["vicuna-13b"], n_layers=depth)
    params = init_decoder(cfg, torch.Generator(device="cuda").manual_seed(spec["seed"]),
                          torch.device("cuda"), torch.bfloat16)
    lora = _serve_bank(spec, {}, "cuda", torch.bfloat16)
    scaling = spec.get("lora_scaling", 1.0)
    scfg = ServingConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in spec["serving"].items()})
    engine = ContinuousBatchingEngine(cfg, params, scfg, lora=lora, lora_scaling=scaling,
                                      dtype=torch.bfloat16, device="cuda")
    with _recorded_logits(*_serve_logits_modules()) as seen:
        want = _serve_requests(engine, spec, arrays, "cuda")
    one_rows = torch.cat(seen)
    one_pool = sum(t.numel() * t.element_size() for t in engine._cache.values())
    del engine
    with torch.inference_mode():
        prompts = []
        for i in range(len(lengths)):
            ids = arrays[f"req.{i}"]
            if i == spec["prefix_request"]:
                ids = np.concatenate([arrays["prefix"], ids])
            prompts.append(embed_tokens(params, torch.as_tensor(ids, device="cuda"),
                                        dtype=torch.bfloat16))
    T = scfg.max_new_tokens

    def teacher(results):  # the one-process decoder teacher-forced on ``results``
        toks = torch.tensor([g + [2] * (T - len(g)) for g in results], device="cuda")
        if lora is None:
            return _teacher_logits(cfg, params, prompts, toks, None, 1.0, torch.bfloat16)
        rows = [None] * len(results)
        for a in sorted(set(adapters)):
            idx = [i for i, x in enumerate(adapters) if x == a]
            got = _teacher_logits(cfg, params, [prompts[i] for i in idx], toks[idx],
                                  tree_map(lambda x: x[:, a], lora), scaling, torch.bfloat16)
            for j, i in enumerate(idx):
                rows[i] = got[j]
        return torch.stack(rows)

    ref = teacher(want)
    top = ref.topk(2, dim=-1).values
    gaps = (top[..., 0] - top[..., 1]).numpy().astype(np.float64)
    one_err = _matched_logits(ref, one_rows, want)
    del one_rows, ref
    torch.cuda.empty_cache()

    out_dir = os.path.join(d, name)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    ranks = _dp_spawn(out_dir, "file", None, None, "cuda", world=2, timeout=240, mesh="1,1,2",
                      tasks=(name,))
    wall = time.perf_counter() - t0
    what = "a 2-adapter LoRA bank whole on each rank, " if bank else ""
    for r, (res, got) in enumerate(ranks):
        _need_launches(f"{label} rank {r}", res[f"{name}_launches"],
                       {"flash_decode_attention_q8": depth, "append_kv_q8": depth,
                        "flash_attention_causal": depth}, res["plain"])
        s = res[name]
        print(f"  {label} rank {r} of tp = 2: {what}pool {s['pool_bytes']} bytes (one process "
              f"{one_pool}), peak {s['peak_gib']:.3f} GiB; launches K7 q8 "
              f"{res[f'{name}_launches']['flash_decode_attention_q8']}, K4 q8 "
              f"{res[f'{name}_launches']['append_kv_q8']}  [{smi}]", flush=True)
        if 2 * s["pool_bytes"] != one_pool:
            raise AssertionError(f"{label} rank {r}: the pool is not half of one process's")
        err = _matched_logits(teacher(s["results"]), torch.as_tensor(got[f"{name}.logits"]),
                              s["results"])
        print(f"  {label} rank {r}: every generated token's logits (the 5 slot requests' "
              f"admission and decode steps through K7 q8, the beam request's best beam) "
              f"against one process teacher-forced on the rank's tokens: worst "
              f"max_abs_err {err['err']:.4f}, {err['ratio']:.3f} of its tolerance (5% of "
              f"the row's max |logit|) over {err['rows']} rows; the one-process engine's "
              f"own: {one_err['err']:.4f}, {one_err['ratio']:.3f}  [{smi}]", flush=True)
        if err["ratio"] > 1.0:
            raise AssertionError(f"{label} rank {r}: a token's logits are off: {err}")
        padded = [g + [2] * (T - len(g)) for g in s["results"]]
        _gap_rule(f"{label} rank {r}, tp = 2, 6 requests (prefix, 2 beams)", padded,
                  [w + [2] * (T - len(w)) for w in want], gaps)
        if s["results"] != ranks[0][0][name]["results"]:
            raise AssertionError(f"{label} rank {r}'s tokens are not rank 0's")
    print(f"  {label} two ranks, the same tokens on both: {wall:.1f} s with the process starts",
          flush=True)
    del params, prompts, lora
    torch.cuda.empty_cache()


def _matched_logits(ref, rows, results, rel=5e-2):
    """Each generated token's teacher-forced logits ``ref[b, t]`` (t <
    len(results[b])) against the nearest of the logits rows an engine
    decoded from (``rows`` (N, V), every request's, in no known order; a
    beam request's best beam was in the beam at every step): the worst
    max |·| distance, and its ratio to ``rel`` × the row's max |logit|."""
    worst = {"err": 0.0, "ratio": 0.0, "rows": 0}
    rows = rows.float()
    for b, g in enumerate(results):
        for t in range(len(g)):
            want = ref[b, t].float()
            err = float((rows - want).abs().amax(dim=-1).min())
            worst["err"] = max(worst["err"], err)
            worst["ratio"] = max(worst["ratio"], err / (rel * float(want.abs().max())))
            worst["rows"] += 1
    return worst


def _mesh_train(d, smi, train_losses):
    """(d) cli/train.py at --mesh 1,1,2 and 1,2,1: salmonn-7b at phase
    train's 1024 / 448, batch 4, its first 2 steps, on two gloo ranks each:
    the losses of phase train's first two steps within 1e-3 relative; the
    fsdp ranks' steps peaking under half of phase train's peak plus
    ``FSDP_SLACK_GIB``."""
    out = {}
    for mesh in ("1,1,2", "1,2,1"):
        out_dir = os.path.join(d, "train" + mesh.replace(",", ""))
        os.makedirs(out_dir, exist_ok=True)
        argv = _train_argv(os.path.join(out_dir, "ckpt"), 4,
                           ["--mesh", mesh, "--val_max_samples", "0", "--save_every", "0"])
        with open(os.path.join(out_dir, "cli.json"), "w") as f:
            json.dump({"argv": argv, "max_steps": 2}, f)
        t0 = time.perf_counter()
        ranks = _dp_spawn(out_dir, "file", None, None, "cuda", world=2, timeout=300, mesh=mesh,
                          tasks=("train_cli",))
        wall = time.perf_counter() - t0
        for r, (res, _) in enumerate(ranks):
            t = res["train_cli"]
            _need_launches(f"(d) {mesh} rank {r}", res["train_cli_launches"],
                           {k: 2 * n for k, n in SALMONN_7B_STEP.items()}, res["plain"])
            errs = [abs(a - b) / abs(b) for a, b in zip(t["losses"], train_losses[:2])]
            print(f"  (d) --mesh {mesh} rank {r}: {t['steps']} steps, losses {t['losses']} "
                  f"against phase train's {train_losses[:2]} (relative {errs}, bound 1e-3); "
                  f"weights held {t['held_gib']:.3f} GiB, the steps' peak "
                  f"{t['step_peak_gib']:.3f} GiB, the run's {t['peak_gib']:.3f} (the build "
                  f"included); run {t['seconds']:.1f} s  [{smi}]", flush=True)
            if t["steps"] != 2 or t["skipped"] or len(errs) != 2 or max(errs) > 1e-3:
                raise AssertionError(f"(d) --mesh {mesh}: not phase train's losses")
            bound = TRAIN_PEAK_GIB / 2 + FSDP_SLACK_GIB
            if mesh == "1,2,1" and t["step_peak_gib"] >= bound:
                raise AssertionError(f"(d) fsdp = 2 steps peak at {t['step_peak_gib']:.3f} GiB, "
                                     f"not under half phase train's {TRAIN_PEAK_GIB} + "
                                     f"{FSDP_SLACK_GIB} = {bound}")
        print(f"  (d) --mesh {mesh}: {wall:.1f} s with the process starts", flush=True)
        out[mesh] = [res["train_cli"] for res, _ in ranks]
    return out


def _mesh_four(d, smi):
    """(e) four gloo ranks at --mesh 1,2,2 on salmonn-7b's widths, 2 layers
    a stack: one step against one process's step on the same weights on
    the card (``MESH_CARD_LIMITS``) and against the f32 step on the host
    (``MESH_ROUNDING``), and each family's collective calls against
    ``mesh_step_counts``."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_probe,
        make_train_step,
        tree_map,
    )

    model = "salmonn-7b-2layer"
    cfg, params = _dp_model(model, d, "cuda")
    batch = _dp_batch(cfg)
    opt = AdamW(OptimizerSettings(**DP_OPT))
    state, frozen = init_train_state(params, opt)
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    _, g = make_train_probe(cfg)(state, frozen, dev)
    want = dict(zip(_paths(state.trainable), (t.float().cpu().numpy() for t in g)))
    _, m = make_train_step(cfg, opt)(state, frozen, dev)
    # the same gradients in f32 on the host (the kernels' plain versions, f32
    # math on the same weights): how far one process's bf16 step is from it
    host = tree_map(lambda t: t.detach().float().cpu(), params)
    del params, state, frozen, g
    torch.cuda.empty_cache()
    state, frozen = init_train_state(host, opt)
    _, g = make_train_probe(dataclasses.replace(cfg, compute_dtype=torch.float32))(
        state, frozen, {k: torch.as_tensor(v) for k, v in batch.items()})
    exact = dict(zip(_paths(state.trainable), (t.numpy() for t in g)))
    del host, state, frozen, g
    floor = max(np.abs(want[k] - v).max() / _group_max(exact, k) for k, v in exact.items())
    out_dir = os.path.join(d, "four")
    t0 = time.perf_counter()
    ranks = _dp_spawn(out_dir, model, None, batch, "cuda", world=4, timeout=240, mesh="1,2,2",
                      tasks=("step",))
    wall = time.perf_counter() - t0
    counts = mesh_step_counts(cfg, (1, 2, 2))
    errs = {k: 0.0 for k in MESH_CARD_LIMITS}
    groups, off_exact, faults = {}, 0.0, []
    for r, (res, arrays) in enumerate(ranks):
        s = res["step"]
        _need_launches(f"(e) rank {r}", res["step_launches"],
                       {"flash_attention_causal": cfg.llm.n_layers,
                        "flash_attention_bwd_dq": cfg.llm.n_layers,
                        "flash_attention_bwd_dkv": cfg.llm.n_layers}, res["plain"])
        errs["loss"] = max(errs["loss"], abs(s["loss"] - m["loss"]) / abs(m["loss"]))
        errs["grad_norm"] = max(errs["grad_norm"],
                                abs(s["grad_norm"] - m["grad_norm"]) / m["grad_norm"])
        grads = _dp_grads({k[len("mu."):]: v for k, v in arrays.items() if k.startswith("mu.")},
                          s["grad_norm"])
        for name, w in want.items():
            e = np.abs(grads[name] - w).max() / _group_max(want, name)
            errs["grads"] = max(errs["grads"], e)
            group = "qformer" if name.startswith("qformer") else f"lora.*.{name[-1]}"
            groups[group] = max(groups.get(group, 0.0), float(e))
            off_exact = max(off_exact, np.abs(grads[name] - exact[name]).max()
                            / _group_max(exact, name))
        if any(not np.array_equal(v, ranks[0][1][k]) for k, v in arrays.items()):
            faults.append(f"rank {r}: the gathered leaves differ from rank 0's")
        if s["skipped"] or not (s["nan_skipped"] == 1.0 and s["kept_after_nan"]):
            faults.append(f"rank {r}: a step was wrongly taken or skipped: {s}")
        if s["counts"] != counts:
            faults.append(f"rank {r}: collectives {s['counts']} against {counts}")
    held = "; ".join(faults) or "replicas equal, the NaN step skipped on every rank"
    print(f"  (e) four gloo ranks, --mesh 1,2,2, salmonn-7b widths, 2 layers a stack: loss "
          f"{ranks[0][0]['step']['loss']:.8f} (one process {m['loss']:.8f}); relative errors "
          f"loss {errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}, gradients "
          f"{errs['grads']:.3e} of their group's max ({ {k: f'{v:.3e}' for k, v in groups.items()} }; "
          f"limits {MESH_CARD_LIMITS}); {held}; collectives a step "
          f"{ranks[0][0]['step']['counts']} "
          f"(formula {counts}); transport {ranks[0][0]['transport']}; step "
          f"{ranks[0][0]['step']['seconds']:.2f} s; {wall:.1f} s with the process starts  "
          f"[{smi}]", flush=True)
    print(f"  (e) against the f32 step on the host: one process's bf16 gradients "
          f"{floor:.3e} of their group's max away, the sharded step's {off_exact:.3e} "
          f"(limit {MESH_ROUNDING} × one process's)", flush=True)
    if (faults or any(errs[k] > MESH_CARD_LIMITS[k] for k in errs)
            or off_exact > MESH_ROUNDING * floor):
        raise AssertionError(f"(e) the sharded step is not one process's: {faults}, {errs}, "
                             f"{off_exact:.3e} from f32 against one process's {floor:.3e}")
    return errs


def _pp_batch(cfg, L=1024):
    """phase check's two-request train batch (``_train_batch``) at ``L``
    positions as four rows, the pair and its reverse."""
    import numpy as np

    b = _train_batch(cfg, cfg.audio_tokens_per_slot, L)
    return {k: np.concatenate([v, v[::-1]]) for k, v in b.items()}


def _mesh_pipeline(d, smi):
    """(f) pp = 2 at salmonn-7b's widths, 4 layers a stack, batch 4 at 1024
    positions, ``PP_MICRO`` microbatches, 2 steps, against the same 2 steps
    in one process (run first): the losses within 1e-3 relative; each
    stage's K1, K5 and K6 launches exactly its layers × microbatches ×
    steps, no plain version; each stage holding half of one process's
    layer and LoRA bytes; the peaks printed beside one process's."""
    import torch

    model = "salmonn-7b-4layer"
    cfg, params = _dp_model(model, d, "cuda")
    arrays = _pp_batch(cfg)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()}
    one = _train_steps(cfg, params, batch, 2)
    del params, batch
    torch.cuda.empty_cache()
    out_dir = os.path.join(d, "pipeline")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "steps.json"), "w") as f:
        json.dump({"n": 2}, f)
    t0 = time.perf_counter()
    ranks = _dp_spawn(out_dir, model, None, arrays, "cuda", world=2, timeout=300,
                      mesh="1,1,1,2", tasks=("train_steps",))
    wall = time.perf_counter() - t0
    n = 2 * (cfg.llm.n_layers // 2) * PP_MICRO
    want = {"flash_attention_causal": n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n}
    faults = []
    for r, (res, _) in enumerate(ranks):
        t, launches = res["train_steps"], res["train_steps_launches"]
        errs = [abs(a - b) / abs(b) for a, b in zip(t["losses"], one["losses"])]
        got = {k: launches[k] for k in want}
        print(f"  (f) pp = 2 stage {r}: losses {t['losses']} against one process's "
              f"{one['losses']} (relative {errs}, bound 1e-3); K1/K5/K6 launches {got} "
              f"(layers × microbatches × steps: {n} each); layers and LoRA held "
              f"{t['layer_bytes']} bytes (one process {one['layer_bytes']}); the steps' peak above "
              f"the memory held before them {t['peak_gib']:.3f} GiB (one process "
              f"{one['peak_gib']:.3f}); steps "
              f"{t['seconds']:.1f} s (one process {one['seconds']:.1f})  [{smi}]", flush=True)
        if max(errs) > 1e-3:
            faults.append(f"stage {r}: losses {errs}")
        if got != want or sum(res["plain"].values()):
            faults.append(f"stage {r}: launches {got}, plain {res['plain']}")
        if 2 * t["layer_bytes"] != one["layer_bytes"]:
            faults.append(f"stage {r}: holds {t['layer_bytes']} layer bytes")
    print(f"  (f) two stages: {wall:.1f} s with the process starts; transport "
          f"{ranks[0][0]['transport']}", flush=True)
    if faults:
        raise AssertionError(f"(f) the pipeline is not one process's: {faults}")


def _mesh_sp(d, smi):
    """(g) sp = 2 at salmonn-7b's widths, 2 layers a stack, 2 rows at 2048
    positions: ``decoder_forward(ring=)``'s hidden against K1's route in
    one process (valid rows, 2e-2 of the max |hidden|), and one step with
    the decoder sequence-parallel against one process's (loss within 1e-3
    relative)."""
    import torch

    from icl_speech_text_llm_tpu_torch.models.llama import decoder_forward
    from icl_speech_text_llm_tpu_torch.models.salmonn import _train_sequence

    model = "salmonn-7b-2layer"
    cfg, params = _dp_model(model, d, "cuda")
    arrays = _train_batch(cfg, cfg.audio_tokens_per_slot, 2048)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()}
    lengths = batch["seq_mask"].sum(dim=1).to(torch.int32)
    with torch.no_grad():
        seq = _train_sequence(cfg, params, batch)
        ref = decoder_forward(cfg.llm, params["llm"], seq, lengths, lora=params["lora"],
                              lora_scaling=cfg.lora.scaling)[0].float().cpu()
    del seq
    one = _train_steps(cfg, params, batch, 1)
    del params, batch
    torch.cuda.empty_cache()
    out_dir = os.path.join(d, "sp")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "steps.json"), "w") as f:
        json.dump({"n": 1, "sp": True}, f)
    t0 = time.perf_counter()
    ranks = _dp_spawn(out_dir, model, None, arrays, "cuda", world=2, timeout=300,
                      mesh="1,1,2", tasks=("train_steps",))
    wall = time.perf_counter() - t0
    scale = max(float(ref[b, :n].abs().max()) for b, n in enumerate(lengths.tolist()))
    faults = []
    for r, (res, got) in enumerate(ranks):
        t = res["train_steps"]
        hidden = torch.as_tensor(got["steps.ring_hidden"])
        err = max(float((hidden[b, :n] - ref[b, :n]).abs().max())
                  for b, n in enumerate(lengths.tolist()))
        loss_err = abs(t["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        print(f"  (g) sp = 2 rank {r}: decoder_forward(ring=) hidden against K1's route "
              f"max_abs_err {err:.4e} ({err / scale:.3e} of max |hidden| {scale:.3f}, bound "
              f"2e-2); the sp step's loss {t['losses'][0]:.6f} against one process's "
              f"{one['losses'][0]:.6f} (relative {loss_err:.3e}, bound 1e-3); the step's "
              f"peak above the memory held before it {t['peak_gib']:.3f} GiB (one process "
              f"{one['peak_gib']:.3f}); step {t['seconds']:.1f} s (one process "
              f"{one['seconds']:.1f}); plain routes "
              f"{ {k: v for k, v in res['plain'].items() if v} }  [{smi}]", flush=True)
        if err > 2e-2 * scale or loss_err > 1e-3 or sum(res["plain"].values()):
            faults.append(f"rank {r}: hidden {err / scale:.3e}, loss {loss_err:.3e}")
    print(f"  (g) two ranks: {wall:.1f} s with the process starts", flush=True)
    if faults:
        raise AssertionError(f"(g) the sequence-parallel decoder is not one process's: {faults}")


#: sub-phase (i)'s Qwen2-Audio-7B: the preset at 2 layers a stack (tower
#: whole, as under JAX), drawn from seed 2 on every rank
SPLIT_QWEN = {"base": "qwen2_audio_7b", "n_layers": 2, "tower": {"n_layers": 2}, "seed": 2}


def _split_reference(label, cfg, params, batch, gen, loss_fn, sequence_fn, kw, host):
    """One process on the card for sub-phase (i): the loss, grad norm and
    gradients of a ``DP_OPT`` step on ``batch``, the greedy tokens of
    ``gen``, the logits that picked them (T, B, V) and their teacher-forced
    top-1/top-2 gaps; with ``host`` also
    the same gradients in f32 on the host and one process's distance from
    them (``floor``, × the group's max)."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.inference.engine import GenerationConfig
    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_probe,
        make_train_step,
        tree_map,
    )

    t0 = time.perf_counter()
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    opt = AdamW(OptimizerSettings(**DP_OPT))
    state, frozen = init_train_state(params, opt)
    _, g = make_train_probe(cfg, loss_fn)(state, frozen, dev)
    out = {"grads": dict(zip(_paths(state.trainable), (t.float().cpu().numpy() for t in g)))}
    _, m = make_train_step(cfg, opt, loss_fn)(state, frozen, dev)
    out.update(loss=m["loss"], grad_norm=m["grad_norm"])
    del state, frozen, g
    from icl_speech_text_llm_tpu_torch.inference import engine

    gdev = {k: torch.as_tensor(v, device="cuda") for k, v in gen.items()}
    with torch.inference_mode(), _recorded_logits(engine) as seen:
        toks = engine.generate_batch(cfg, GenerationConfig(**kw), params, gdev, sequence_fn)
        seq = sequence_fn(cfg, params, gdev)
    out["step_logits"] = torch.stack(seen).numpy()
    lengths = gen["seq_lengths"]
    prompts = [seq[b, :lengths[b]] for b in range(len(lengths))]
    lora = params.get("lora")
    out["gaps"] = _teacher_gaps(cfg.llm, params["llm"], prompts, toks, lora,
                                cfg.lora.scaling, cfg.compute_dtype)
    out["tokens"] = toks.cpu().numpy()
    del seq, prompts, gdev, dev
    if host:
        cpu = tree_map(lambda t: t.detach().float().cpu(), params)
        state, frozen = init_train_state(cpu, opt)
        _, g = make_train_probe(dataclasses.replace(cfg, compute_dtype=torch.float32), loss_fn)(
            state, frozen, {k: torch.as_tensor(v) for k, v in batch.items()})
        exact = dict(zip(_paths(state.trainable), (t.numpy() for t in g)))
        out["exact"] = exact
        out["floor"] = max(np.abs(out["grads"][k] - v).max() / _group_max(exact, k)
                           for k, v in exact.items())
        del cpu, state, frozen, g
    print(f"  (i) {label}, one process on the card: loss {out['loss']:.8f}, grad norm "
          f"{out['grad_norm']:.6f}, tokens {out['tokens'].tolist()}"
          + (f"; its gradients {out['floor']:.3e} of their group's max from the f32 host "
             "step" if host else "") + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def _split_check(label, cfg, ranks, task, gen_task, ref, prefix, smi):
    """Sub-phase (i)'s readings of one model on every rank (``_mesh_split``)
    → the faults found."""
    import numpy as np

    from icl_speech_text_llm_tpu_torch.parallel.sharding import ShardContext

    tp = 8
    ctx = ShardContext({"tp": tp}, {"tp": 0}, {})
    counts = mesh_step_counts(cfg, (1, 1, tp))
    want_heads = {}
    llm = cfg.llm
    split = ctx.split_heads(llm.n_heads, llm.n_kv_heads)
    want_heads["llama.flash_attention"] = [ctx.local_heads(llm.n_heads, split)]
    need = {"flash_attention_causal": llm.n_layers, "flash_attention_bwd_dq": llm.n_layers,
            "flash_attention_bwd_dkv": llm.n_layers}
    layouts = {"decoder": "split-head" if split else "head-sharded"}
    if hasattr(cfg, "whisper"):  # SALMONN: Whisper and BEATs cut over tp
        for name, enc in (("whisper", cfg.whisper), ("beats", cfg.beats)):
            s = ctx.split_heads(enc.n_heads)
            layouts[name] = "split-head" if s else "head-sharded"
            key = "whisper.flash_attention" if name == "whisper" else "beats.gated_bias_attention"
            want_heads[key] = [ctx.local_heads(enc.n_heads, s)]
        need.update(flash_attention_noncausal=cfg.whisper.n_layers,
                    gated_bias_attention=cfg.beats.n_layers)
    else:  # Qwen2-Audio: the tower whole on every rank
        want_heads["whisper.flash_attention"] = [cfg.encoder.n_heads]
        need["flash_attention_noncausal"] = cfg.encoder.n_layers
    errs = {k: 0.0 for k in MESH_CARD_LIMITS}
    off_exact, logit_ratio, faults = 0.0, 0.0, []
    first = None
    for r, (res, arrays) in enumerate(ranks):
        s = res[task]
        _need_launches(f"(i) {label} rank {r} step", res[task + "_launches"], need, res["plain"])
        _need_launches(f"(i) {label} rank {r} generation", res[gen_task + "_launches"],
                       {**{k: v for k, v in need.items() if "bwd" not in k}, "append_kv": 9},
                       res["plain"])
        for t in (task, gen_task):
            if res[t + "_heads"] != want_heads:
                faults.append(f"rank {r} {t}: attention heads {res[t + '_heads']}, "
                              f"not {want_heads}")
        errs["loss"] = max(errs["loss"], abs(s["loss"] - ref["loss"]) / abs(ref["loss"]))
        errs["grad_norm"] = max(errs["grad_norm"],
                                abs(s["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"])
        mine = {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith((prefix + "trainable.", prefix + "mu."))}
        grads = _dp_grads({k[len("mu."):]: v for k, v in mine.items() if k.startswith("mu.")},
                          s["grad_norm"])
        for name, w in ref["grads"].items():
            errs["grads"] = max(errs["grads"], float(np.abs(grads[name] - w).max()
                                                     / _group_max(ref["grads"], name)))
            if "exact" in ref:
                off_exact = max(off_exact, float(np.abs(grads[name] - ref["exact"][name]).max()
                                                 / _group_max(ref["exact"], name)))
        first = first or mine
        if any(not np.array_equal(v, first[k]) for k, v in mine.items()):
            faults.append(f"rank {r}: the gathered leaves differ from rank 0's")
        if s["skipped"] or not (s["nan_skipped"] == 1.0 and s["kept_after_nan"]):
            faults.append(f"rank {r}: a step was wrongly taken or skipped")
        if s["counts"] != counts:
            faults.append(f"rank {r}: collectives {s['counts']} against {counts}")
        toks = arrays[f"{gen_task}.tokens"]
        if not np.array_equal(toks, ranks[0][1][f"{gen_task}.tokens"]):
            faults.append(f"rank {r}: tokens differ from rank 0's")
        # the logits that picked each token against one process's, at every
        # position whose prefix both share (up to and with the first token
        # that differs)
        steps, ratio = arrays[f"{gen_task}.step_logits"], 0.0
        for b, (got, want) in enumerate(zip(toks, ref["tokens"])):
            same = [int(x) == int(y) for x, y in zip(got, want)] + [False]
            n = min(same.index(False) + 1, len(want))
            ref_b = ref["step_logits"][:n, b]
            ratio = max(ratio, float(np.abs(steps[:n, b] - ref_b).max()
                                     / (5e-2 * np.abs(ref_b).max())))
        logit_ratio = max(logit_ratio, ratio)
        print(f"  (i) {label} rank {r}: the rank's peak {s['process_peak_gib']:.3f} GiB "
              f"before the step (its models drawn whole, then cut), held "
              f"{s['held_gib']:.3f} GiB before the step, the step's peak "
              f"{s['step_peak_gib']:.3f} GiB above it, the peak through the step and the "
              f"generation {res[gen_task]['peak_gib']:.3f} GiB; step "
              f"{s['seconds']:.2f} s; the logits that picked the "
              f"tokens {ratio:.3f} of 5% of max |logit| from one process's", flush=True)
        if ratio > 1:
            faults.append(f"rank {r}: step logits {ratio:.3f} of their tolerance")
    _gap_rule(f"(i) {label}, tp = 8", ranks[0][1][f"{gen_task}.tokens"], ref["tokens"],
              ref["gaps"])
    s = ranks[0][0][task]
    print(f"  (i) {label} at --mesh 1,1,8 ({layouts}; attention heads a rank {want_heads}): "
          f"loss {s['loss']:.8f} (one process {ref['loss']:.8f}); relative errors loss "
          f"{errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}, gradients "
          f"{errs['grads']:.3e} of their group's max (limits {MESH_CARD_LIMITS})"
          + (f"; from the f32 host step {off_exact:.3e} against one process's "
             f"{ref['floor']:.3e} (limit {MESH_ROUNDING} ×)" if "exact" in ref else "")
          + f"; the logits that picked every token {logit_ratio:.3f} of their tolerance"
          f"; collectives a step {s['counts']} (formula {counts}); "
          f"{'; '.join(faults) or 'replicas and tokens equal on every rank'}  [{smi}]",
          flush=True)
    if any(errs[k] > MESH_CARD_LIMITS[k] for k in errs):
        faults.append(f"errors {errs} over {MESH_CARD_LIMITS}")
    if "exact" in ref and off_exact > MESH_ROUNDING * ref["floor"]:
        faults.append(f"{off_exact:.3e} from the f32 step against one process's "
                      f"{ref['floor']:.3e}")
    return [f"{label}: {f}" for f in faults]


def _mesh_split(d, smi):
    """(i) tensor parallelism where tp does not divide a head count: 8 gloo
    ranks at --mesh 1,1,8, 2 layers a stack at full width, in one spawn:
    Qwen2-Audio-7B (28 heads over 4 KV heads: 3.5 heads and half a KV head
    a rank; its tower whole) and salmonn-7b's widths (Whisper's 20 heads,
    BEATs' 12; Vicuna's 32 divide and keep the head-sharded path). Each
    model's loss and one step against one process's on the card
    (``MESH_CARD_LIMITS``), Qwen's gradients also against the f32 step on
    the host (``MESH_ROUNDING``); each family's collective calls against
    ``mesh_step_counts``; 10 greedy tokens against one process's by
    ``_gap_rule``, equal on every rank, and the logits that picked them
    within 5% of max |logit| of one process's (random weights tie Qwen's
    first gaps under the rule's tau); every rank's K1, K2 and K3 at the
    head counts of its layout (``_recorded_heads``) and K5/K6 in the step;
    each rank's peaks."""
    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.inference.engine import speech_sequence
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import (
        audio_output_length,
        qwen_audio_train_loss,
        qwen_sequence,
    )
    from icl_speech_text_llm_tpu_torch.models.salmonn import salmonn_train_loss

    out_dir = os.path.join(d, "split")
    os.makedirs(out_dir, exist_ok=True)
    kw = dict(max_new_tokens=10, eos_token_id=2, pad_token_id=0)
    qcfg, qparams = _qwen_model(SPLIT_QWEN, out_dir, "cuda")
    clip = 5 * 16000
    qbatch = _train_batch(qcfg, int(audio_output_length(clip)), 384, clip_samples=clip)
    qgen = {"text_tokens": qbatch["text_tokens"], "gather_idx": qbatch["gather_idx"],
            "seq_lengths": qbatch["seq_mask"].sum(axis=1).astype(np.int32),
            "wavs": qbatch["wavs"], "audio_lengths": qbatch["audio_lengths"]}
    qref = _split_reference("Qwen2-Audio-7B", qcfg, qparams, qbatch, qgen,
                            qwen_audio_train_loss, qwen_sequence, kw, host=True)
    del qparams
    torch.cuda.empty_cache()
    model = "salmonn-7b-2layer"
    scfg, sparams = _dp_model(model, out_dir, "cuda")
    sbatch, sgen = _dp_batch(scfg), _mesh_gen_batch(scfg, n=2)
    sref = _split_reference("salmonn-7b widths", scfg, sparams, sbatch, sgen,
                            salmonn_train_loss, speech_sequence, kw, host=False)
    del sparams
    torch.cuda.empty_cache()
    for name, arrays in (("gen", sgen), ("qbatch", qbatch), ("qgen", qgen)):
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
    for name, spec in (("gen", {"kw": kw}), ("qwen", SPLIT_QWEN)):
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(spec, f)
    gc.collect()  # the eight ranks need the card: nothing of this process's stays cached
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  (i) before the spawn: {free / 2**30:.3f} of {total / 2**30:.3f} GiB free on the "
          f"card, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved by this process",
          flush=True)
    t0 = time.perf_counter()
    ranks = _dp_spawn(out_dir, model, None, sbatch, "cuda", world=8, timeout=480,
                      mesh="1,1,8", tasks=("qwen_step", "qwen_generate", "step", "generate"))
    wall = time.perf_counter() - t0
    faults = _split_check("Qwen2-Audio-7B", qcfg, ranks, "qwen_step", "qwen_generate", qref,
                          "qwen_step.", smi)
    faults += _split_check("salmonn-7b widths", scfg, ranks, "step", "generate", sref, "", smi)
    print(f"  (i) eight ranks: {wall:.1f} s with the process starts; transport "
          f"{ranks[0][0]['transport']}", flush=True)
    if faults:
        raise AssertionError(f"(i) the split-head path is not one process's: {faults}")


def _mesh_phase(out_dir, train_losses, smi):
    """FSDP, tensor, pipeline and sequence parallelism on the one card:
    ranks are processes sharing it over gloo (NCCL refuses a card twice in
    a group), so this shows the sharded paths correct and running their
    kernels on local shards, not NCCL's speed. (a)-(i): ``_mesh_static``,
    ``_mesh_serve``, ``_mesh_train``, ``_mesh_four``, ``_mesh_pipeline``,
    ``_mesh_sp``, ``_mesh_serve(bank=True)``, ``_mesh_split``; each
    sub-phase's seconds."""
    for label, run in (("(a)-(b)", lambda: _mesh_static(out_dir, smi)),
                       ("(c)", lambda: _mesh_serve(out_dir, smi)),
                       ("(d)", lambda: _mesh_train(out_dir, smi, train_losses)),
                       ("(e)", lambda: _mesh_four(out_dir, smi)),
                       ("(f)", lambda: _mesh_pipeline(out_dir, smi)),
                       ("(g)", lambda: _mesh_sp(out_dir, smi)),
                       ("(h)", lambda: _mesh_serve(out_dir, smi, bank=True)),
                       ("(i)", lambda: _mesh_split(out_dir, smi))):
        t0 = time.perf_counter()
        run()
        print(f"  phase mesh {label}: {time.perf_counter() - t0:.1f} s", flush=True)


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
    _symbol_check_phase()
    _quant_reference_phase()
    _qwen_reference_phase()
    _step_launches()
    print(f"  phase check: {time.perf_counter() - t0:.1f} s", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    print("phase main:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        main_counts, quant_run, bf16_paths = _main_phase(d)
        print(f"  phase main: {time.perf_counter() - t0:.1f} s", flush=True)
        print("phase load:", flush=True)
        t0 = time.perf_counter()
        _load_phase(d, quant_run)
        print(f"  phase load: {time.perf_counter() - t0:.1f} s", flush=True)
        print("phase serve:", flush=True)
        t0 = time.perf_counter()
        _serve_phase(d, bf16_paths)
        print(f"  phase serve: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase train:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        counts, train_losses = _train_phase(d)
    print(f"  phase train: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase qwen:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        qwen_counts = _qwen_phase(d)
    print(f"  phase qwen: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase symbol:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        _symbol_phase(d)
    print(f"  phase symbol: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase util:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        _util_phase(d, train_losses, smi)
    print(f"  phase util: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase mesh:", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=here) as d:
        _mesh_phase(d, train_losses, smi)
    print(f"  phase mesh: {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        if "counter" in row:  # a Qwen-shape row: the launches of its phase qwen run
            row["launches"] = qwen_counts[row["qwen_run"]][row["counter"]]
        else:
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
    if sys.argv[1:2] == ["--dp_worker"]:
        _dp_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:10])
    elif sys.argv[1:2] == ["--train_worker"]:
        _train_worker(sys.argv[2], sys.argv[3:])
    else:
        main()
