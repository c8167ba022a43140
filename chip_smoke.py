"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device  — the card's name and power limit (nvidia-smi); exits non-zero
               without CUDA;
  2. build   — compiles the Hopper kernels of icl_speech_text_llm_tpu_torch/csrc;
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main path's shapes, with the stated tolerances, plus CUDA-event
               median times of both;
  4. check   — a one-layer-per-stack model at salmonn-7b widths: first-token
               logits of the bf16 kernel path on the card against the f32 plain
               path on the CPU, same weights and inputs;
  5. main    — the port's inference CLI on salmonn-7b at full width (random
               weights from a seed), 8 voxceleb requests of 6 clips each, with
               every kernel's launch count read from that run alone.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time


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


def _time_ms(fn, reps=10):
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
    return statistics.median(times)


def _kernel_phase():
    """Kernel vs plain version on the card at the main path's shapes."""
    import torch

    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rows = []

    def report(name, route, source, replaces, errs, ms, plain_ms):
        worst = 0.0
        for what, err, tol in errs:
            ok = err <= tol
            print(f"  {name} {what}: max_abs_err {err:.3e} (tolerance {tol:.1e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} {what} error {err} > {tol}")
            worst = max(worst, err)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "max_abs_err": worst,
                     "ms": ms, "plain_ms": plain_ms})

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

    # K1: LLM prefill, (4, 32, 1024, 128) causal, ragged lengths; then GQA
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
    report("flash_attention_causal", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/flash_fwd.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:145", errs,
           _time_ms(lambda: fa.flash_attention_causal(q, k, v, lengths)),
           _time_ms(lambda: fa.flash_attention_plain(q, k, v, lengths, True)))

    # K2: Whisper encoder, (24, 20, 1500, 64) non-causal, all 1500 keys valid
    B, H, S, D = 24, 20, 1500, 64
    q, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D)
    ker = fa.flash_attention_noncausal(q, k, v)
    ref = fa.flash_attention_plain(q, k, v, None, causal=False)
    report("flash_attention_noncausal", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/flash_fwd.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:238",
           stat_errs(ker, ref, [S] * B),
           _time_ms(lambda: fa.flash_attention_noncausal(q, k, v)),
           _time_ms(lambda: fa.flash_attention_plain(q, k, v, None, False)))
    del q, k, v, ker, ref

    # K3: BEATs gated relative-position bias, (24, 12, 1496, 64)
    B, H, S, D = 24, 12, 1496, 64
    q, k, v, xh = (randn(B, H, S, D) for _ in range(4))
    bias = randn(H, S, S, scale=0.5)
    grep_w = torch.randn((D, 8), generator=gen, device=dev) * 0.2
    grep_b = torch.randn((8,), generator=gen, device=dev) * 0.1
    grep_a = 1.0 + 0.1 * torch.randn((H,), generator=gen, device=dev)
    args = (q, k, v, xh, bias, grep_w, grep_b, grep_a)
    ker = fa.gated_bias_attention(*args)
    ref = fa.gated_bias_attention_plain(*args)
    report("gated_bias_attention", "cuda",
           "icl_speech_text_llm_tpu_torch/csrc/gated_bias.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:840",
           [("o", valid_rows_err(ker, ref, [S] * B), 2e-2)],
           _time_ms(lambda: fa.gated_bias_attention(*args)),
           _time_ms(lambda: fa.gated_bias_attention_plain(*args)))
    del args, q, k, v, xh, bias, ker, ref

    # K4: decode-step append into the Vicuna-7B cache, bit-exact
    L, B, Hkv, S, D = 32, 4, 32, 1152, 128
    ck, cv = randn(L, B, Hkv, S, D), randn(L, B, Hkv, S, D)
    nk, nv = randn(L, B, Hkv, 1, D), randn(L, B, Hkv, 1, D)
    pos = torch.tensor([1033, 700, 1151, 0], dtype=torch.int32, device=dev)
    ck2, cv2 = ck.clone(), cv.clone()
    fa.append_kv(ck, cv, nk, nv, pos)
    fa.append_kv_plain(ck2, cv2, nk, nv, pos)
    exact = torch.equal(ck, ck2) and torch.equal(cv, cv2)
    err = max((ck.float() - ck2.float()).abs().max().item(),
              (cv.float() - cv2.float()).abs().max().item())
    report("append_kv", "cuda", "icl_speech_text_llm_tpu_torch/csrc/append_kv.cu",
           "icl_speech_text_llm_tpu/ops/flash_attention.py:1438",
           [("cache (bit-exact)", 0.0 if exact else max(err, 1e-30), 0.0)],
           _time_ms(lambda: fa.append_kv(ck, cv, nk, nv, pos), reps=50),
           _time_ms(lambda: fa.append_kv_plain(ck, cv, nk, nv, pos), reps=50))
    del ck, cv, ck2, cv2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def _reference_phase():
    """salmonn-7b widths with one layer per stack: the bf16 kernel path on the
    card against the f32 plain path on the CPU, same weights and inputs."""
    import dataclasses

    import numpy as np
    import torch

    from icl_speech_text_llm_tpu_torch.inference.engine import first_token_logits
    from icl_speech_text_llm_tpu_torch.models.salmonn import init_salmonn, salmonn_7b

    full = salmonn_7b()
    cfg = dataclasses.replace(
        full,
        whisper=dataclasses.replace(full.whisper, n_layers=1),
        beats=dataclasses.replace(full.beats, n_layers=1),
        llm=dataclasses.replace(full.llm, n_layers=1),
    )
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_salmonn(cfg, gen, torch.device("cuda"), torch.bfloat16)
    rng = np.random.RandomState(0)
    B, n_slots, L = 1, 2, 256
    wavs = (rng.randn(B, n_slots, 5 * 16000) * 3000).astype(np.int16)
    n_text = 40
    text = rng.randint(3, cfg.llm.vocab_size, size=(B, n_text)).astype(np.int32)
    # prompt: 20 text positions, clip 0 (88), 20 text, clip 1 (88); rest pad
    T_a = cfg.audio_tokens_per_slot
    idx = np.concatenate([1 + np.arange(20), 1 + n_text + np.arange(T_a),
                          21 + np.arange(20), 1 + n_text + T_a + np.arange(T_a)])
    gather = np.zeros((B, L), np.int64)
    gather[0, :len(idx)] = idx
    batch = {"text_tokens": text, "gather_idx": gather,
             "seq_lengths": np.array([len(idx)], np.int32), "wavs": wavs}

    def to(dev):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    got = first_token_logits(cfg, params, to("cuda")).float().cpu()
    cpu_params = _tree_to(params, torch.device("cpu"), torch.float32)
    ref = first_token_logits(dataclasses.replace(cfg, compute_dtype=torch.float32),
                             cpu_params, to("cpu")).float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the card")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = 5e-2 * scale
    print(f"  first-token logits {tuple(got.shape)}: max_abs_err {err:.4e} vs f32 CPU "
          f"(tolerance {tol:.4e} = 5% of max |logit| {scale:.4f}); argmax "
          f"{got.argmax(-1).tolist()} vs {ref.argmax(-1).tolist()}", flush=True)
    if err > tol:
        raise AssertionError(f"reference check failed: {err} > {tol}")
    del params, cpu_params
    torch.cuda.empty_cache()


def _tree_to(tree, device, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def _main_phase(out_dir):
    import torch

    from icl_speech_text_llm_tpu_torch.cli import inference
    from icl_speech_text_llm_tpu_torch.ops import flash_attention as fa

    n_batches, max_new = 2, 10
    argv = ["--model_type", "salmonn-7b", "--dataset_type", "voxceleb", "--synthetic",
            "--input_mode", "speech_only", "--fewshot_mode", "speech",
            "--num_examples", "5", "--batch_size", "4", "--max_samples", "8",
            "--seq_len", "1024", "--text_len", "448", "--max_new_tokens", str(max_new),
            "--device", "cuda", "--results_dir", out_dir, "--run_name", "chip_smoke"]
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    paths = inference.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()

    with open(paths["results"]) as f:
        results = json.load(f)["results"]
    with open(paths["metrics"]) as f:
        metrics = json.load(f)
    if len(results) != 8:
        raise AssertionError(f"expected 8 results, got {len(results)}")
    for r in results:
        toks = r["tokens"]
        if len(toks) != max_new or not all(0 <= t < 32000 for t in toks):
            raise AssertionError(f"bad generated tokens {toks}")
    if metrics.get("voxceleb", {}).get("total_samples") != 8:
        raise AssertionError(f"metrics of 8 voxceleb results expected in {paths['metrics']}")
    need = {"flash_attention_noncausal": 32 * n_batches,
            "gated_bias_attention": 12 * n_batches,
            "flash_attention_causal": 32 * n_batches,
            "append_kv": (max_new - 1) * n_batches}
    for name, n in need.items():
        print(f"  launches {name}: {counts[name]} (need >= {n})", flush=True)
        if counts[name] < n:
            raise AssertionError(f"{name} launched {counts[name]} < {n} times")
    perf = metrics.get("perf", {})
    print(f"  main path: 8 requests in {wall:.3f} s wall (model build included); "
          f"serving {perf.get('examples_per_sec', float('nan')):.4f} utt/s, "
          f"p50 batch {perf.get('p50_batch_seconds', float('nan')):.4f} s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    print(f"  predictions: {[r['predicted_label'] for r in results]}", flush=True)
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
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    print("phase kernels:", flush=True)
    rows = _kernel_phase()
    print("phase check:", flush=True)
    _reference_phase()
    print("phase main:", flush=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        counts = _main_phase(d)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms")} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
