"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
driver, limits and metric readers are found by name from
``BENCHMARK.json`` (``benchlib/spec.py``). ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled window. The last lines on standard error, and the line's last
key, give each number that ``correct`` compared beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

#: one host thread for the program's CPU work: the window is paced by the host
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

#: build and kernel caches at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton_cache"),
              "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions")}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device_info(cell, device):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell.entry["chips"])}


def _keep(root, args, data) -> None:
    """The traced run's readings in full, under ``build/bench_port/``."""
    out = os.path.join(root, "build", "bench_port")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{args.workload}.{args.seed}.json"), "w") as f:
        json.dump(data, f)


def main(argv=None, device=None, root=ROOT) -> int:
    """``device`` None: the card, which must be there; tests pass "cpu" and
    the ``root`` of a checkout of their own."""
    args = _args(argv)
    for key, path in CACHE_DIRS.items():
        os.environ[key] = path
    import torch

    from benchlib import guard, roofline, spec

    torch.set_num_threads(1)

    cell = spec.load(args.workload, root, os.path.join(root, os.path.basename(HERE)))
    if device is None:
        chips = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    out = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    rec = out["record"]
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.reader.read(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    if not args.trace:  # what the untraced window reads besides, on standard error only
        side = {m.name: m.reader.read(rec) for m in cell.per_layer}
        print("per-layer, not reported: " + json.dumps(
            {k: v for k, v in side.items() if v is not None}), file=sys.stderr)
    dev = _device_info(cell, device)
    power = roofline.power_limit() if dev["platform"] == "gpu" else None
    print(f"device {dev['kind']}, power limit {power}", file=sys.stderr)
    dev["memory_peak_bytes"] = rec["peak_bytes"]
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace and rec.get("trace"):
        t = rec["trace"]
        _keep(root, args, {"trace": t, "work": rec["work"], "launches": rec["launches"],
                           "opmap": rec["opmap"], "power_limit": power})
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = out["checks"]
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
