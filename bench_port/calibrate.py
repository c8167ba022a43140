"""Readings that the limits of ``correct`` are set from, for one cell, in one
process on the card: for each seed, a short run of the program judged by
the reference (the lower reading is the largest over the seeds), and on
the control seeds also the control, the reference in the nearest
precision below the one the configuration states (the upper reading is
the smallest).

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 3 [--out <file.jsonl>]

Each seed's readings are printed as one JSON line (and appended to
``--out``); the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from benchlib import spec
    from reference import model as ref_model

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.load(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.driver.run(cell, seed, args.seconds, False, "cuda", t0,
                              control=ref_model.control(cell.config) if seed in controls
                              else None)
        row = {"workload": cell.name, "seed": seed, "correct": out["correct"],
               "checks": {k: c["value"] for k, c in out["checks"].items()},
               "control": out.get("control_checks"), "setup_s": out["record"]["setup_s"],
               "peak_bytes": out["record"]["peak_bytes"],
               "seconds": time.perf_counter() - t0}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
