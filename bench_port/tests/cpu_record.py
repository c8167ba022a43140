"""Runs one cell of a test checkout on the CPU through its driver, with a
window of no time (one eval batch, or the train steps the reference
follows), and prints the readings that must not move while the harness
is rearranged: the checks, the work by operation and the model flops.

    python3 cpu_record.py ROOT WORKLOAD SEED
"""

import json
import os
import sys
import time

import checkout  # noqa: F401  (puts the benchmark and the port on sys.path)
import torch

if __name__ == "__main__":
    root, workload, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.set_num_threads(1)
    from benchlib import spec

    cell = spec.load(workload, root, os.path.join(root, "bench_port"))
    out = cell.driver.run(cell, seed, 0.0, False, "cpu", time.perf_counter())
    rec = out["record"]
    print(json.dumps({"checks": {k: c["value"] for k, c in out["checks"].items()},
                      "work": rec["work"], "model_flops": rec["model_flops"]}))
