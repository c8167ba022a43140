"""A checkout of the benchmark for CPU tests: the repository's ``bench_port``
copied under a temporary root, with tiny cells added from files alone
(a configuration, a traffic mix, limits, and any model family's two
modules) and a ``BENCHMARK.json`` that names them, with every metric of
the real one."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FIXTURES = os.path.join(BENCH, "tests", "fixtures")

for path in (BENCH, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)


def make(root: str, cells, families=()):
    """``cells``: (cell name, config fixture, traffic fixture, limits dict);
    ``families``: (family name, harness module fixture, reference module
    fixture). → the checkout's root."""
    bench = os.path.join(root, "bench_port")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, harness, reference in families:
        shutil.copy(os.path.join(FIXTURES, harness),
                    os.path.join(bench, "benchlib", "families", name + ".py"))
        shutil.copy(os.path.join(FIXTURES, reference),
                    os.path.join(bench, "reference", "families", name + ".py"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        real = json.load(f)
    configs, workloads, loops = {}, [], {}
    for name, config, traffic, limits in cells:
        cfg_name = os.path.splitext(config)[0]
        shutil.copy(os.path.join(FIXTURES, config), os.path.join(bench, "configs", config))
        configs[cfg_name] = {"name": cfg_name, "source": "tests", "reduced": [], "why": "tests",
                             "file": f"bench_port/configs/{config}"}
        tname = os.path.splitext(traffic)[0]
        shutil.copy(os.path.join(FIXTURES, traffic), os.path.join(bench, "traffic", traffic))
        with open(os.path.join(FIXTURES, traffic)) as f:
            loops[name] = json.load(f)["loop"]
        with open(os.path.join(bench, "limits", name + ".json"), "w") as f:
            json.dump(limits, f)
        workloads.append({"name": name, "config": cfg_name, "traffic": tname, "chips": 1,
                          "why": "tests"})

    def retarget(metric):
        if "workloads" in metric:
            loop = "train" if "train" in metric["name"] else "eval"
            metric = dict(metric, workloads=[w for w, l in loops.items() if l == loop])
        return metric

    spec = dict(real, configs=list(configs.values()), workloads=workloads,
                end_to_end=[retarget(m) for m in real["end_to_end"]],
                per_layer=[retarget(m) for m in real["per_layer"]])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
