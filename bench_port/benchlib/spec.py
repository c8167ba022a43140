"""Finds everything one cell needs by the names in ``BENCHMARK.json``:

- the configuration: the file its entry names;
- the model family that the configuration names (``"family"``): the
  harness's side ``benchlib/families/<family>.py``, through which the
  drivers reach the port's model, and the reference's side
  ``reference/families/<family>.py``; the operations of the roofline
  map, ``opmap.json``'s with those the family adds;
- the traffic mix: ``traffic/<traffic>.json``, whose ``loop`` names the
  driver ``drivers/<loop>.py``;
- the limits of ``correct``: ``limits/<cell>.json``;
- each metric the cell reports: ``metrics/<metric>.py``, whose ``read``
  takes the run's record and returns a number or None.

A cell, a configuration, a model family, a traffic mix or a metric is
added by adding files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Tuple

from . import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_module(path: str) -> ModuleType:
    name = "bench_port_" + os.path.relpath(path, HERE).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    entry: Dict
    reader: ModuleType

    @property
    def name(self) -> str:
        return self.entry["name"]

    @property
    def unit(self) -> str:
        return self.entry["unit"]


@dataclass
class Cell:
    name: str
    entry: Dict
    config: Dict
    family: ModuleType
    reference: ModuleType
    opmap: Dict[str, List[str]]
    traffic: Dict
    limits: Dict
    driver: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]
    run_seconds: int


def _applies(metric: Dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def families(name: str, bench: str = HERE) -> Tuple[ModuleType, ModuleType]:
    """(harness side, reference side) of the model family ``name``."""
    if not re.fullmatch(r"[A-Za-z0-9_]{1,64}", name):
        raise ValueError(f"family {name!r}: letters, digits and _ only")
    return (load_module(os.path.join(bench, "benchlib", "families", name + ".py")),
            load_module(os.path.join(bench, "reference", "families", name + ".py")))


def load(workload: str, root: str = ROOT, bench: str = HERE) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, its files read
    from ``bench``."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    family, reference = families(config["family"], bench)
    opmap = roofline.load_opmap(os.path.join(bench, "opmap.json"), family.OPS)
    traffic = _json(os.path.join(bench, "traffic", entry["traffic"] + ".json"))
    limits_path = os.path.join(bench, "limits", workload + ".json")
    limits = _json(limits_path) if os.path.isfile(limits_path) else {}
    driver = load_module(os.path.join(bench, "drivers", traffic["loop"] + ".py"))

    def metrics(kind, reported):
        out = []
        for m in spec[kind]:
            if _applies(m, workload, reported):
                out.append(Metric(m, load_module(os.path.join(bench, "metrics",
                                                              m["name"] + ".py"))))
        return out

    e2e = metrics("end_to_end", set())
    per_layer = metrics("per_layer", {m.name for m in e2e})
    return Cell(workload, entry, config, family, reference, opmap, traffic, limits, driver, e2e,
                per_layer, int(spec["run_seconds"]))
