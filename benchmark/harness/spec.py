"""The benchmark's entries, found by name.

``BENCHMARK.json`` (at the root of the checkout) names every
configuration, cell and metric. Everything that belongs to one of them
sits in files of its own, which this module finds by that name:

* a configuration: the JSON file that its ``file`` entry names (the
  simulation's settings as they are run, with the files they read beside
  it);
* a traffic mix: ``traffic/<name>.json``, the parameters that the one
  driver of the simulation (``harness/cell.py``) reads (``TRAFFIC_KEYS``);
* a per-layer metric: ``metrics/<name>.py``, a reader with a ``read(rec)``
  function that returns the metric's value, or None where the run holds
  nothing to read;
* the limits of a cell's correctness check: ``limits/<cell>.json``.

A later cell, configuration or metric is therefore new files and new
entries, and no edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

#: the folder of the benchmark (it holds this package)
BENCH_DIR = Path(__file__).resolve().parent.parent
#: what every traffic file sets (``harness/cell.py`` reads each):
#: ``stochastic_density`` the background noise drawn from the seed (m^-3);
#: ``warmup`` the photoionization updates and mesh changes that set-up
#: holds; ``max_warmup_steps`` where set-up gives up; ``window_steps`` the
#: steps of a window of ``run_seconds``; ``whole_steps`` the steps in which
#: the epochs and updates repeat; ``trace_steps`` the steps traced on the
#: device
TRAFFIC_KEYS = ("stochastic_density", "warmup", "max_warmup_steps",
                "window_steps", "whole_steps", "trace_steps")


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    bound: Optional[float] = None
    workloads: Optional[List[str]] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _metrics(entries) -> List[Metric]:
    return [Metric(**{k: v for k, v in e.items()
                      if k in Metric.__dataclass_fields__})
            for e in entries]


class Spec:
    """The entries of one ``BENCHMARK.json``; ``bench_dir`` holds the
    traffic, metric and limit files (this folder unless a test gives
    another)."""

    def __init__(self, path: Path, bench_dir: Path = BENCH_DIR):
        self.path = Path(path)
        self.root = self.path.parent
        self.bench_dir = Path(bench_dir)
        self.data = json.loads(self.path.read_text())
        self.run_seconds = self.data["run_seconds"]
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.end_to_end = _metrics(self.data["end_to_end"])
        self.per_layer = _metrics(self.data["per_layer"])

    def config(self, name: str) -> dict:
        entry = self.configs[name]
        path = self.root / entry["file"]
        cfg = json.loads(path.read_text())
        cfg["_dir"] = str(path.parent)
        cfg["_name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        path = self.bench_dir / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        missing = [k for k in TRAFFIC_KEYS if k not in traffic]
        if missing:
            raise ValueError(f"{path} lacks {', '.join(missing)}")
        return traffic

    def limits(self, cell: str) -> dict:
        return json.loads(
            (self.bench_dir / "limits" / f"{cell}.json").read_text())

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in {self.path}; "
                           f"known: {sorted(self.workloads)}")
        w = self.workloads[name]
        return Cell(name=name, config=self.config(w["config"]),
                    traffic=self.traffic(w["traffic"]), chips=w["chips"],
                    limits=self.limits(name),
                    end_to_end=[m for m in self.end_to_end
                                if m.applies_to(name)],
                    per_layer=[m for m in self.per_layer
                               if m.applies_to(name)])

    def reader(self, metric: str):
        """The ``read(rec)`` function of ``metrics/<metric>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        mod_name = "bench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_per_layer(spec: Spec, cell: Cell, rec: dict) -> Dict[str, dict]:
    """The per-layer metrics of ``cell`` that its readers find in the
    record ``rec`` of a traced run; a reader that returns None leaves its
    metric out."""
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m.name)(rec)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
