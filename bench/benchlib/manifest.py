"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, named after it:

    bench/configs/<config>.json     sizes, source, cut, the system it runs on
                                    and its plain reference
    bench/systems/<system>.py       builds the system under test from a config
    bench/reference/<reference>.py  the plain reference the check compares with
    bench/traffic/<traffic>.json    the mix's parameters
    bench/traffic/<kind>.py         the generator that drives a kind of mix
    bench/metrics/<metric>.py       one reader per metric
    bench/checks/<cell>.json        the limits of the cell's correctness check

so a later cell, mix, configuration or metric is added as new files and
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at ``path`` under ``name`` (once per process)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reference(name: str):
    """The plain reference ``bench/reference/<name>.py``."""
    return load_module(BENCH / "reference" / f"{name}.py",
                       f"bench_reference_{name}")


class Manifest:
    """``BENCHMARK.json`` and the files its names point at."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "bench"
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")

    def config(self, name: str) -> dict:
        return load_json(self.bench / "configs" / f"{name}.json")

    def mix(self, name: str) -> dict:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.bench / "checks" / f"{cell}.json")

    def system(self, name: str):
        return load_module(self.bench / "systems" / f"{name}.py",
                           f"bench_system_{name}")

    def generator(self, kind: str):
        return load_module(self.bench / "traffic" / f"{kind}.py",
                           f"bench_traffic_{kind}")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "__"))

    def metrics_for(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (``trace`` true), in manifest order: those that list the
        cell under ``workloads``, and those without the key.  A per-layer
        metric without the key belongs to every cell that reports the
        end-to-end metric it moves."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
