"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``, ``generators/<generator>.py``,
``reference/<reference>.py`` and ``metrics/<metric>.py`` under this
folder."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # port_bench/
ROOT = HERE.parent                                       # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def module(kind: str, name: str, here: Path = HERE):
    """``<here>/<kind>/<name>.py`` loaded by its path (a name may hold
    dots)."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    metrics resolved."""

    def __init__(self, name: str, root: Path = ROOT, here: Path = HERE):
        self.bench = benchmark(root)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
        self.name = name
        self.here = here
        self.entry = cells[name]
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(root / cfgs[self.entry["config"]]["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(here / "cells" / f"{name}.json")
        self.run_seconds = self.bench["run_seconds"]

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end ones
        (``trace`` false) or its per-layer ones."""
        e2e = [m for m in self.bench["end_to_end"] if self._in(m)]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self._in(m) if "workloads" in m else m["moves"] in mine)]

    def _in(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def generator(self):
        return module("generators", self.traffic["generator"], self.here)

    def reference(self):
        return module("reference", self.config["reference"], self.here)

    def reader(self, metric: str):
        return module("metrics", metric, self.here)
