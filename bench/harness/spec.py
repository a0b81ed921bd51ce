"""BENCHMARK.json and the files it names, found by name under bench/.

A cell (`workloads` entry) names a configuration and a traffic mix; its
limits sit in limits/<cell>.json; a metric is a reader module; the mix's
`kind` is a module under kinds/ and its `generator` one under
traffic/gen/. Adding a cell, a configuration, a mix or a metric adds files
and entries only: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib


class SpecError(ValueError):
    """The spec names something that is not there."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the file `path` as a module called `name` (file names may hold
    dots and dashes, which an import statement cannot name)."""
    path = pathlib.Path(path)
    if not path.exists():
        raise SpecError(f"no file {path}")
    safe = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(safe, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json at `root` and the cell `name` in it."""

    def __init__(self, root, name):
        self.root = pathlib.Path(root)
        self.bench = self.root / "bench"
        self.doc = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json; have "
                            f"{sorted(cells)}")
        self.cell = cells[name]
        configs = {c["name"]: c for c in self.doc["configs"]}
        if self.cell["config"] not in configs:
            raise SpecError(f"workload {name!r} names no configuration "
                            f"{self.cell['config']!r}")
        self.config = load_json(self.root /
                                configs[self.cell["config"]]["file"])
        self.traffic = load_json(self.bench / "traffic" /
                                 f"{self.cell['traffic']}.json")
        self.limits = load_json(self.bench / "limits" / f"{name}.json")

    @property
    def name(self):
        return self.cell["name"]

    def metrics(self, section):
        """The entries of `section` ("end_to_end" or "per_layer") that this
        cell reports: those without `workloads`, and those listing it."""
        return [m for m in self.doc[section]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric):
        """The `read(run)` function of bench/metrics/<metric>.py."""
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric}").read

    def generator(self):
        """The module bench/traffic/gen/<generator>.py of the mix."""
        gen = self.traffic["generator"]
        return load_module(self.bench / "traffic" / "gen" / f"{gen}.py",
                           f"bench_gen_{gen}")

    def kind(self):
        """The module bench/kinds/<kind>.py that runs the mix's kind of
        cell (its `Cell` class)."""
        kind = self.traffic["kind"]
        return load_module(self.bench / "kinds" / f"{kind}.py",
                           f"bench_kind_{kind}")
