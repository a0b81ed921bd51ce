"""BENCHMARK.json against the contract's shape, and the harness finding
every cell's files by name; a new cell, configuration, mix and metric
come with new files and entries alone."""
import json
import re

import torch

from bench.harness.spec import Spec
from conftest import ROOT, make_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["bench"] and 1 <= DOC["run_seconds"] <= 51
    e2e = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in e2e
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    names = [x["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DOC[s]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for s in ("end_to_end", "per_layer")
               for m in DOC[s])
    for w in DOC["workloads"]:
        spec = Spec(ROOT, w["name"])
        reported = {m["name"] for m in spec.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics("per_layer")
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_finds_its_files():
    for w in DOC["workloads"]:
        spec = Spec(ROOT, w["name"])
        assert spec.config["name"] == w["config"]
        assert hasattr(spec.kind(), "Cell")
        assert hasattr(spec.generator(), "make_pool")
        assert spec.limits
        for section in ("end_to_end", "per_layer"):
            for m in spec.metrics(section):
                assert callable(spec.reader(m["name"]))


def test_new_cell_by_new_files_only(tmp_path, bench_run):
    """A dummy cell with its own configuration, mix, limits and per-layer
    metric, added as files and BENCHMARK.json entries, runs."""
    root = make_tiny(tmp_path)
    bench = root / "bench"
    cfg = json.loads((bench / "configs" / "spion-lra.json").read_text())
    cfg["name"] = "dummy-lra"
    (bench / "configs" / "dummy-lra.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "lra-listops-dense.json")
                     .read_text())
    mix["batch"] = 2
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (bench / "limits" / "dummy-cell.json").write_text(
        (bench / "limits" / "lra-listops-dense.json").read_text())
    (bench / "metrics" / "dummy_steps.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "dummy-lra", "source": "x",
                           "file": "bench/configs/dummy-lra.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "dummy-cell", "config": "dummy-lra",
                             "traffic": "dummy-mix", "chips": 1,
                             "why": "a test"})
    doc["end_to_end"].append({"name": "dummy_steps", "unit": "steps",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    result, _ = bench_run.run_cell(root, "dummy-cell", 5, 0.5, 0,
                                   torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["metrics"]["dummy_steps"]["value"] == result["attempted"]
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s",
                                      "dummy_steps"}
