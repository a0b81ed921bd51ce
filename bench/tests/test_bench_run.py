"""Whole runs of the harness on the CPU at the tiny sizes: a sound run is
correct in every cell; a run whose timed path is broken underneath, or
the control in the program's place, is not; no module of the JAX package
or JAX is loaded; a run without a card or without the program fails."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench.harness.check import compare, judge
from bench.harness.spec import Spec
from conftest import ROOT

CELLS = ["lra-listops-sparse", "internvl2-8k-sparse", "lra-listops-dense"]
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, bench_run, cell):
    result, lines = bench_run.run_cell(tiny, cell, 2 ** 31 + 5, 0.5, 1, CPU)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert {"mfu", "batch_fetch_ms"} <= set(result["metrics"])
    assert json.loads(lines[0])["detail"]["steps"] == result["attempted"]


def unchanged(monkeypatch):
    """Each step returns its state unchanged."""
    import repro_torch.launch.steps as steps
    monkeypatch.setattr(steps, "adamw_update",
                        lambda params, grads, state, **kw: (params, state))


def half_batch(monkeypatch):
    """Half of the batch left out, the loss the mean over the rest."""
    from repro_torch.launch.train import Trainer
    inner = Trainer._device_batch
    monkeypatch.setattr(Trainer, "_device_batch", lambda self, b: inner(
        self, {k: v[:len(v) // 2] for k, v in b.items()}))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_broken_step_is_not_correct(tiny, bench_run, monkeypatch, cell,
                                    fault):
    fault(monkeypatch)
    result, _ = bench_run.run_cell(tiny, cell, 8, 0.3, 0, CPU)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    """The reference in fp8 in the program's place, on two seeds."""
    from bench import calibrate
    spec = Spec(tiny, cell)
    for seed in (1, 2 ** 31 + 7):
        out = calibrate.readings(spec, seed, CPU, controls=True)
        assert judge(out["program"], spec.limits)[0], out["program"]
        assert not judge(out["control"], spec.limits)[0], out["control"]
        assert not judge(out["half"], spec.limits)[0], out["half"]


def test_compare_counts_table_mismatches():
    ref = {"losses": [1.0], "grad": {"dense": {"a": 1.0, "b": 2.0}},
           "update": {"a": 1.0, "b": 2.0}, "pooled": [[[1.0]]],
           "tables": {"col_idx": [[1, 2]]}}
    prog = dict(ref, tables={"col_idx": [[1, 3]]})
    assert compare(prog, ref)["tables"] == 1
    prog = dict(ref, update={"a": 0.0, "b": 0.0})
    assert compare(prog, ref)["update"] == 1.0


SCAN = """
import sys, json, pathlib, torch
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
from bench.harness.spec import load_module
run = load_module(root / "bench" / "run.py", "bench_run_module")
run.run_cell(root, "lra-listops-sparse", 3, 0.3, 1, torch.device("cpu"))
print(json.dumps(run.forbidden_modules()))
"""


def test_no_jax_module_is_loaded(tiny):
    out = subprocess.run([sys.executable, "-c", SCAN, str(tiny)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def command(root, *extra, env=None):
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "lra-listops-sparse", "--seed", "1", "--seconds",
                           "1", *extra], cwd=root, capture_output=True,
                          text=True, timeout=600, env=env)


def test_no_card_fails(tiny):
    out = command(tiny, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_without_the_program_fails(tmp_path, bench_run):
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    with pytest.raises(bench_run.RunError):
        bench_run.import_program(tmp_path)
    assert command(tmp_path).returncode != 0


@pytest.mark.card
def test_card_run_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = command(ROOT, "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
