"""Fixtures of the benchmark's CPU tests: a tiny copy of the benchmark
(every configuration cut to a few hundred positions, the same files
otherwise) beside the checkout's program. Run from the checkout's root:

    python -m pytest -q bench/tests

A test that needs a CUDA card is marked `card` and skips without one,
deciding inside the test.
"""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {
    "spion-lra": dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                      d_ff=64, vocab_size=32),
    "internvl2-2b": dict(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=2, d_ff=128, vocab_size=256,
                         num_patch_tokens=16),
}
TINY_TRAFFIC = {"batch": 4, "seq_len": 128, "trace_seconds": 0.5}
# limits for the tiny sizes, from CPU readings of the program (bf16 against
# the float32 reference, at most 2.6e-4 loss, 4.2e-2 / 9.7e-3 worst and
# median gradient leaf, 9.1e-3 change, 2e-3 capture over two seeds) and of
# the fp8 control (at least 2.1e-3 loss, 1.4e-2 capture)
TINY_LIMITS = {"loss": 3.5e-4, "grad": 0.1, "grad_median": 0.02,
               "update": 0.5, "capture": 4e-3, "tables": 0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


def make_tiny(dst):
    """A copy of BENCHMARK.json and bench/ at `dst` with tiny sizes, its
    src/ the checkout's."""
    dst = pathlib.Path(dst)
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "src").symlink_to(ROOT / "src")
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    doc = json.loads((dst / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg["model"].update(TINY_MODEL[c["name"]])
        cfg["spion"].update(block_size=16, conv_filter_size=5)
        path.write_text(json.dumps(cfg))
    for w in doc["workloads"]:
        path = dst / "bench" / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(path.read_text())
        mix.update(TINY_TRAFFIC, ref_chunk=2)
        if "max_len" in mix:
            mix.update(min_len=20, max_len=120)
        if mix.get("patches"):
            mix["patches"] = 16
        path.write_text(json.dumps(mix))
        limits = dst / "bench" / "limits" / f"{w['name']}.json"
        keys = json.loads(limits.read_text())
        limits.write_text(json.dumps({k: TINY_LIMITS[k] for k in keys}))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def bench_run():
    """bench/run.py as a module."""
    from bench.harness.spec import load_module
    return load_module(ROOT / "bench" / "run.py", "bench_run_module")
