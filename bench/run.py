"""The benchmark of `repro_torch`, the PyTorch and CUDA port of SPION, on
NVIDIA cards. From the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` names the cells; bench/harness/spec.py finds each one's
configuration, traffic mix, limits, kind and metric readers by name. One
run: set-up from the seed, the measured window, with `--trace 1` a traced
window after it, then the check against the plain reference, and as the
last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines of
standard error).

The run fails, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the program is not the checkout's own
(src/repro_torch), and when `jax`, `jaxlib`, `flax` or the JAX package
`repro` is loaded in this process once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """The run cannot give a result."""


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_env(root):
    """Every cache the run's libraries keep, at fixed paths in the checkout
    (the kernel library builds under build/ by itself; torch makes its
    inductor directory on import); no tuned kernel config is read from
    HOME. One host thread for CPU operators: the timed path runs on the
    card, launched from one thread."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    build = root / "build"
    for var, sub in (("SPION_AUTOTUNE_DIR", "bench_autotune"),
                     ("TRITON_CACHE_DIR", "bench_triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "bench_inductor")):
        os.environ[var] = str(build / sub)


def import_program(root):
    """Import the checkout's own `repro_torch` (src/), never another."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    try:
        import repro_torch
    except ImportError as e:
        raise RunError(f"the program is not in this checkout: {e}") from e
    where = pathlib.Path(repro_torch.__file__).resolve()
    if (root / "src") not in where.parents:
        raise RunError(f"repro_torch comes from {where}, not from "
                       f"{root / 'src'}")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode:
        return f"nvidia-smi failed: {out.stderr.strip()[:200]}"
    return out.stdout.strip().splitlines()[0]


def prefixes(run, every=10.0):
    """{seconds: [tokens/s, step ms p95]} over the window's first 10, 20,
    ... seconds: what a shorter window would have read."""
    import numpy as np
    t = np.asarray(run.window["stamps"]) - run.window["t0"]
    dt = run.intervals() * 1e3
    out = {}
    for end in np.arange(every, t[-1], every):
        n = int((t <= end).sum())
        if n:
            out[f"{end:g}"] = [n * run.positions / t[n - 1],
                               float(np.percentile(dt[:n], 95))]
    return out


def run_cell(root, name, seed, seconds, trace, device):
    """One run of the cell `name` on `device`; returns (result, lines to
    print before it)."""
    import numpy as np
    import torch

    from bench.harness.check import judge
    from bench.harness.record import Run
    from bench.harness.spec import Spec
    spec = Spec(root, name)
    cell = spec.kind().Cell(spec, seed, device)
    cell.setup()
    window = cell.window(seconds)
    setup_s = window["t0"] - T_START
    traced = cell.traced_window() if trace else None
    run = Run(spec, setup_s, window, traced, cell.tables,
              cell.loss_positions)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(section):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dt = run.intervals() * 1e3
    detail = {"cell": name, "seed": seed, "steps": run.steps,
              "window_s": run.window_s, "setup_s": setup_s,
              "step_ms": {q: float(np.percentile(dt, p)) for q, p in
                          (("p50", 50), ("p90", 90), ("p95", 95),
                           ("max", 100))},
              "losses": [window["losses"][0], window["losses"][-1]],
              "setup_parts": cell.setup_parts, "pool": cell.pool_detail,
              "setup_peak_bytes": window["setup_peak_bytes"],
              "launches_per_step": {k: n / run.steps for k, n in
                                    window["launches"].items()}}
    detail["prefix"] = prefixes(run)
    if cell.tables is not None:
        nv = cell.tables["nvalid"]
        detail["plan"] = {"density": float(nv.sum() / (nv.size *
                                                       nv.shape[-1])),
                          "K": int(cell.tables["col_idx"].shape[-1]),
                          "kt_star": int(cell.tables["row_idx"].shape[-1]),
                          "program_density": cell.density}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": window["peak_bytes"]}
    breakdown = None
    if traced is not None:
        tr = traced["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = tr.breakdown()
    cell.free()
    t_check = time.perf_counter()
    numbers = cell.check()
    correct, rows = judge(numbers, spec.limits)
    failed = sum(1 for x in window["losses"] if not np.isfinite(x))
    detail["check_s"] = time.perf_counter() - t_check
    detail["numbers"] = numbers
    result = {"correct": correct and failed == 0, "attempted": run.steps,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, [json.dumps({"detail": detail})]


def main(argv=None):
    args = parse(argv)
    set_env(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench.harness.spec import Spec
    chips = Spec(ROOT, args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import_program(ROOT)
    print(f"card: {card_line()}", flush=True)
    result, lines = run_cell(ROOT, args.workload, args.seed, args.seconds,
                             args.trace, torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, flush=True)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RunError as e:
        print(f"bench: {e}", file=sys.stderr)
        sys.exit(2)
