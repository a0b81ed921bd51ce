"""The readings that the limits of `correct` are set from, at a cell's own
size, in one process on the card:

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--controls 3] [--witness 0] [--out chiprun_out/calibrate-<cell>.jsonl]

For each seed: the program's set-up and checked steps (no window), the
float32 reference from the same seed, and the numbers of harness/check.py
between them (the program's readings: a limit's lower end). For the first
`--controls` seeds also the control (the reference in the program's place,
every product's operands rounded to fp8 e4m3: the precision below the
configuration's bf16) and the planted fault "half of the batch left out,
the mean taken over the rest" (the reference in the program's place), each
against the same float32 reference: a limit's upper end. A fault "the step
returns its state unchanged" reads 1 by the update's measure and needs no
run. For the first `--witness` seeds also a second witness: the
program's own float32 path (the configuration with `dtype` float32: fp32
products and the kernels' fp32 versions) against a float32 reference that
follows its plan, to tell bf16 rounding from a fault of the program. One
JSON line a seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def witness(spec, seed, device):
    """The program's float32 path against the float32 reference on its
    own plan: (numbers, where, whether its tables equal the bf16 plan's)."""
    from bench.harness.check import compare, worst_leaves
    from bench.reference.follow import follow
    fp32 = copy.copy(spec)
    fp32.config = copy.deepcopy(spec.config)
    fp32.config["model"]["dtype"] = "float32"
    cell = spec.kind().Cell(fp32, seed, device)
    cell.setup()
    prog, pool, pooled = cell.readings, cell.pool, cell.pooled
    cell.free()
    ref = follow(spec.config, spec.traffic, seed, pool, device,
                 pooled_of=pooled)
    return compare(prog, ref), worst_leaves(prog, ref), prog["tables"]


def readings(spec, seed, device, controls, witnessed=False):
    """{side: numbers} for one seed: "program", with `controls` also
    "control" and "half", with `witnessed` also "witness"."""
    from bench.harness.check import compare, table_mismatch, worst_leaves
    from bench.reference.follow import follow
    cell = spec.kind().Cell(spec, seed, device)
    t = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t
    prog, pool, pooled = cell.readings, cell.pool, cell.pooled
    cell.free()
    t = time.perf_counter()
    ref = follow(spec.config, spec.traffic, seed, pool, device,
                 pooled_of=pooled)
    out = {"seed": seed, "setup_s": setup_s,
           "reference_s": time.perf_counter() - t,
           "program": compare(prog, ref), "where": worst_leaves(prog, ref)}
    if controls:
        for side, kw in (("control", {"precision": "fp8"}),
                         ("half", {"half": True})):
            other = follow(spec.config, spec.traffic, seed, pool, device,
                           pooled_of=pooled, **kw)
            out[side] = compare(other, ref)
    if witnessed:
        out["witness"], out["witness_where"], tables = witness(spec, seed,
                                                               device)
        if tables is not None:
            out["witness_plan_mismatch"] = table_mismatch(tables,
                                                          prog["tables"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "bench"))
    import run as bench_run
    bench_run.set_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench_run.import_program(ROOT)
    from bench.harness.spec import Spec
    spec = Spec(ROOT, args.workload)
    print(f"card: {bench_run.card_line()}", flush=True)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        line = json.dumps(readings(spec, seed, device, i < args.controls,
                                   i < args.witness))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
