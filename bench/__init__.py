"""The benchmark of `repro_torch`, the PyTorch and CUDA port of SPION.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root names the cells, configurations, traffic mixes
and metrics; the harness finds each one's files here by its name:

    configs/<config>.json    the model as it is run (sizes, SPION settings)
    traffic/<traffic>.json   the mix: kind, batch, lengths, generator, set-up
    traffic/gen/<name>.py    a generator that a mix names (seeded, host numpy)
    kinds/<kind>.py          the `Cell` that runs a mix's kind (training)
    limits/<cell>.json       the limits of the numbers that decide `correct`
    metrics/<metric>.py      one reader per metric, `read(run) -> float|None`
                             (metrics/yardstick.py: peaks, kernel work, FLOPs)
    reference/               the plain float32 reference the check runs

`calibrate.py` reads, at a cell's own size on the card, what its limits
are set from; `tests/` holds the CPU tests (`python -m pytest -q
bench/tests` from the root).

Nothing here imports `jax`, `flax` or the JAX package `repro`.
"""
