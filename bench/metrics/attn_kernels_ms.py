"""Device ms a step of the three block-sparse kernels (by kernel name in the
profiler's trace) over the traced window."""
from bench.metrics.yardstick import KERNELS


def read(run):
    if run.traced is None or not run.traced_steps:
        return None
    trace = run.traced["trace"]
    seconds = sum(trace.kernels(f"{k}_kernel")[0] for k in KERNELS)
    return seconds / run.traced_steps * 1e3 if seconds else None
