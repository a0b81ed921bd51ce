"""The three block-sparse kernels' share of their roofline over the traced
window, in %: the summed bound time of their launches (metrics/yardstick:
kept pairs only, each input byte read once and each output byte written
once, the larger of FLOPs over 989e12 and bytes over 3.35e12) over their
summed device time."""
from bench.metrics.yardstick import KERNELS, launch_bounds


def read(run):
    if run.traced is None or run.tables is None:
        return None
    trace = run.traced["trace"]
    bounds = launch_bounds(run.model, run.traffic, run.tables)
    seconds = bound = 0.0
    for k in KERNELS:
        s, n = trace.kernels(f"{k}_kernel")
        seconds += s
        bound += n * bounds[k]
    return 100.0 * bound / seconds if seconds else None
