"""The step-time tail: the 95th percentile of the window's step intervals
(host clock, each ending at a step's stamp), where at least ten intervals
lie beyond it."""
import numpy as np

MIN_STEPS = 200


def read(run):
    dt = run.intervals()
    if len(dt) < MIN_STEPS:
        return None
    return float(np.percentile(dt, 95)) * 1e3
