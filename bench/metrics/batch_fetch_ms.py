"""The Trainer's batch fetch (`Trainer._next_batch`: `data_fn` and the
host-to-device copy), host ms a step inside the benchmark's span, over the
traced window."""
from bench.kinds.training import FETCH_SPAN


def read(run):
    if run.traced is None or not run.traced_steps:
        return None
    seconds, count = run.traced["trace"].span_s(FETCH_SPAN)
    return seconds / run.traced_steps * 1e3 if count else None
