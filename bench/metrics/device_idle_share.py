"""The device's idle share of the traced window, in %: 1 - the union of the
intervals in which an operation ran on the card over the window."""


def read(run):
    if run.traced is None:
        return None
    trace = run.traced["trace"]
    if not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
