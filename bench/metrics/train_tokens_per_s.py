"""Training throughput: every sequence position trained in the window
over the window's host seconds (from its start to the last step's stamp)."""


def read(run):
    return run.steps * run.positions / run.window_s
