"""Set-up: host seconds from the process's start to the window's
(imports, the pool, the parameters, the Trainer, the kernels' first build
and load, the set-up steps, the capture and the flood fill)."""


def read(run):
    return run.setup_s
