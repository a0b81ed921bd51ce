"""The device memory peak over the window, torch.cuda.max_memory_allocated
after a reset at its start, in GB (1e9 bytes)."""


def read(run):
    return run.window["peak_bytes"] / 1e9 or None
