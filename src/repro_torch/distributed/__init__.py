"""Fault tolerance and multi-process plumbing of a training run:
heartbeats, the divergence sentinel, step retries, fault injection and the
fleet supervisor, the process group and its collectives (`runtime`), and
the mesh's sharding decisions (`sharding`). The two functions here read
the launcher's environment without torch, for the supervisor; a joined
process asks `runtime.process_count()` / `runtime.process_index()`."""
from __future__ import annotations

import os


def process_count() -> int:
    """Processes of the job, as the fleet supervisor announces them
    (SPION_NUM_PROCESSES; 1 when unset)."""
    return int(os.environ.get("SPION_NUM_PROCESSES", "1"))


def process_index() -> int:
    """This process's index in the job (SPION_PROCESS_ID; 0 when unset)."""
    return int(os.environ.get("SPION_PROCESS_ID", "0"))
