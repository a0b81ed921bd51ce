"""Fault tolerance of a training run: heartbeats, the divergence sentinel,
step retries, fault injection and the fleet supervisor. Single-process:
the collectives of the JAX package's `distributed/runtime.py` wait in
ROADMAP.md item A12."""
from __future__ import annotations

import os


def process_count() -> int:
    """Processes of the job, as the fleet supervisor announces them
    (SPION_NUM_PROCESSES; 1 when unset)."""
    return int(os.environ.get("SPION_NUM_PROCESSES", "1"))


def process_index() -> int:
    """This process's index in the job (SPION_PROCESS_ID; 0 when unset)."""
    return int(os.environ.get("SPION_PROCESS_ID", "0"))
