"""CLI for the self-healing fleet supervisor (distributed/supervisor.py).

    python -m repro_torch.launch.supervise --nproc 2 --ckpt-dir /ckpt \\
        [--dead-timeout 60] [--hang-timeout 120] [--max-respawns 5] \\
        -- python -m repro_torch.launch.train --ckpt-dir /ckpt --steps 10000

Everything after ``--`` is the worker command, run once per process with
SPION_COORDINATOR / SPION_NUM_PROCESSES / SPION_PROCESS_ID injected (fresh
coordinator port per generation), which the training CLI joins the job
with (distributed/runtime.initialize): N data-parallel ranks. The supervisor watches the heartbeat
files under --ckpt-dir and respawns the whole fleet — resuming from the
last committed checkpoint — whenever a worker dies, exits non-zero, or
freezes its step counter. Exit 0: all workers completed; exit 1: respawn
budget exhausted.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.distributed.supervisor import FleetSupervisor


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, worker_cmd = argv[:split], argv[split + 1:]
    else:
        worker_cmd = []
    ap = argparse.ArgumentParser(
        description="heartbeat-driven fleet supervisor with auto-respawn")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint dir; also where the hb_* files live")
    ap.add_argument("--dead-timeout", type=float, default=60.0,
                    help="seconds without a heartbeat write before a worker "
                         "is declared dead")
    ap.add_argument("--hang-timeout", type=float, default=120.0,
                    help="seconds without step progress (while the heartbeat "
                         "stays fresh) before a worker is declared hung; "
                         "must exceed the longest legitimate stall "
                         "(the kernels' first build at the phase "
                         "transition)")
    ap.add_argument("--poll-interval", type=float, default=1.0)
    ap.add_argument("--max-respawns", type=int, default=5)
    ap.add_argument("--backoff-base", type=float, default=1.0)
    ap.add_argument("--backoff-max", type=float, default=30.0)
    ap.add_argument("--straggler-limit", type=int, default=None,
                    help="respawn when a worker self-reports this many "
                         "straggler steps (off by default)")
    args = ap.parse_args(argv)
    if not worker_cmd:
        ap.error("missing worker command: ... -- <worker argv>")
    sup = FleetSupervisor(
        worker_cmd, args.nproc, args.ckpt_dir,
        dead_timeout=args.dead_timeout, hang_timeout=args.hang_timeout,
        poll_interval=args.poll_interval, max_respawns=args.max_respawns,
        backoff_base=args.backoff_base, backoff_max=args.backoff_max,
        straggler_limit=args.straggler_limit)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
