"""Heartbeat-driven fleet supervisor: auto-respawn for unattended training
(the JAX package's `distributed/supervisor.py`).

The in-loop machinery (StepSupervisor retries, the preemption handler, the
divergence sentinel's rollback) can only heal a process that is still
*running its loop*. A worker that is SIGKILLed, stopped by a sticky CUDA
error, wedged, or spinning outside the step loop needs an EXTERNAL pair of
eyes — this module is that: a daemon (``python -m
repro_torch.launch.supervise``) that spawns the workers, watches their
heartbeat files, and on any fault kills the whole fleet and respawns it
from the last committed checkpoint.

Failure taxonomy — what the heartbeat JSON payload {ts, step, phase, ...}
lets the supervisor distinguish:

  exit(rc!=0)  the OS already told us: respawn
  exit(0)      worker reached its target: done (excluded from liveness)
  dead         heartbeat ts stale (> dead_timeout): the process is gone or
               so wedged its beat thread stopped — SIGKILLed workers land
               here (their file freezes at the last write)
  hung         ts FRESH but the step counter frozen (> hang_timeout): the
               beat thread still runs, the main thread does not — a stuck
               kernel, a livelock, a chaos-injected hang. The check only
               arms after the first step is published: before that, the
               kernels' first build looks identical to a hang.
  straggler    the worker self-reports `stragglers` (repeat straggler-step
               count from StragglerMonitor) past `straggler_limit` — the
               policy knob for "slow is as bad as dead" fleets (off by
               default)

Respawn is whole-fleet: any fault tears down every worker (process-group
SIGKILL — workers are spawned with start_new_session=True precisely so
their descendants die with them), the heartbeat files are cleared, and a
NEW generation starts, resuming from the last committed checkpoint. Capped
exponential backoff between generations; a max-respawn budget turns a
crash-loop into a clean failure instead of an infinite burn. Each worker
gets SPION_COORDINATOR / SPION_NUM_PROCESSES / SPION_PROCESS_ID; the port's
Trainer refuses SPION_NUM_PROCESSES > 1 until ROADMAP.md item A12, so run it
with --nproc 1.

Everything here is plain-process logic that never imports torch: the
supervisor must stay alive and responsive precisely when the CUDA runtime
inside the workers is the thing that is broken.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.distributed.fault import Heartbeat


def free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class StepTracker:
    """Remembers the last step value a worker published and when it last
    *changed* — the hang watchdog's notion of progress."""

    def __init__(self):
        self.step: Optional[int] = None
        self.since: Optional[float] = None

    def update(self, step: Optional[int], now: float):
        if step is None:
            return
        if self.step is None or int(step) != self.step:
            self.step = int(step)
            self.since = now


def classify(now: float, spawned_at: float, payload: Optional[dict],
             tracker: StepTracker, *, dead_timeout: float,
             hang_timeout: float,
             straggler_limit: Optional[int] = None) -> Optional[str]:
    """One worker's liveness verdict from its heartbeat payload: None
    (healthy), 'dead', 'hung', or 'straggler'. Pure — fully unit-testable
    with synthetic clocks. A missing payload counts from `spawned_at`
    (grace for a worker that has not written its first beat yet)."""
    last_ts = float(payload["ts"]) if payload and "ts" in payload else spawned_at
    if now - last_ts > dead_timeout:
        return "dead"
    if payload is not None:
        tracker.update(payload.get("step"), now)
    if (hang_timeout and tracker.step is not None
            and now - tracker.since > hang_timeout):
        return "hung"
    if (straggler_limit and payload
            and payload.get("stragglers", 0) >= straggler_limit):
        return "straggler"
    return None


class FleetSupervisor:
    """Spawn → watch → kill → respawn loop around a fixed worker command.

    `worker_cmd` is the argv to run per process; each worker gets
    SPION_COORDINATOR / SPION_NUM_PROCESSES / SPION_PROCESS_ID in its
    environment (a fresh coordinator port per generation — the old port may
    linger in TIME_WAIT after a kill). Workers inherit the supervisor's
    stdout/stderr so logs interleave into one stream a launcher can tail.
    """

    def __init__(self, worker_cmd: Sequence[str], nproc: int, ckpt_dir: str,
                 *, dead_timeout: float = 60.0, hang_timeout: float = 120.0,
                 poll_interval: float = 1.0, max_respawns: int = 5,
                 backoff_base: float = 1.0, backoff_max: float = 30.0,
                 straggler_limit: Optional[int] = None,
                 coordinator_host: str = "localhost",
                 env: Optional[dict] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 log: Callable[[str], None] = print):
        self.worker_cmd = list(worker_cmd)
        self.nproc = nproc
        self.ckpt_dir = ckpt_dir
        self.dead_timeout = dead_timeout
        self.hang_timeout = hang_timeout
        self.poll_interval = poll_interval
        self.max_respawns = max_respawns
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.straggler_limit = straggler_limit
        self.coordinator_host = coordinator_host
        self.env = dict(os.environ) if env is None else dict(env)
        self.sleep_fn = sleep_fn
        self.log = log
        self.respawns = 0
        self.generation = 0
        self._procs: List[subprocess.Popen] = []

    # -- heartbeat plumbing -------------------------------------------------

    def _hb_path(self, i: int) -> str:
        return os.path.join(self.ckpt_dir, f"hb_{i}")

    def _clear_heartbeats(self):
        """Stale payloads from a dead generation would read as instant
        faults (old ts) or instant hangs (old step) for the new one."""
        for i in range(self.nproc):
            try:
                os.remove(self._hb_path(i))
            except OSError:
                pass

    # -- fleet lifecycle ----------------------------------------------------

    def _spawn_fleet(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._clear_heartbeats()
        port = free_port()
        self._procs = []
        for i in range(self.nproc):
            env = dict(self.env)
            env["SPION_COORDINATOR"] = f"{self.coordinator_host}:{port}"
            env["SPION_NUM_PROCESSES"] = str(self.nproc)
            env["SPION_PROCESS_ID"] = str(i)
            self._procs.append(subprocess.Popen(
                self.worker_cmd, env=env, start_new_session=True))
        self.log(f"SUPERVISOR spawn gen={self.generation} nproc={self.nproc} "
                 f"port={port}")

    def _kill_fleet(self):
        """SIGKILL every worker's process GROUP: a wedged worker will not
        honour SIGTERM, and any helper processes it forked must not outlive
        it (they would hold the coordinator port / checkpoint locks)."""
        for p in self._procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    pass
        for p in self._procs:
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        self._procs = []

    # -- one generation -----------------------------------------------------

    def _watch_generation(self) -> Optional[str]:
        """Block until this generation finishes cleanly (returns None) or a
        fault is detected (returns the reason string)."""
        spawned_at = time.time()
        trackers = [StepTracker() for _ in range(self.nproc)]
        while True:
            running = 0
            for i, p in enumerate(self._procs):
                rc = p.poll()
                if rc is not None:
                    if rc != 0:
                        return f"worker={i} exit={rc}"
                    continue  # exited 0: done, excluded from liveness
                running += 1
                verdict = classify(
                    time.time(), spawned_at, Heartbeat.read(self._hb_path(i)),
                    trackers[i], dead_timeout=self.dead_timeout,
                    hang_timeout=self.hang_timeout,
                    straggler_limit=self.straggler_limit)
                if verdict:
                    return f"worker={i} {verdict}"
            if running == 0:
                return None
            self.sleep_fn(self.poll_interval)

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_base * (2.0 ** attempt), self.backoff_max)

    def run(self) -> int:
        """Supervise until the fleet completes (0) or the respawn budget is
        exhausted (1). Every respawn resumes from the last committed
        checkpoint — the workers' own maybe_resume() does that; the
        supervisor only guarantees they get to run."""
        try:
            while True:
                self._spawn_fleet()
                reason = self._watch_generation()
                if reason is None:
                    self.log(f"SUPERVISOR done gen={self.generation}")
                    return 0
                self.log(f"SUPERVISOR fault gen={self.generation} {reason}")
                self._kill_fleet()
                if self.respawns >= self.max_respawns:
                    self.log(f"SUPERVISOR giveup respawns={self.respawns}")
                    return 1
                delay = self.backoff(self.respawns)
                self.respawns += 1
                self.generation += 1
                self.log(f"SUPERVISOR respawn gen={self.generation} "
                         f"backoff={delay:.2f}s")
                self.sleep_fn(delay)
        finally:
            self._kill_fleet()  # never leave orphans, even on KeyboardInterrupt
