"""Fault tolerance and straggler detection of the training loop: the JAX
package's `distributed/fault.py`, single-process, with the retry set
narrowed (see StepSupervisor).

Everything here is deterministic host-side logic; launch/train.py wires it
into the step loop:

  - StepSupervisor: wraps the step; on an I/O failure restores the last
    checkpoint and replays. Failures of the card, a kernel or the code
    re-raise at once.
  - StragglerMonitor: per-step wall-time EWMA + z-score flags (repeat
    offenders ride the heartbeat payload into the external supervisor's
    respawn decision).
  - DivergenceSentinel: per-step loss NaN/inf + EWMA-spike detector, the
    in-loop half of the rollback protocol.
  - Heartbeat: per-process liveness file with a JSON payload
    {ts, step, pid, phase, ...} so the external supervisor
    (distributed/supervisor.py) can tell "process gone" (stale ts) from
    "process alive but step frozen" (fresh ts, stale step).

The module imports the standard library only, so the supervisor process,
which reads heartbeats, never loads torch.
"""
from __future__ import annotations

import json
import math
import os
import random
import threading
import time
from typing import Callable, Optional


class StragglerMonitor:
    """EWMA of step times; flags steps (hosts) whose time exceeds
    mean + z * std. At fleet scale the same logic runs per-host on the
    controller with heartbeat timestamps."""

    REL_STD_FLOOR = 0.05   # ignore jitter below 5% of the mean step time

    def __init__(self, alpha: float = 0.1, z: float = 3.0, warmup: int = 5):
        self.alpha = alpha
        self.z = z
        self.warmup = warmup
        self.mean = 0.0
        self._m2 = 0.0        # Welford sum during warmup
        self.var = 0.0        # EWMA variance after warmup
        self.n = 0

    def observe(self, dt: float) -> bool:
        """Returns True if `dt` is a straggler observation."""
        self.n += 1
        if self.n <= self.warmup:
            delta = dt - self.mean
            self.mean += delta / self.n
            self._m2 += delta * (dt - self.mean)
            if self.n == self.warmup:
                self.var = self._m2 / max(self.n - 1, 1)
            return False
        std = math.sqrt(max(self.var, (self.REL_STD_FLOOR * self.mean) ** 2))
        is_straggler = dt > self.mean + self.z * std
        if not is_straggler:  # don't poison stats with outliers
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + \
                self.alpha * (dt - self.mean) ** 2
        return is_straggler


class StepSupervisor:
    """Run steps with crash-restart: on an I/O failure (`OSError`: a
    checkpoint or data read, a full disk; ConnectionError is one too),
    restore() is called and the step retried up to `max_retries` times,
    with exponential backoff + jitter between attempts.

    The JAX package also retries RuntimeError. In PyTorch that class holds
    what no replay in the same process can heal: a sticky CUDA error
    (torch.AcceleratorError), out of memory, NotImplementedError, and the
    port's kernel failures (kernels.block_sparse_attn.KernelError: nvcc
    missing or failing, a library that does not load, a failed launch).
    Those, and programming errors (TypeError, ValueError), re-raise at
    once; the process ends and the fleet supervisor respawns it from the
    last checkpoint.

    A restore_fn that returns False had nothing to restore: the error
    re-raises, since the failed step may already have changed state that
    the port updates in place (masters, moments)."""

    RETRYABLE = (OSError,)

    def __init__(self, restore_fn: Callable[[], None], max_retries: int = 3,
                 on_failure: Optional[Callable[[Exception], None]] = None,
                 backoff_base: float = 0.5, backoff_max: float = 30.0,
                 jitter: float = 0.25,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.restore_fn = restore_fn
        self.max_retries = max_retries
        self.on_failure = on_failure
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.jitter = jitter
        self.sleep_fn = sleep_fn
        self.rng = rng or random.Random()
        self.restarts = 0

    def backoff(self, attempt: int) -> float:
        """Delay before retry `attempt` (0-based): capped exponential with
        multiplicative jitter in [1, 1 + jitter)."""
        base = min(self.backoff_base * (2.0 ** attempt), self.backoff_max)
        return base * (1.0 + self.jitter * self.rng.random())

    def run(self, step_fn: Callable, *args, **kwargs):
        for attempt in range(self.max_retries + 1):
            try:
                return step_fn(*args, **kwargs)
            except self.RETRYABLE as e:
                self.restarts += 1
                if self.on_failure:
                    self.on_failure(e)
                if attempt == self.max_retries:
                    raise
                self.sleep_fn(self.backoff(attempt))
                if self.restore_fn() is False:
                    raise


class DivergenceSentinel:
    """Per-step loss health check: NaN/inf always flags; a finite loss
    flags when it spikes past mean + z * std of the loss EWMA (the same
    z-score machinery StragglerMonitor applies to step wall-times). A
    flagged step starts the trainer's rollback at the top of the next
    iteration. reset() after a rollback: the restored loss
    trajectory restarts the EWMA rather than inheriting spike-adjacent
    stats."""

    def __init__(self, z: float = 8.0, warmup: int = 10, alpha: float = 0.05,
                 spike: bool = True):
        self.z = z
        self.warmup = warmup
        self.alpha = alpha
        self.spike = spike
        self.reset()

    def reset(self):
        self._mon = StragglerMonitor(alpha=self.alpha, z=self.z,
                                     warmup=self.warmup)

    def observe(self, loss: float) -> bool:
        """True if `loss` is divergent (non-finite, or an upward spike)."""
        if not math.isfinite(loss):
            return True
        if not self.spike:
            return False
        return self._mon.observe(loss)


class Heartbeat:
    """Host liveness file heartbeat. Each write is one JSON object
    ``{"ts": ..., "pid": ..., "step": ..., "phase": ..., ...}`` committed
    atomically (tmp + rename), so the external supervisor scanning the
    files can distinguish "process gone" (stale ts) from "process alive but
    step frozen" (fresh ts, stale step). `start_thread()` keeps ts fresh
    from a daemon thread even while the main thread is stuck inside a step
    (a hung kernel, the kernels' first build) — exactly the case the
    step-progress check exists for; the thread only touches the local
    filesystem, so it is safe off the main thread."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self.last = 0.0
        self._status: dict = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def beat(self, now: Optional[float] = None, step: Optional[int] = None,
             phase: Optional[str] = None, extra: Optional[dict] = None):
        """Update the payload fields and (at most every `interval`) write
        the file. `now or time.time()` would treat an explicit now=0.0
        (epoch, or a test's monotonic-from-zero clock) as "not provided"."""
        if now is None:
            now = time.time()
        with self._lock:
            if step is not None:
                self._status["step"] = int(step)
            if phase is not None:
                self._status["phase"] = str(phase)
            if extra:
                self._status.update(extra)
            if now - self.last >= self.interval:
                self._write(now)

    def pulse(self, now: Optional[float] = None):
        """Unconditional write with the latest status (the thread's beat)."""
        with self._lock:
            self._write(time.time() if now is None else now)

    def _write(self, now: float):
        # lock held by caller; atomic replace so the supervisor never reads
        # a torn payload
        payload = {"ts": now, "pid": os.getpid(), **self._status}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        self.last = now

    def start_thread(self):
        """Refresh ts from a daemon thread every `interval` seconds (min
        0.05 so interval=0 test heartbeats don't spin)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            period = max(self.interval, 0.05)
            while not self._stop.wait(period):
                self.pulse()

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()

    def stop_thread(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    @staticmethod
    def read(path: str) -> Optional[dict]:
        """Parse one heartbeat file -> payload dict, or None if missing or
        unreadable. Legacy plain-timestamp files (pre-JSON format: the bare
        float `beat` used to write) come back as {"ts": <float>}."""
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            return None
        if not raw:
            return None
        try:
            obj = json.loads(raw)
        except ValueError:
            return None
        if isinstance(obj, dict):
            return obj
        if isinstance(obj, (int, float)):
            return {"ts": float(obj)}
        return None

    @staticmethod
    def dead_hosts(paths, timeout: float, now: Optional[float] = None):
        """Hosts whose last beat (JSON payload ts, or a legacy plain
        timestamp) is older than `timeout` — missing/unparseable files
        count as dead."""
        if now is None:
            now = time.time()
        dead = []
        for p in paths:
            payload = Heartbeat.read(p)
            t = float(payload.get("ts", 0.0)) if payload else 0.0
            if now - t > timeout:
                dead.append(p)
        return dead
