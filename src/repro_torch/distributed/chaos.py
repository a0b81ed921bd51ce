"""Fault injection for the recovery tests and chip_smoke.py's respawn and
rollback phases: deterministic process kills / hangs / loss poisoning at a
chosen step, and a flaky-step wrapper for exercising StepSupervisor's
retry/backoff path (the JAX package's `distributed/chaos.py`).

Everything is env-driven so a subprocess launcher can arm a specific worker
without the training script knowing anything about the experiment:

  SPION_CHAOS_KILL_STEP=11      kill when the training step counter reaches 11
  SPION_CHAOS_KILL_PROC=1       only on process 1 (SPION_PROCESS_ID; default: all)
  SPION_CHAOS_SIGNAL=KILL       KILL (hard death, tests the resume-from-last-
                                commit path) or TERM (delivered to self, so
                                the preemption handler runs the graceful
                                save/exit protocol)
  SPION_CHAOS_HANG_STEP=12      sleep inside the step loop at step 12 — the
                                process stays alive (heartbeat thread keeps
                                ts fresh) but its step counter freezes: the
                                supervisor's hang watchdog must catch it
  SPION_CHAOS_HANG_PROC=1       restrict the hang to one process
  SPION_CHAOS_HANG_SECONDS      sleep length (default 3600 — "forever" at
                                test scale; the supervisor SIGKILLs the
                                process group long before it wakes)
  SPION_CHAOS_NAN_STEP=13       poison the params with NaN right before the
                                step — the honest divergence model: the loss
                                goes non-finite *through the real forward*,
                                and the optimizer update poisons the
                                moments
  SPION_CHAOS_NAN_PROC=1        restrict the poisoning to one process
  SPION_CHAOS_ONCE_DIR=/path    cross-incarnation one-shot markers: each
                                fired injection drops a marker file there,
                                so a RESPAWNED fleet replaying through the
                                armed step does not re-trigger the fault
                                (without it, a supervisor-respawned run
                                would hang/die again at the same step,
                                forever)

`Trainer` polls `ChaosMonkey.from_env()` by default, so arming chaos is
purely a launcher concern. An unarmed monkey is inert.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Optional

from repro_torch.distributed import process_index


class ChaosMonkey:
    """Injects a deterministic fault when the step counter reaches the
    armed step: kill (SIGKILL/SIGTERM), hang (sleep inside the loop), or
    NaN loss poisoning. Each kind fires at most once per process instance;
    with `once_dir` set, at most once across process incarnations too."""

    def __init__(self, kill_step: Optional[int] = None,
                 kill_process: Optional[int] = None, sig: str = "KILL",
                 hang_step: Optional[int] = None,
                 hang_process: Optional[int] = None,
                 hang_seconds: float = 3600.0,
                 nan_step: Optional[int] = None,
                 nan_process: Optional[int] = None,
                 once_dir: Optional[str] = None):
        self.kill_step = kill_step
        self.kill_process = kill_process
        self.sig = sig.upper()
        if self.sig not in ("KILL", "TERM"):
            raise ValueError(f"SPION_CHAOS_SIGNAL must be KILL or TERM, "
                             f"got {sig!r}")
        self.hang_step = hang_step
        self.hang_process = hang_process
        self.hang_seconds = hang_seconds
        self.nan_step = nan_step
        self.nan_process = nan_process
        self.once_dir = once_dir
        self.fired = False        # kill (name kept for back-compat)
        self.hang_fired = False
        self.nan_fired = False

    @classmethod
    def from_env(cls) -> Optional["ChaosMonkey"]:
        def _int(name):
            v = os.environ.get(name)
            return None if v is None else int(v)

        kill, hang, nan = (_int("SPION_CHAOS_KILL_STEP"),
                           _int("SPION_CHAOS_HANG_STEP"),
                           _int("SPION_CHAOS_NAN_STEP"))
        if kill is None and hang is None and nan is None:
            return None
        return cls(kill_step=kill,
                   kill_process=_int("SPION_CHAOS_KILL_PROC"),
                   sig=os.environ.get("SPION_CHAOS_SIGNAL", "KILL"),
                   hang_step=hang,
                   hang_process=_int("SPION_CHAOS_HANG_PROC"),
                   hang_seconds=float(
                       os.environ.get("SPION_CHAOS_HANG_SECONDS", "3600")),
                   nan_step=nan,
                   nan_process=_int("SPION_CHAOS_NAN_PROC"),
                   once_dir=os.environ.get("SPION_CHAOS_ONCE_DIR"))

    # -- one-shot bookkeeping ------------------------------------------------

    def _marker(self, kind: str) -> Optional[str]:
        if self.once_dir is None:
            return None
        return os.path.join(self.once_dir, f"chaos_fired_{kind}")

    def _once_ok(self, kind: str) -> bool:
        m = self._marker(kind)
        return m is None or not os.path.exists(m)

    def _mark(self, kind: str) -> None:
        m = self._marker(kind)
        if m is not None:
            os.makedirs(self.once_dir, exist_ok=True)
            with open(m, "w") as f:
                f.write(str(os.getpid()))

    @staticmethod
    def _on_process(proc: Optional[int]) -> bool:
        return proc is None or process_index() == proc

    # -- kill ----------------------------------------------------------------

    def armed_for(self, step: int) -> bool:
        if self.fired or self.kill_step is None or step < self.kill_step:
            return False
        if not self._once_ok("kill"):
            return False
        return self._on_process(self.kill_process)

    def maybe_kill(self, step: int) -> None:
        """Call at the top of each training-loop iteration. SIGKILL is an
        abrupt death (no cleanup, no flush — the honest preemption model);
        SIGTERM goes through the installed handler, i.e. the graceful
        save-and-exit protocol."""
        if not self.armed_for(step):
            return
        self.fired = True
        self._mark("kill")  # before the kill — there is no after
        os.kill(os.getpid(),
                signal.SIGKILL if self.sig == "KILL" else signal.SIGTERM)

    # -- hang ----------------------------------------------------------------

    def maybe_hang(self, step: int, sleep_fn=time.sleep) -> None:
        """Sleep inside the step loop: the process stays alive (and its
        heartbeat thread keeps ts fresh) but the step counter freezes — the
        failure mode only the supervisor's step-progress watchdog catches.
        The marker is written before sleeping: the supervisor SIGKILLs the
        process group, so there is no code path after the sleep."""
        if (self.hang_fired or self.hang_step is None
                or step < self.hang_step or not self._once_ok("hang")
                or not self._on_process(self.hang_process)):
            return
        self.hang_fired = True
        self._mark("hang")
        sleep_fn(self.hang_seconds)

    # -- loss poisoning ------------------------------------------------------

    def poison_due(self, step: int) -> bool:
        """True exactly once, at the armed step, on the armed process: the
        caller NaN-poisons its params so the loss diverges through the real
        forward pass and the optimizer update poisons the moments — the
        scenario the divergence sentinel's rollback protocol exists for."""
        if (self.nan_fired or self.nan_step is None or step < self.nan_step
                or not self._once_ok("nan")
                or not self._on_process(self.nan_process)):
            return False
        self.nan_fired = True
        self._mark("nan")
        return True


def flaky(step_fn, fail_on_calls, exc_factory=None):
    """Wrap a step fn to raise on the given 1-based call numbers — the
    deterministic stand-in for transient infrastructure failures when
    testing StepSupervisor's retry/backoff. `exc_factory` builds the
    exception (default: RuntimeError tagged with the call number)."""
    fail_on_calls = set(fail_on_calls)
    calls = {"n": 0}

    def wrapped(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] in fail_on_calls:
            raise (exc_factory(calls["n"]) if exc_factory
                   else RuntimeError(f"injected fault on call {calls['n']}"))
        return step_fn(*args, **kwargs)

    wrapped.calls = calls
    return wrapped
