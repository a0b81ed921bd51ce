"""Port parity, self-healing: the port's copies of the JAX package's fault
machinery (distributed/fault.py, chaos.py, supervisor.py) give the same
verdicts on the same inputs; the port's StepSupervisor retries I/O errors
only, never a failure of a kernel or of the code; the fleet supervisor
respawns a real port worker; and the port's Trainer refuses to run as one of
several processes."""
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.distributed.chaos as jchaos
import repro.distributed.fault as jfault
import repro.distributed.supervisor as jsup
import repro_torch.distributed.chaos as tchaos
import repro_torch.distributed.fault as tfault
import repro_torch.distributed.supervisor as tsup
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels.block_sparse_attn import KernelError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- the same inputs through both packages --------------------------------------

_CLASSIFY = [  # (now, spawned_at, payloads in order, kwargs)
    (101.0, 90.0, [{"ts": 100.0, "step": 5}], {}),
    (111.0, 90.0, [{"ts": 100.0, "step": 5}], {}),
    (105.0, 100.0, [None], {}),
    (111.0, 100.0, [None], {}),
    (20.0, 0.0, [{"ts": 10.0, "step": 1}, {"ts": 14.0, "step": 2},
                 {"ts": 18.0, "step": 2}, {"ts": 20.0, "step": 2}],
     dict(dead_timeout=60.0, hang_timeout=5.0)),
    (1010.0, 0.0, [{"ts": 10.0}, {"ts": 1000.0}, {"ts": 1001.0, "step": 1},
                   {"ts": 1010.0, "step": 1}],
     dict(dead_timeout=1e9, hang_timeout=5.0)),
    (11.0, 0.0, [{"ts": 10.0, "step": 3, "stragglers": 7}],
     dict(straggler_limit=7)),
    (11.0, 0.0, [{"ts": 10.0, "step": 3, "stragglers": 7}],
     dict(straggler_limit=8)),
]


@pytest.mark.parametrize("case", range(len(_CLASSIFY)))
def test_classify_agrees_with_the_reference(case):
    """A sequence of heartbeat payloads, each classified at its own ts (the
    last at `now`): every verdict and the tracker's state agree."""
    now, spawned, payloads, kw = _CLASSIFY[case]
    kw = {"dead_timeout": 10.0, "hang_timeout": 60.0, **kw}
    verdicts = []
    for mod in (jsup, tsup):
        tr, out = mod.StepTracker(), []
        for i, p in enumerate(payloads):
            t = now if i == len(payloads) - 1 or p is None else p["ts"]
            out.append(mod.classify(t, spawned, p, tr, **kw))
        verdicts.append((out, tr.step, tr.since))
    assert verdicts[0] == verdicts[1]


def test_backoffs_agree_with_the_reference():
    for base, cap in ((1.0, 5.0), (0.1, 1.0), (2.0, 30.0)):
        j = jsup.FleetSupervisor(["true"], 1, "/nonexistent", backoff_base=base,
                                 backoff_max=cap)
        t = tsup.FleetSupervisor(["true"], 1, "/nonexistent", backoff_base=base,
                                 backoff_max=cap)
        assert [j.backoff(i) for i in range(8)] == \
            [t.backoff(i) for i in range(8)]
    j = jfault.StepSupervisor(lambda: None, rng=random.Random(3))
    t = tfault.StepSupervisor(lambda: None, rng=random.Random(3))
    assert [j.backoff(i) for i in range(10)] == [t.backoff(i) for i in range(10)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_and_sentinel_agree_with_the_reference(seed):
    rng = np.random.default_rng(seed)
    dts = list(1.0 + 0.05 * rng.standard_normal(40))
    dts[25] = 9.0
    losses = list(4.0 - 0.01 * np.arange(40) + 0.01 * rng.standard_normal(40))
    losses[30] = 400.0
    losses[33] = float("nan")
    for kw in ({}, {"warmup": 3, "z": 2.0, "alpha": 0.3}):
        j, t = jfault.StragglerMonitor(**kw), tfault.StragglerMonitor(**kw)
        assert [j.observe(x) for x in dts] == [t.observe(x) for x in dts]
        assert (j.mean, j.var, j.n) == (t.mean, t.var, t.n)
    for kw in ({}, {"spike": False}, {"z": 6.0, "warmup": 5}):
        j, t = jfault.DivergenceSentinel(**kw), tfault.DivergenceSentinel(**kw)
        got = [(j.observe(x), t.observe(x)) for x in losses]
        assert all(a == b for a, b in got) and any(a for a, _ in got)
        j.reset()
        t.reset()
        assert [j.observe(x) for x in losses[:12]] == \
            [t.observe(x) for x in losses[:12]]


def test_heartbeat_payloads_agree_with_the_reference(tmp_path):
    for i, mod in enumerate((jfault, tfault)):
        hb = mod.Heartbeat(str(tmp_path / f"h{i}"), interval=0.0)
        hb.beat(now=100.0, step=7, phase="sparse", extra={"stragglers": 2})
        hb.beat(now=0.0)
        hb.pulse(now=200.0)
    for mod in (jfault, tfault):
        assert mod.Heartbeat.read(str(tmp_path / "h0")) == \
            mod.Heartbeat.read(str(tmp_path / "h1")) == \
            {"ts": 200.0, "pid": os.getpid(), "step": 7, "phase": "sparse",
             "stragglers": 2}
    legacy, garbled = tmp_path / "old", tmp_path / "bad"
    legacy.write_text("1234.5")
    garbled.write_text("{not json")
    paths = [str(p) for p in (legacy, garbled, tmp_path / "h0",
                              tmp_path / "missing")]
    for p in paths:
        assert jfault.Heartbeat.read(p) == tfault.Heartbeat.read(p)
    for now in (1240.0, 150.0, 300.0):
        assert jfault.Heartbeat.dead_hosts(paths, 10.0, now=now) == \
            tfault.Heartbeat.dead_hosts(paths, 10.0, now=now)


_CHAOS_ENV = [
    {},
    {"SPION_CHAOS_KILL_STEP": "11", "SPION_CHAOS_SIGNAL": "TERM"},
    {"SPION_CHAOS_KILL_STEP": "3", "SPION_CHAOS_KILL_PROC": "0"},
    {"SPION_CHAOS_KILL_STEP": "3", "SPION_CHAOS_KILL_PROC": "1"},
    {"SPION_CHAOS_HANG_STEP": "12", "SPION_CHAOS_HANG_SECONDS": "7.5",
     "SPION_CHAOS_NAN_STEP": "13"},
    {"SPION_CHAOS_NAN_STEP": "5", "SPION_CHAOS_NAN_PROC": "1"},
]


def _chaos_trace(cm, sleeps):
    """What an armed monkey does over steps 0-15 (maybe_kill is replaced by
    armed_for: the real one would signal the test process)."""
    if cm is None:
        return None
    out = []
    for step in range(16):
        armed = cm.armed_for(step)
        if armed:
            cm.fired = True
            cm._mark("kill")
        cm.maybe_hang(step, sleep_fn=sleeps.append)
        out.append((armed, cm.poison_due(step)))
    return out, list(sleeps), cm.kill_step, cm.sig, cm.hang_step, \
        cm.hang_seconds, cm.nan_step, cm.kill_process, cm.nan_process


@pytest.mark.parametrize("case", range(len(_CHAOS_ENV)))
def test_chaos_from_env_agrees_with_the_reference(case, monkeypatch):
    """The same SPION_CHAOS_* environment arms both monkeys alike, and both
    fire at the same steps (process 0)."""
    for k in list(os.environ):
        if k.startswith("SPION_CHAOS_"):
            monkeypatch.delenv(k)
    for k, v in _CHAOS_ENV[case].items():
        monkeypatch.setenv(k, v)
    traces = [_chaos_trace(mod.ChaosMonkey.from_env(), [])
              for mod in (jchaos, tchaos)]
    assert traces[0] == traces[1]


def test_chaos_once_markers_agree_with_the_reference(tmp_path):
    """Markers written by either package's monkey stop both packages'
    fresh monkeys: a respawned worker does not fire again."""
    def fresh(mod, d):
        return mod.ChaosMonkey(hang_step=5, nan_step=6, kill_step=7,
                               once_dir=str(d))
    for first, second in ((jchaos, tchaos), (tchaos, jchaos)):
        d = tmp_path / first.__name__
        cm = fresh(first, d)
        cm.maybe_hang(5, sleep_fn=lambda s: None)
        assert cm.poison_due(6) and cm.armed_for(7)
        cm._mark("kill")
        assert sorted(os.listdir(d)) == ["chaos_fired_hang", "chaos_fired_kill",
                                         "chaos_fired_nan"]
        again, slept = fresh(second, d), []
        again.maybe_hang(5, sleep_fn=slept.append)
        assert slept == [] and not again.poison_due(6) and \
            not again.armed_for(7)
    with pytest.raises(ValueError):
        tchaos.ChaosMonkey(sig="SEGV")


def test_flaky_wrapper_with_supervisor():
    sup = tfault.StepSupervisor(lambda: None, max_retries=3,
                                sleep_fn=lambda d: None)
    step = tchaos.flaky(lambda x: x * 2, fail_on_calls=(1, 2),
                        exc_factory=lambda n: OSError(f"read failed {n}"))
    assert sup.run(step, 21) == 42
    assert step.calls["n"] == 3 and sup.restarts == 2


# -- what StepSupervisor retries ------------------------------------------------

def test_step_supervisor_retries_an_io_error():
    calls = {"restore": 0, "step": 0}

    def restore():
        calls["restore"] += 1

    def step():
        calls["step"] += 1
        if calls["step"] == 1:
            raise ConnectionError("coordinator hiccup")
        if calls["step"] == 2:
            raise OSError("checkpoint read failed")
        return "ok"

    sup = tfault.StepSupervisor(restore, max_retries=3, sleep_fn=lambda d: None)
    assert sup.run(step) == "ok"
    assert calls == {"restore": 2, "step": 3} and sup.restarts == 2
    sup = tfault.StepSupervisor(lambda: None, max_retries=1,
                                sleep_fn=lambda d: None)
    with pytest.raises(OSError):
        sup.run(lambda: (_ for _ in ()).throw(OSError("disk gone")))
    assert sup.restarts == 2


def test_step_supervisor_reraises_when_there_is_nothing_to_restore():
    """A restore_fn that returns False restored nothing: the I/O error
    re-raises after the one attempt, with no retry."""
    calls = []

    def step():
        calls.append(1)
        raise OSError("checkpoint read failed")

    sup = tfault.StepSupervisor(lambda: False, max_retries=3,
                                sleep_fn=lambda d: None)
    with pytest.raises(OSError):
        sup.run(step)
    assert calls == [1] and sup.restarts == 1


def _fake_launch_failure(monkeypatch):
    """block_sparse_fwd's launch on a tensor the wrapper takes for a CUDA
    one, with a library whose entry point reports an illegal address."""
    class Lib:
        @staticmethod
        def spion_block_sparse_fwd_f32(*args):
            return 700

        @staticmethod
        def spion_cuda_error_string(rc):
            return b"an illegal memory access was encountered"

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(bsa, "load_library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__(
        "contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream)
    q = torch.zeros(1)
    fake = type("Q", (), {"device": torch.device("cuda"),
                          "dtype": torch.float32})()
    return lambda: bsa._launch("fwd", fake, q)


def _missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(bsa.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(bsa, "_BUILD_ROOT", tmp_path / "build")
    return bsa.library_path


def _failing_nvcc(monkeypatch, tmp_path):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no such GPU architecture'\n"
                    "exit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(bsa.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(bsa, "_BUILD_ROOT", tmp_path / "build")
    return bsa.library_path


def _unloadable_library(monkeypatch, tmp_path):
    lib = tmp_path / "libspion_kernels.so"
    lib.write_bytes(b"not an ELF file")
    monkeypatch.setattr(bsa, "library_path", lambda: lib)
    bsa.load_library.cache_clear()
    return bsa.load_library


def _not_implemented(monkeypatch, tmp_path):
    def step():
        raise NotImplementedError("waits in ROADMAP.md item A12")
    return step


def _accelerator_error(monkeypatch, tmp_path):
    cls = getattr(torch, "AcceleratorError", None) or torch.OutOfMemoryError

    def step():
        raise cls("CUDA error: an illegal memory access was encountered")
    return step


@pytest.mark.parametrize("make", [_fake_launch_failure, _missing_nvcc,
                                  _failing_nvcc, _unloadable_library,
                                  _not_implemented, _accelerator_error],
                         ids=lambda f: f.__name__.strip("_"))
def test_step_supervisor_never_retries_the_card_or_a_kernel(make, monkeypatch,
                                                            tmp_path):
    """A kernel launch failure, nvcc missing or failing, a library that
    does not load, NotImplementedError and a CUDA error re-raise at once:
    no restore, no retry (the JAX package would retry each RuntimeError)."""
    args = (monkeypatch,) if make is _fake_launch_failure else \
        (monkeypatch, tmp_path)
    step = make(*args)
    restores = []
    sup = tfault.StepSupervisor(lambda: restores.append(1), max_retries=3,
                                sleep_fn=lambda d: None)
    with pytest.raises(Exception) as info:
        sup.run(step)
    assert not isinstance(info.value, tfault.StepSupervisor.RETRYABLE)
    assert restores == [] and sup.restarts == 0
    if make in (_fake_launch_failure, _missing_nvcc, _failing_nvcc,
                _unloadable_library):
        assert isinstance(info.value, KernelError)


# -- the fleet supervisor around a real port worker ------------------------------

def test_supervisor_respawns_a_port_worker(tmp_path):
    """nproc 1: a port trainer (the CLI, on the CPU) SIGKILLed by chaos at
    step 5 is respawned once, resumes from its step-4 checkpoint and
    finishes. The kill's once-marker, not timing, tells the generations
    apart, and nothing waits on a clock."""
    ckpt, once = tmp_path / "ckpt", tmp_path / "once"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--steps", "6", "--seq-len", "128", "--batch", "2",
           "--steps-per-epoch", "3", "--ckpt-every", "4", "--sparse-kernel",
           "fused", "--device", "cpu", "--ckpt-dir", str(ckpt)]
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "SPION_CHAOS_KILL_STEP": "5",
           "SPION_CHAOS_ONCE_DIR": str(once)}
    logs = []
    sup = tsup.FleetSupervisor(cmd, 1, str(ckpt), dead_timeout=120.0,
                               hang_timeout=120.0, poll_interval=0.05,
                               backoff_base=0.01, backoff_max=0.05,
                               max_respawns=2, env=env, log=logs.append)
    assert sup.run() == 0, logs
    assert sup.respawns == 1 and sup.generation == 1
    assert (once / "chaos_fired_kill").exists()
    assert any("exit=-9" in line for line in logs)
    # generation 1 resumed at step 4 and ran --steps more: its final save
    assert sorted(os.listdir(ckpt)) == ["hb_0", "step_000000004",
                                        "step_000000008", "step_000000010"]
    hb = tfault.Heartbeat.read(str(ckpt / "hb_0"))   # generation 1's
    assert hb["pid"] != os.getpid() and hb["ts"] > 0


def test_trainer_refuses_several_processes(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer
    monkeypatch.setenv("SPION_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="A12"):
        Trainer(get_config("spion-lra").reduced(), seq_len=64, batch=1,
                device="cpu")
    monkeypatch.setenv("SPION_NUM_PROCESSES", "1")
    Trainer(get_config("spion-lra").reduced(), seq_len=64, batch=1,
            device="cpu")


def test_supervise_cli(tmp_path):
    from repro_torch.launch import supervise
    with pytest.raises(SystemExit):
        supervise.main(["--nproc", "1", "--ckpt-dir", str(tmp_path)])
    code = ("import os, sys; sys.exit(0 if os.environ['SPION_NUM_PROCESSES']"
            " == '1' else 3)")
    assert supervise.main(["--nproc", "1", "--ckpt-dir", str(tmp_path),
                           "--poll-interval", "0.05", "--", sys.executable,
                           "-c", code]) == 0


def test_supervisor_never_imports_torch():
    """The supervisor must stay up when the CUDA runtime is what broke: its
    modules load without torch."""
    code = ("import sys; import repro_torch.launch.supervise; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'numpy'))))")
    out = subprocess.run([sys.executable, "-c", "import json; " + code],
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": os.path.join(ROOT, "src"),
                              "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout) == []


def test_sigterm_saves_at_the_current_step_and_exits(tmp_path):
    """The preemption path: SIGTERM (chaos, signal TERM, at step 3) lets the
    trainer save step 3 and return cleanly; a fresh trainer resumes there."""
    import signal
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer
    cfg = get_config("spion-lra").reduced()
    kw = dict(seq_len=128, batch=2, steps_per_epoch=100, device="cpu",
              ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, chaos=tchaos.ChaosMonkey(kill_step=3, sig="TERM"), **kw)
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        losses = tr.train(10, ckpt_every=0, log=lambda *a: None)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert tr.preempted and len(losses) == 3 and tr.ckpt.all_steps() == [3]
    again = Trainer(cfg, **kw)
    assert again.maybe_resume() and again.step == 3
