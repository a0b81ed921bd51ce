"""Port parity, multi-process training: real `torch.distributed` CPU
processes (gloo) run the port's data-parallel and sequence-parallel train
steps and its three-phase Trainer, and each is held against the same work
in one process, on the same global batch.

  - a 2-rank data-parallel step (dense, sparse, sparse with unequal loss
    masks) against the 1-process step: loss within 3e-5, gradients within
    1e-3, the ranks' gradients bitwise equal (a planted mean of the ranks'
    means misses the masked case's loss by far more);
  - a 2-rank (seq) step of the encoder under remat: dense (K/V gathered
    over 'seq'), sparse through the halo exchange, sparse with unequal
    loss masks, and the gather path on a wide plan, against the 1-process
    step; a 4-rank (seq 2 x data 2) step: dense, sparse through the halo
    exchange, and a wide plan through the gathered fallback;
  - a 2-rank Trainer through the transition: one plan (digests equal across
    ranks), equal to the reference controller's given the pooled map the
    ranks captured, checkpoints written by process 0 only, which the JAX
    package's Trainer restores.

The legs that kill, preempt or roll back a fleet (as the JAX package's own
tests/test_multiprocess.py) run behind SPION_MP_TESTS=1.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import free_port, run_distributed_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B = 128, 4
MP_ENV = {"OMP_NUM_THREADS": "1"}

# every worker: join the job, the reduced spion-lra of the training tests
# (block 32, fp32, the kernels' plain versions), masters from seed 0
PRELUDE = """
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
from repro_torch.configs import get_config
c = get_config("spion-lra").reduced()
cfg = c.replace(dtype="float32", spion=dataclasses.replace(
    c.spion, block_size=32, kernel="fused"))
"""


def lra_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    c = get_config("spion-lra").reduced()
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=32, kernel="fused"))


# the global batch, built alike in the test and in every worker
BATCH_SRC = """
def global_batch(masked=False, B=4, S=128):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        # unequal masks: the first half of the batch counts 3 tokens in 4,
        # the second half 1 in 8, so a mean of the ranks' means is wrong
        m = np.zeros((B, S), np.float32)
        m[: B // 2, : 3 * S // 4] = 1.0
        m[B // 2:, : S // 8] = 1.0
        b["loss_mask"] = m
    return b
"""
exec(BATCH_SRC)


def run(code, nproc, tmp_path, timeout=240):
    return run_distributed_case(PRELUDE + code, nproc=nproc, timeout=timeout,
                                env_extra=dict(MP_ENV, MP_OUT=str(tmp_path)))


# the cases of each mesh: (its tables, the sparse path on CPU tensors)
CASES = {"data": ["dense", "sparse", "masked"],
         "seq": ["dense", "sparse", "masked", "gather", "diagonal"],
         "seq2data2": ["dense", "sparse", "wide"]}
NPROC = {"data": 2, "seq": 2, "seq2data2": 4}

STEP_CODE = """
from repro_torch.data.pipeline import local_batch
from repro_torch.launch.mesh import make_distributed_mesh, make_seq_mesh
from repro_torch.launch.steps import make_loss_and_grads, spion_dryrun_tables
from repro_torch.launch.train import masters_of
from repro_torch.models.registry import build
MODE = os.environ["MP_MODE"]
mesh = {"seq": lambda: make_seq_mesh(2, 1),
        "seq2data2": lambda: make_seq_mesh(2, 2),
        "data": make_distributed_mesh}[MODE]()
if MODE != "data":
    cfg = cfg.replace(remat=True)   # the 'seq' collectives inside remat
params = masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                    device="cpu"))
out = {}
for case in CASES[MODE]:
    tables = step_tables(cfg, case)
    f = make_loss_and_grads(cfg, mesh=mesh,
                            sparse_kernel="jnp" if case == "gather" else None,
                            halo=None if tables is None else tables["halo"])
    batch = local_batch(mesh, global_batch(case == "masked"), "cpu")
    loss, grads = f(params, batch, tables)
    out[f"{case}/loss"] = loss.numpy()
    out.update({f"{case}/{k}": g.numpy() for k, g in grads.items()})
    out[f"{case}/count"] = batch.get("loss_mask", batch["labels"]).float().sum().numpy() \\
        if case == "masked" else np.float32(0)
np.savez(os.path.join(OUT, f"rank{pid}.npz"), **out)
print("STEP_OK")
runtime.shutdown(0)
"""

TABLES_SRC = """
CASES = %r

def step_tables(cfg, case):
    # dense: none; the halo path: a plan banded to one block, and the
    # diagonal alone (halo (0, 0): nothing to exchange); the gather path
    # and the gathered fallback: the dry run's global verticals
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.launch.steps import spion_dryrun_tables
    if case == "dense":
        return None
    if case == "diagonal":
        diag = np.arange(4, dtype=np.int32)[None, :, None]
        plan = build_sparsity_plan(diag.repeat(cfg.num_layers, 0),
                                   np.ones((cfg.num_layers, 4), np.int32), 32)
        return dict(plan.tables, halo=plan.stats["halo"])
    return spion_dryrun_tables(
        cfg, 128, max_extent=None if case in ("gather", "wide") else 1)
""" % (CASES,)
exec(TABLES_SRC)


def one_process_step(case, remat=False):
    """Loss, gradients and (masked) the planted mean of two half-batch
    means, in one process."""
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    cfg = lra_cfg().replace(remat=remat)
    params = masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                        device="cpu"))
    tables = step_tables(cfg, case)
    f = make_loss_and_grads(
        cfg, sparse_kernel="jnp" if case == "gather" else None)
    gb = global_batch(case == "masked")
    tb = {k: torch.as_tensor(v) for k, v in gb.items()}
    loss, grads = f(params, tb, tables)
    halves = None
    if case == "masked":
        halves = [float(f(params, {k: v[i * B // 2:(i + 1) * B // 2]
                                   for k, v in tb.items()}, tables)[0]
                        .detach()) for i in range(2)]
    return float(loss.detach()), {k: g.numpy() for k, g in grads.items()}, \
        halves


@pytest.mark.parametrize("mode", ["data", "seq", "seq2data2"])
def test_mesh_step_matches_one_process(mode, tmp_path):
    """The global-mean loss and the summed gradients of a mesh step equal
    the 1-process step on the same global batch: data parallelism (half
    the batch a rank; dense, sparse, and sparse with unequal loss masks),
    sequence parallelism under remat (half the sequence a rank; dense with
    K/V gathered over 'seq', the halo exchange around the kernels' plain
    versions at halo (1, 1) and at halo (0, 0) (a diagonal plan: nothing
    to exchange), unequal masks, and the gather path on the dry run's wide
    plan), and 4 ranks of seq 2 x data 2 (dense, the halo
    exchange, and the wide plan through the gathered fallback)."""
    import warnings
    outs = run_distributed_case(
        PRELUDE + BATCH_SRC + TABLES_SRC + STEP_CODE, nproc=NPROC[mode],
        timeout=240,
        env_extra=dict(MP_ENV, MP_OUT=str(tmp_path), MP_MODE=mode))
    assert all("STEP_OK" in o for o in outs)
    ranks = [dict(np.load(tmp_path / f"rank{i}.npz"))
             for i in range(NPROC[mode])]
    for case in CASES[mode]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loss, grads, halves = one_process_step(case, mode != "data")
        for r in ranks:
            assert abs(float(r[f"{case}/loss"]) - loss) <= 3e-5, \
                (case, float(r[f"{case}/loss"]), loss)
            for k, g in grads.items():
                np.testing.assert_allclose(r[f"{case}/{k}"], g, atol=1e-3,
                                           rtol=0, err_msg=f"{case} {k}")
                np.testing.assert_array_equal(
                    r[f"{case}/{k}"], ranks[0][f"{case}/{k}"])
        if halves is not None:
            # the planted fault this gate must see: a mean of the ranks'
            # means over unequal masks
            assert abs(np.mean(halves) - loss) > 10 * 3e-5
            assert float(ranks[0][f"{case}/count"]) != \
                float(ranks[1][f"{case}/count"])


TRAINER_CODE = """
from repro_torch.checkpoint import manager as mgr
from repro_torch.core.spion import plan_digest
from repro_torch.launch.train import Trainer
cfg = cfg.replace(spion=dataclasses.replace(
    cfg.spion, min_dense_epochs=1, max_dense_epochs=3))
writes = []
inner_write = mgr.CheckpointManager._write
def write(self, step, *a, **k):
    writes.append(step)
    return inner_write(self, step, *a, **k)
mgr.CheckpointManager._write = write

def data_fn(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(4, 129)).astype(np.int32)
    toks[:, 1::2] = toks[:, ::2][:, : toks[:, 1::2].shape[1]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

tr = Trainer(cfg, seq_len=128, batch=4, lr=0.05, total_steps=100,
             steps_per_epoch=2, data_fn=data_fn, device="cpu", sentinel=False,
             ckpt_dir=os.path.join(OUT, "ckpt"))
assert tr.mesh is not None and tr.mesh.shape == {"pod": 2, "data": 1,
                                                 "model": 1}
pooled = []
inner_obs = tr.spion_ctl.observe_epoch
def observe(state, p, f):
    pooled.append((np.array(p), np.array(f)))
    return inner_obs(state, p, f)
tr.spion_ctl.observe_epoch = observe
losses = tr.train(8, ckpt_every=8, log_every=100, log=lambda *a: None)
st = tr.spion_state
np.savez(os.path.join(OUT, f"pooled{pid}.npz"),
         **{f"p{i}": p for i, (p, _) in enumerate(pooled)})
json.dump({"losses": losses, "phase": st.phase, "writes": writes,
           "digest": plan_digest(st.table_arrays(), st.tables["block"]),
           "tables": {k: v.tolist() for k, v in st.table_arrays().items()},
           "stats": st.plan_stats, "hb": os.path.exists(
               os.path.join(OUT, "ckpt", f"hb_{pid}"))},
          open(os.path.join(OUT, f"trainer{pid}.json"), "w"))
print("TRAINER_OK")
runtime.shutdown(0)
"""


def test_two_process_trainer_one_plan_one_writer(tmp_path):
    """A 2-rank Trainer through the transition: one plan on both ranks
    (digests equal), equal to the JAX controller's from the pooled map the
    ranks captured (the same on both); the checkpoint written by process 0
    alone, each rank's heartbeat file hb_<rank>, and the JAX package's
    Trainer restores the checkpoint (step, phase, plan)."""
    import dataclasses
    outs = run(TRAINER_CODE, 2, tmp_path)
    assert all("TRAINER_OK" in o for o in outs)
    runs = [json.load(open(tmp_path / f"trainer{i}.json")) for i in range(2)]
    assert all(r["phase"] == "sparse" and r["hb"] for r in runs)
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[0]["losses"] == runs[1]["losses"]
    # process 0 writes (at ckpt_every and again at the end), process 1 never
    assert set(runs[0]["writes"]) == {8} and runs[1]["writes"] == []
    pooled = [dict(np.load(tmp_path / f"pooled{i}.npz")) for i in range(2)]
    for k in pooled[0]:
        np.testing.assert_array_equal(pooled[0][k], pooled[1][k])

    from repro.configs import get_config as jget
    from repro.core.spion import SpionController, SpionState
    jc = jget("spion-lra").reduced()
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=32, min_dense_epochs=1, max_dense_epochs=3))
    ctl = SpionController(jc.spion, causal=jc.causal, seq_len=S)
    last = pooled[0][f"p{len(pooled[0]) - 1}"]
    jst = ctl.generate(SpionState(), last)
    for k, v in runs[0]["tables"].items():
        np.testing.assert_array_equal(np.asarray(jst.tables[k]),
                                      np.asarray(v, np.int32), err_msg=k)
    assert runs[0]["stats"] == jst.plan_stats

    from repro.launch.train import Trainer as JTrainer
    jt = JTrainer(jc, seq_len=S, batch=4, ckpt_dir=str(tmp_path / "ckpt"),
                  steps_per_epoch=2, sentinel=False)
    assert jt.maybe_resume()
    assert jt.step == 8 and jt.spion_state.phase == "sparse"
    from repro.core.spion import plan_digest as j_digest
    assert j_digest(jt.spion_state.table_arrays(),
                    jt.spion_state.tables["block"]) == runs[0]["digest"]


# -- the fleet legs (gated as the JAX package's multi-process suite) ---------

mp_only = pytest.mark.skipif(
    os.environ.get("SPION_MP_TESTS") != "1",
    reason="multi-process fleet legs (set SPION_MP_TESTS=1)")


def _cli(ckpt, steps, extra=()):
    return [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
            "--steps", str(steps), "--seq-len", "128", "--batch", "4",
            "--steps-per-epoch", "2", "--ckpt-every", "2", "--sparse-kernel",
            "fused", "--device", "cpu", "--ckpt-dir", str(ckpt), *extra]


def _env(**kw):
    return dict(PYTHONPATH="src", PATH="/usr/bin:/bin", OMP_NUM_THREADS="1",
                **kw)


@mp_only
def test_sigterm_saves_fleetwide_then_resumes_on_one_process(tmp_path):
    """SIGTERM on rank 1 alone: both ranks save at the same step and exit 0
    (the per-step any_flags OR); the checkpoint then resumes on ONE
    process (elastic: the parameters are replicated)."""
    port = free_port()
    procs = [subprocess.Popen(
        _cli(tmp_path, 40), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(
            SPION_COORDINATOR=f"localhost:{port}", SPION_NUM_PROCESSES="2",
            SPION_PROCESS_ID=str(i))) for i in range(2)]
    import time
    hb = tmp_path / "hb_1"
    t0 = time.time()
    while time.time() - t0 < 120:
        if hb.exists() and json.loads(hb.read_text()).get("step", 0) >= 3:
            break
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "preempted: saved step" in outs[0]
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    saved = int(outs[0].split("preempted: saved step ")[1].split(",")[0])
    assert saved in steps and saved < 40
    r = subprocess.run(_cli(tmp_path, 2), cwd=ROOT, capture_output=True,
                       text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"resumed from step {saved}" in r.stdout


ROLLBACK_CODE = """
from repro_torch.distributed.chaos import ChaosMonkey
from repro_torch.distributed.fault import DivergenceSentinel
from repro_torch.launch.train import Trainer
def data_fn(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(4, 129)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
tr = Trainer(cfg, seq_len=128, batch=4, steps_per_epoch=100,
             data_fn=data_fn, device="cpu", ckpt_dir=os.path.join(OUT, "ck"),
             chaos=ChaosMonkey(nan_step=7) if pid == 1 else None,
             sentinel=DivergenceSentinel(spike=False))
tr.train(10, ckpt_every=3, log_every=100, log=lambda *a: None)
ev = [e for e in tr.events if e["event"] == "rollback"]
json.dump({"rollbacks": tr.rollback_count, "ev": ev, "step": tr.step,
           "offset": tr.data_offset}, open(os.path.join(OUT, f"rb{pid}.json"), "w"))
print("RB_OK")
runtime.shutdown(0)
"""


@mp_only
def test_divergence_rollback_fleetwide(tmp_path):
    """NaN poisoning on rank 1 alone: the all-reduce spreads it, and both
    ranks roll back once, at the same step, to the same good checkpoint
    (max_value of the divergence step)."""
    outs = run(ROLLBACK_CODE, 2, tmp_path)
    assert all("RB_OK" in o for o in outs)
    rb = [json.load(open(tmp_path / f"rb{i}.json")) for i in range(2)]
    assert rb[0]["rollbacks"] == rb[1]["rollbacks"] == 1
    assert [e["from_step"] for e in rb[0]["ev"]] == \
        [e["from_step"] for e in rb[1]["ev"]] == [7]
    assert rb[0]["ev"][0]["to_step"] == rb[1]["ev"][0]["to_step"] == 6
    assert rb[0]["step"] == rb[1]["step"] == 10
