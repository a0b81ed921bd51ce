"""Port parity, SPION training over a 'seq' axis: real `torch.distributed`
CPU processes (gloo) run the port's steps, capture and Trainer on shards
of the sequence, and each is held against the same work in one process,
on the same global batch and masters (the reference's own mesh train step
does not run here: ROADMAP.md §C notes).

One 2-rank job (a 'seq' mesh of 2, and a data-parallel mesh of the same
two processes) runs every case; the tests read its records:
  - reduced qwen2-7b (GQA, RoPE at global positions), dense and sparse
    (the halo exchange); reduced internvl2-2b, whose [patches, text]
    sequence is cut across the shards (text from the first shard on, and a
    config whose first shard holds patches only); loss within 3e-5,
    gradients within 1e-3, the ranks' gradients bitwise equal;
  - reduced mixtral-8x7b (ROADMAP §C, C1): the MoE groups the global
    batch's tokens, under 'seq' (whole rows routed on every rank of the
    line) and under data parallelism (whole groups a rank), against one
    process; a rank holding half a group raises ValueError; the ranks' aux
    terms sum to the global ones;
  - the capture on 'seq' shards (filter of 31 rows): pooled map and
    Frobenius term within 1e-6 of one process, the JAX controller's plan
    from the ranks' map bitwise the port's;
  - planted faults that the gates must see: the K/V gather's backward
    keeping only this shard's gradient, and a capture whose last panel
    reads zero rows in place of the next shard's;
  - a 2-rank 'seq' Trainer through the transition: one plan (digests
    equal), dense losses within 3e-5 of the one-process Trainer's, process
    0 the only writer, and the port's one-process Trainer and the JAX
    package's Trainer restore its checkpoint.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from conftest import run_distributed_case

S, BLOCK = 128, 32
MP_ENV = {"OMP_NUM_THREADS": "1"}

# shared by the workers and the test process: configs, batches, masters
SRC = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config


def arch_cfg(arch, **kw):
    c = get_config(arch).reduced()
    if arch == "qwen2-7b" or arch == "internvl2-2b":
        kw.setdefault("num_kv_heads", 2)
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=32, kernel="fused"), **kw)


# case: (config, global batch rows, sequence length (vlm: patches + text),
# mesh, sparse)
CASES = {
    "qwen2_dense": (("qwen2-7b", {}), 2, 128, "seq", False),
    "qwen2_sparse": (("qwen2-7b", {}), 2, 128, "seq", True),
    "internvl2_dense": (("internvl2-2b", {}), 2, 128, "seq", False),
    "internvl2_sparse": (("internvl2-2b", {}), 2, 128, "seq", True),
    "internvl2_patches": (("internvl2-2b", {"num_patch_tokens": 96}), 2, 128,
                          "seq", False),
    "mixtral_seq": (("mixtral-8x7b", {}), 4, 512, "seq", False),
    "mixtral_data": (("mixtral-8x7b", {}), 4, 512, "data", False),
}
HALF_GROUP = (("mixtral-8x7b", {}), 2, 512, "data", False)


def case_cfg(case):
    (arch, kw), *_ = case
    return arch_cfg(arch, **kw)


def case_batch(case, seed=7):
    cfg = case_cfg(case)
    _, B, L, _, _ = case
    rng = np.random.default_rng(seed)
    P = cfg.num_patch_tokens
    toks = rng.integers(0, cfg.vocab_size,
                        size=(B, L - P + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if P:
        b["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
    return b


def case_tables(case):
    from repro_torch.launch.steps import spion_dryrun_tables
    if not case[4]:
        return None
    return spion_dryrun_tables(case_cfg(case), case[2], max_extent=1)


def masters(cfg):
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    return masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu"))


def lra_cfg():
    c = get_config("spion-lra").reduced()
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=32, kernel="fused", min_dense_epochs=1,
        max_dense_epochs=3))


def lra_batch():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 128, size=(4, 129)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def trainer_data(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(4, 129)).astype(np.int32)
    toks[:, 1::2] = toks[:, ::2][:, : toks[:, 1::2].shape[1]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
"""
exec(SRC)

WORKER = """
import json, os
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
from repro_torch.data.pipeline import local_batch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import mesh_context
from repro_torch.launch.mesh import make_distributed_mesh, make_seq_mesh
from repro_torch.launch.steps import compute_params, make_loss_and_grads
from repro_torch.models import attention as A
from repro_torch.models.registry import build
meshes = {"seq": make_seq_mesh(2, 1), "data": make_distributed_mesh()}
out, info = {}, {}


def step(case, planted=False):
    cfg, mesh = case_cfg(case), meshes[case[3]]
    tables = case_tables(case)
    f = make_loss_and_grads(cfg, mesh=mesh,
                            halo=None if tables is None else tables["halo"])
    batch = local_batch(mesh, case_batch(case), "cpu")
    params = masters(cfg)
    if not planted:
        return f(params, batch, tables), (cfg, params, batch, mesh)
    inner = sharding.GatherSeq.backward

    def local_only(ctx, g):   # the planted fault: no sum over 'seq'
        return (g.narrow(ctx.dim, ctx.idx * ctx.rows, ctx.rows), None, None,
                None, None)
    sharding.GatherSeq.backward = staticmethod(local_only)
    try:
        return f(params, batch, tables), None
    finally:
        sharding.GatherSeq.backward = inner


for name, case in CASES.items():
    (loss, grads), (cfg, params, batch, mesh) = step(case)
    out[f"{name}/loss"] = loss.numpy()
    out.update({f"{name}/{k}": g.numpy() for k, g in grads.items()})
    info[name] = {"labels": int(batch["labels"].numel())}
    if cfg.moe is not None:
        with torch.no_grad(), mesh_context(mesh):
            nll, count, extra, aux = build(cfg).loss_parts(
                compute_params(params, torch.float32), batch)
        out[f"{name}/aux"] = np.array([float(aux["lb_loss"]),
                                       float(aux["z_loss"])])
(loss, grads), _ = step(CASES["qwen2_dense"], planted=True)
out["planted_kv/loss"] = loss.numpy()
out.update({f"planted_kv/{k}": g.numpy() for k, g in grads.items()})
try:
    step(HALF_GROUP)
    info["half_group"] = "no error"
except ValueError as e:
    info["half_group"] = str(e)

# the capture on the shards, and with the planted zero rows
cfg = lra_cfg()
bundle = build(cfg)
from repro_torch.core.spion import SpionController, SpionState
cap = SpionController(cfg.spion, causal=cfg.causal,
                      seq_len=128).capture_kwargs(SpionState())
params = compute_params(masters(cfg), torch.float32)
batch = local_batch(meshes["seq"], lra_batch(), "cpu")
sound = A.next_shard_rows


def zero_rows(q, nf):
    return q.new_zeros((q.shape[0], nf, *q.shape[2:]))


for name, rows in (("capture", sound), ("planted_capture", zero_rows)):
    A.next_shard_rows = rows
    with torch.no_grad(), mesh_context(meshes["seq"]):
        aux = bundle.forward(params, batch, capture=cap)[1]
    pooled, frob = aux["captured"]
    out[f"{name}/pooled"], out[f"{name}/frob"] = pooled.numpy(), frob.numpy()
A.next_shard_rows = sound

np.savez(os.path.join(OUT, f"steps{pid}.npz"), **out)
json.dump(info, open(os.path.join(OUT, f"info{pid}.json"), "w"))

# the three-phase Trainer on the 'seq' mesh; its sparse phase takes the
# gather path, since a trained plan may be too wide for the halo exchange
# and this mesh has no data axis for the kernels' gathered fallback
from repro_torch.checkpoint import manager as mgr
from repro_torch.core.spion import plan_digest
from repro_torch.launch.train import Trainer
writes = []
inner_write = mgr.CheckpointManager._write
def write(self, step, *a, **k):
    writes.append(step)
    return inner_write(self, step, *a, **k)
mgr.CheckpointManager._write = write
tr = Trainer(cfg, seq_len=128, batch=4, lr=0.05, total_steps=100,
             steps_per_epoch=2, data_fn=trainer_data, device="cpu",
             sentinel=False, ckpt_dir=os.path.join(OUT, "ckpt"),
             mesh=meshes["seq"], sparse_kernel="jnp")
pooled = []
inner_obs = tr.spion_ctl.observe_epoch
def observe(state, p, f):
    pooled.append(np.array(p))
    return inner_obs(state, p, f)
tr.spion_ctl.observe_epoch = observe
phases = []
tr.step_callback = lambda s, l: phases.append(tr.spion_state.phase)
losses = tr.train(8, ckpt_every=8, log_every=100, log=lambda *a: None)
st = tr.spion_state
np.savez(os.path.join(OUT, f"pooled{pid}.npz"),
         **{f"p{i}": p for i, p in enumerate(pooled)})
json.dump({"losses": losses, "phases": phases, "phase": st.phase,
           "writes": writes,
           "digest": plan_digest(st.table_arrays(), st.tables["block"]),
           "tables": {k: v.tolist() for k, v in st.table_arrays().items()},
           "stats": st.plan_stats},
          open(os.path.join(OUT, f"trainer{pid}.json"), "w"))
print("SEQ_OK")
runtime.shutdown(0)
"""


@pytest.fixture(scope="module")
def seq_job(tmp_path_factory):
    """The 2-rank job's records: per rank the steps' npz, the info json,
    the pooled maps and the trainer's json; and the run directory."""
    d = tmp_path_factory.mktemp("seq_job")
    outs = run_distributed_case(SRC + WORKER, nproc=2, timeout=400,
                                env_extra=dict(MP_ENV, MP_OUT=str(d)))
    assert all("SEQ_OK" in o for o in outs)
    return {"dir": d,
            "steps": [dict(np.load(d / f"steps{i}.npz")) for i in range(2)],
            "info": [json.load(open(d / f"info{i}.json")) for i in range(2)],
            "pooled": [dict(np.load(d / f"pooled{i}.npz")) for i in range(2)],
            "trainer": [json.load(open(d / f"trainer{i}.json"))
                        for i in range(2)]}


def one_process(case):
    """(loss, {leaf: gradient}, aux (lb, z) or None) of the case's step in
    one process on the global batch."""
    from repro_torch.launch.steps import compute_params, make_loss_and_grads
    from repro_torch.models.registry import build
    cfg = case_cfg(case)
    params = masters(cfg)
    batch = {k: torch.as_tensor(v) for k, v in case_batch(case).items()}
    loss, grads = make_loss_and_grads(cfg)(params, batch, case_tables(case))
    aux = None
    if cfg.moe is not None:
        with torch.no_grad():
            aux = build(cfg).loss_parts(compute_params(params, torch.float32),
                                        batch)[3]
        aux = np.array([float(aux["lb_loss"]), float(aux["z_loss"])])
    return float(loss.detach()), {k: g.numpy() for k, g in grads.items()}, aux


@pytest.mark.parametrize("name", list(CASES))
def test_seq_and_moe_steps_match_one_process(seq_job, name):
    """A 2-rank step (the 'seq' mesh, or the data mesh for mixtral_data)
    equals the 1-process step on the global batch: loss within 3e-5,
    gradients within 1e-3, the ranks' gradients bitwise equal. The MoE's
    aux terms: identical on the ranks of a 'seq' line and equal to one
    process's; over data ranks their mean is the global one."""
    loss, grads, aux = one_process(CASES[name])
    ranks = seq_job["steps"]
    for r in ranks:
        assert abs(float(r[f"{name}/loss"]) - loss) <= 3e-5, \
            (name, float(r[f"{name}/loss"]), loss)
        for k, g in grads.items():
            np.testing.assert_allclose(r[f"{name}/{k}"], g, atol=1e-3, rtol=0,
                                       err_msg=f"{name} {k}")
            np.testing.assert_array_equal(r[f"{name}/{k}"],
                                          ranks[0][f"{name}/{k}"])
    if aux is not None:
        got = [r[f"{name}/aux"] for r in ranks]
        if CASES[name][3] == "seq":
            np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_allclose(np.mean(got, axis=0), aux, rtol=1e-6)
    if name == "internvl2_patches":
        # the first shard holds 64 of the 96 patches and no text
        assert [i[name]["labels"] for i in seq_job["info"]] == [0, 2 * 32]


def test_moe_half_group_raises(seq_job):
    """Two data ranks of 512 tokens each hold half of the global batch's one
    dispatch group of 1024: the step raises ValueError (the groups would
    not be the reference's), as the reference's grouping refuses T = 3200."""
    for info in seq_job["info"]:
        assert "not whole dispatch groups" in info["half_group"], \
            info["half_group"]


def test_planted_kv_gradient_fault_fails_the_gate(seq_job):
    """The K/V gather's backward keeping only this shard's gradient (no sum
    over 'seq') moves qwen2-7b's gradients past the gate of
    test_seq_and_moe_steps_match_one_process."""
    _, grads, _ = one_process(CASES["qwen2_dense"])
    worst = max(np.abs(seq_job["steps"][0][f"planted_kv/{k}"] - g).max()
                for k, g in grads.items())
    assert worst > 10 * 1e-3, worst


def test_capture_on_seq_shards_matches_one_process(seq_job):
    """The capture on 'seq' shards (filter of 31 rows, so every shard's last
    panel reads the next shard's first rows): the pooled map and the
    Frobenius term within 1e-6 of one process on every rank, the JAX
    controller's plan from the ranks' map bitwise the port's; the planted
    zero rows miss the gate."""
    import jax.numpy as jnp  # noqa: F401 - JAX on the CPU for the reference
    from repro.configs import get_config as jget
    from repro.core.spion import SpionController as JCtl
    from repro.core.spion import SpionState as JState
    from repro_torch.core.spion import SpionController, SpionState
    from repro_torch.models.registry import build
    from repro_torch.launch.steps import compute_params
    cfg = lra_cfg()
    assert cfg.spion.conv_filter_size > 1
    cap = SpionController(cfg.spion, causal=cfg.causal,
                          seq_len=S).capture_kwargs(SpionState())
    batch = {k: torch.as_tensor(v) for k, v in lra_batch().items()}
    with torch.no_grad():
        pooled, frob = build(cfg).forward(
            compute_params(masters(cfg), torch.float32), batch,
            capture=cap)[1]["captured"]
    for r in seq_job["steps"]:
        np.testing.assert_allclose(r["capture/pooled"], pooled.numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["capture/frob"], frob.numpy(),
                                   atol=0, rtol=1e-6)
        assert np.abs(r["planted_capture/pooled"] - pooled.numpy()).max() \
            > 1e-6
    got = seq_job["steps"][0]["capture/pooled"]
    jc = jget("spion-lra").reduced()
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=BLOCK))
    jst = JCtl(jc.spion, causal=jc.causal, seq_len=S).generate(JState(), got)
    tst = SpionController(cfg.spion, causal=cfg.causal,
                          seq_len=S).generate(SpionState(), got)
    for k, v in tst.table_arrays().items():
        np.testing.assert_array_equal(np.asarray(jst.tables[k]), v,
                                      err_msg=k)
    assert tst.plan_stats == jst.plan_stats


def test_seq_trainer_one_plan_one_writer(seq_job):
    """A 2-rank 'seq' Trainer through the transition: one plan on both ranks
    (digests equal), equal to the JAX controller's from the pooled map the
    ranks captured; dense losses within 3e-5 of the one-process Trainer's;
    the checkpoint written by process 0 alone, which the port's Trainer in
    one process and the JAX package's Trainer restore (step, phase,
    plan)."""
    from repro_torch.launch.train import Trainer
    runs = seq_job["trainer"]
    assert all(r["phase"] == "sparse" for r in runs)
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert set(runs[0]["writes"]) == {8} and runs[1]["writes"] == []
    pooled = seq_job["pooled"]
    for k in pooled[0]:
        np.testing.assert_array_equal(pooled[0][k], pooled[1][k])
    one = Trainer(lra_cfg(), seq_len=S, batch=4, lr=0.05, total_steps=100,
                  steps_per_epoch=2, data_fn=trainer_data, device="cpu",
                  sentinel=False)
    phases = []
    one.step_callback = lambda s, l: phases.append(one.spion_state.phase)
    want = one.train(8, log_every=100, log=lambda *a: None)
    dense = [i for i, p in enumerate(runs[0]["phases"]) if p == "dense"]
    assert dense and dense == [i for i, p in enumerate(phases)
                               if p == "dense"]
    for i in dense:
        assert abs(runs[0]["losses"][i] - want[i]) <= 3e-5, \
            (i, runs[0]["losses"][i], want[i])
    # the 'seq' job's checkpoint restores in one process
    from repro_torch.core.spion import plan_digest
    back = Trainer(lra_cfg(), seq_len=S, batch=4, steps_per_epoch=2,
                   data_fn=trainer_data, device="cpu", sentinel=False,
                   ckpt_dir=str(seq_job["dir"] / "ckpt"))
    assert back.maybe_resume() and back.step == 8
    assert back.spion_state.phase == "sparse"
    assert plan_digest(back.spion_state.table_arrays(),
                       back.spion_state.tables["block"]) == runs[0]["digest"]

    from repro.configs import get_config as jget
    from repro.core.spion import SpionController, SpionState
    from repro.core.spion import plan_digest as j_digest
    from repro.launch.train import Trainer as JTrainer
    jc = jget("spion-lra").reduced()
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=BLOCK, min_dense_epochs=1, max_dense_epochs=3))
    last = pooled[0][f"p{len(pooled[0]) - 1}"]
    jst = SpionController(jc.spion, causal=jc.causal,
                          seq_len=S).generate(SpionState(), last)
    for k, v in runs[0]["tables"].items():
        np.testing.assert_array_equal(np.asarray(jst.tables[k]),
                                      np.asarray(v, np.int32), err_msg=k)
    assert runs[0]["stats"] == jst.plan_stats
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = JTrainer(jc, seq_len=S, batch=4,
                      ckpt_dir=str(seq_job["dir"] / "ckpt"),
                      steps_per_epoch=2, sentinel=False)
        assert jt.maybe_resume()
    assert jt.step == 8 and jt.spion_state.phase == "sparse"
    assert j_digest(jt.spion_state.table_arrays(),
                    jt.spion_state.tables["block"]) == runs[0]["digest"]


def test_remat_recompute_runs_under_the_forward_mesh(monkeypatch):
    """With cfg.remat the backward runs each layer again; for CUDA tensors
    it does so on autograd's device thread, where the forward's mesh
    context is not set. The recomputed layer must see the forward's mesh
    (else a 'seq' shard recomputes without its K/V gather). Here the
    backward runs on another thread, as autograd's device thread would,
    and every layer's K/V step records the mesh it sees."""
    import threading
    from repro_torch.distributed.sharding import current_mesh, mesh_context
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import compute_params
    from repro_torch.models import transformer
    from repro_torch.models.registry import build
    cfg = lra_cfg().replace(remat=True)
    seen = []
    inner = transformer.gather_kv

    def gather_kv(k, v):
        seen.append(current_mesh())
        return inner(k, v)
    monkeypatch.setattr(transformer, "gather_kv", gather_kv)
    mesh = Mesh([[0], [1]], ("data", "model"))   # no 'seq': no collective
    params = masters(cfg)
    batch = {k: torch.as_tensor(v) for k, v in lra_batch().items()}
    with mesh_context(mesh):
        loss, _ = build(cfg).loss(compute_params(params, torch.float32),
                                  batch)
    assert seen == [mesh] * cfg.num_layers
    grads = []
    t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(
        loss, list(params.parameters()), allow_unused=True)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and grads
    assert seen == [mesh] * (2 * cfg.num_layers)
