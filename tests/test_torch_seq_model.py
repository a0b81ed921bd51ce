"""Port parity, 'seq' together with 'model', and the reference's fallback
for head counts that |model| does not divide.

  - One 4-rank gloo job runs every step case on two meshes built from the
    same four processes: (seq 2, model 2) (`make_distributed_mesh(seq=2,
    model=2)`: model lines {0, 1}, {2, 3}, 'seq' lines {0, 2}, {1, 3}) and
    (data 1, model 4). On (seq 2, model 2): reduced spion-lra dense, sparse
    through the halo exchange on each rank's KV-head shard, and sparse on
    a plan too wide for the halo (the sequence gathered over the rank's
    'seq' line, the kernels on its KV heads); reduced qwen2-7b sparse,
    mixtral-8x7b (experts over 'model', rows gathered over 'seq'),
    internvl2-2b (the vlm cut), zamba2-1.2b dense and sparse, rwkv6-7b
    dense, whisper-tiny dense and sparse. On model 4, the fallback:
    reduced whisper-tiny with 6 heads (wq's 96 columns are 24 a rank, 1.5
    heads) and qwen2-7b with 2 KV heads (wk's 32 columns are 8 a rank, half
    a head; RoPE), dense and sparse. Each is held against one process on
    the same global batch and masters: loss within 3e-5, gathered
    gradients within 1e-4 of each leaf's largest, the replicated leaves'
    gradients bitwise equal across each model line and every leaf's
    gradient bitwise equal across each 'seq' line.
  - Three cases against the JAX package's one-device step, their
    parameters through `params_from_numpy(mesh=)`: whisper-tiny with 6
    heads sparse (the reference's jnp gather path) and qwen2-7b with 2 KV
    heads on model 4, qwen2-7b sparse on (seq 2, model 2).
  - The fallback's capture (every head on every rank, no line mean)
    against one process, and a clipped step's global norm.
  - Planted faults, each past a gate: the gradient all-reduce over the
    data axes only, the halo neighbours taken from the global rank order,
    RoPE applied before the fallback's gather, the gather's backward
    without its sum or summed twice, the global norm summing the sharded
    leaves over 'seq' too, and `qkv` deciding on the query heads alone.
  - spion-lra's and zamba2's Trainers through the three phases on (seq 2,
    model 2): one plan digest, the one-process Trainer's; zamba2's
    checkpoint restores in one process, and a one-process checkpoint on
    the mesh, bitwise.
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import run_distributed_case

MP_ENV = {"OMP_NUM_THREADS": "1"}
GRAD_TOL = 1e-4          # of each gathered leaf's largest |element|
LOSS_TOL = 3e-5
GNORM_TOL = 1e-5         # relative

# shared by the workers and the test process: configs, batches, masters
SRC = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config

S = 128          # tokens a sequence: 8 blocks of 16, 8 chunks of 16
ENC = 64         # whisper's frames a sequence
B = 2            # sequences of the global batch


def arch_cfg(arch, **kw):
    c = get_config(arch).reduced()
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=16, kernel="fused"), **kw)


# case: (arch, config overrides, tables: None (dense), "halo" (a band a
# 'seq' shard's halo exchange covers) or "wide" (the dry-run's verticals))
CASES = {
    "lra_dense": ("spion-lra", {}, None),
    "lra_halo": ("spion-lra", {}, "halo"),
    "lra_wide": ("spion-lra", {}, "wide"),
    "qwen2_sparse": ("qwen2-7b", {}, "halo"),
    "mixtral_dense": ("mixtral-8x7b", {}, None),
    "internvl2_dense": ("internvl2-2b", {"vocab_size": 127}, None),
    "zamba2_dense": ("zamba2-1.2b", {"remat": True}, None),
    "zamba2_sparse": ("zamba2-1.2b", {"remat": True}, "halo"),
    "rwkv6_dense": ("rwkv6-7b", {}, None),
    "whisper_dense": ("whisper-tiny", {"remat": True}, None),
    "whisper_sparse": ("whisper-tiny", {"remat": True}, "halo"),
    # the head fallback on model 4
    "whisper6_dense": ("whisper-tiny", {"num_heads": 6, "num_kv_heads": 6},
                       None),
    "whisper6_sparse": ("whisper-tiny", {"num_heads": 6, "num_kv_heads": 6,
                                         "remat": True}, "wide"),
    "qwen2kv2_dense": ("qwen2-7b", {"num_kv_heads": 2}, None),
    "qwen2kv2_sparse": ("qwen2-7b", {"num_kv_heads": 2}, "wide"),
}
FALLBACK = ("whisper6_dense", "whisper6_sparse", "qwen2kv2_dense",
            "qwen2kv2_sparse")
STEPS = [(c, "model4" if c in FALLBACK else "seq2_model2") for c in CASES]


def case_cfg(name):
    arch, kw, _ = CASES[name]
    return arch_cfg(arch, **kw)


def case_batch(name, seed=7):
    cfg = case_cfg(name)
    rng = np.random.default_rng(seed)
    P = cfg.num_patch_tokens
    toks = rng.integers(0, cfg.vocab_size,
                        size=(B, S - P + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, ENC, cfg.d_model)).astype(
            np.float32)
    if P:
        b["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
    return b


def case_tables(name):
    from repro_torch.launch.steps import spion_dryrun_tables
    kind = CASES[name][2]
    if kind is None:
        return None
    return spion_dryrun_tables(case_cfg(name), S,
                               max_extent=1 if kind == "halo" else None)


def case_step(name, mesh=None):
    from repro_torch.launch.steps import make_loss_and_grads
    tables = case_tables(name)
    return make_loss_and_grads(
        case_cfg(name), mesh=mesh,
        halo=None if tables is None else tables["halo"])


def masters(cfg):
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    return masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu"))


def trainer_cfg(arch):
    c = case_cfg({"spion-lra": "lra_dense",
                  "zamba2-1.2b": "zamba2_dense"}[arch])
    return c.replace(spion=dataclasses.replace(
        c.spion, min_dense_epochs=1, max_dense_epochs=3))


def trainer_data(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(B, S + 1)).astype(np.int32)
    toks[:, 1::2] = toks[:, ::2][:, : toks[:, 1::2].shape[1]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def trainer(arch, **kw):
    from repro_torch.launch.train import Trainer
    return Trainer(trainer_cfg(arch), seq_len=S, batch=B, lr=0.05,
                   total_steps=100, steps_per_epoch=2, data_fn=trainer_data,
                   device="cpu", sentinel=False, **kw)


class _GatherBackward(torch.autograd.Function):
    \"\"\"gather_model with a planted backward: `times` sums over the line
    (0: the rank's part of its own gradient alone).\"\"\"

    @staticmethod
    def forward(ctx, x, times):
        from repro_torch.distributed import sharding
        mesh = sharding.active_mesh()
        ctx.times, ctx.group = times, mesh.group("model")
        ctx.idx = mesh.axis_index("model")
        return sharding.gather_model(x.detach(), 0)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.float().clone()
        for _ in range(ctx.times):
            dist.all_reduce(g, group=ctx.group)
        return g.narrow(0, ctx.idx, 1), None


def planted(fault, mesh=None):
    \"\"\"[(module, name, replacement)] of a planted fault (`mesh`: the
    step's, for the norm summed over its 'seq' line).\"\"\"
    import torch.distributed as dist
    from repro_torch.distributed import runtime, sharding
    from repro_torch.kernels import sharded
    from repro_torch.launch import steps
    from repro_torch.models import attention
    from repro_torch.models.layers import rope
    sound_gather = attention.gather_columns

    def rope_first(parts):
        # RoPE on each rank's columns of q and k before the gather, each
        # block of up to hd columns taken as a head (mid-head columns
        # rotate the wrong pairs); positions: no 'seq' axis on model 4
        hd = case_cfg("qwen2kv2_dense").resolved_head_dim
        out = []
        for i, t in enumerate(parts):
            if t is not None and i < 2:
                w = min(hd, t.shape[-1])
                t = rope(t.reshape(*t.shape[:2], -1, w),
                         torch.arange(t.shape[1]), 1e6).reshape(t.shape)
            out.append(t)
        return sound_gather(out)

    def norm_over_seq(g, max_norm, sharded_=(), group=None):
        # the sharded leaves' squares summed over the model line and then
        # over 'seq' as well (|seq| times what they are)
        sq = {k: (x.float() ** 2).sum() for k, x in g.items()}
        rep = sum(s for k, s in sq.items() if k not in sharded_)
        shard = sum(s for k, s in sq.items() if k in sharded_)
        dist.all_reduce(shard, group=group)
        dist.all_reduce(shard, group=mesh.group("seq"))
        norm = torch.sqrt(rep + shard)
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return {k: x * scale for k, x in g.items()}, norm

    def global_order(mesh):
        r, n = runtime.process_index(), mesh.size
        return mesh.group(mesh.axis_names), (r - 1) % n, (r + 1) % n
    return {
        # the loss terms and gradients summed over the data axes only
        "grad_data_only": [(steps, "reduce_axes",
                            lambda mesh: sharding.data_axes(mesh))],
        # the halo neighbours from the global rank order (the next rank is
        # the same 'seq' shard's other KV heads)
        "halo_global": [(sharded, "halo_peers", global_order)],
        # RoPE on each rank's columns before the fallback's gather
        "rope_before_gather": [(attention, "gather_columns", rope_first),
                               (attention, "rope_heads",
                                lambda cfg, q, k, positions: (q, k))],
        # the fallback gather's backward without its sum, or summed twice
        "gather_no_sum": [(attention, "gather_model",
                           lambda x, dim: _GatherBackward.apply(x, 0))],
        "gather_sum_twice": [(attention, "gather_model",
                              lambda x, dim: _GatherBackward.apply(x, 2))],
        # the global norm summing the sharded leaves over 'seq' as well
        "norm_over_seq": [(steps, "clip_by_global_norm", norm_over_seq)],
        # qkv deciding on the query heads alone
        "heads_by_H": [(attention, "heads_split",
                        lambda cfg: sharding.model_split(cfg.num_heads))],
    }[fault]


class Planted:
    def __init__(self, fault, mesh=None):
        self.patches = planted(fault, mesh)

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


# (fault, case): each on the case's mesh
FAULT_CASES = [("grad_data_only", "lra_dense"), ("halo_global", "lra_halo"),
               ("rope_before_gather", "qwen2kv2_dense"),
               ("gather_no_sum", "whisper6_dense"),
               ("gather_sum_twice", "whisper6_dense"),
               ("heads_by_H", "qwen2kv2_dense")]
CLIP_CASE = "qwen2_sparse"
CAPTURE_CASE = "whisper6_dense"
# the cases also held against the JAX package's one-device step
JAX_CASES = ("whisper6_sparse", "qwen2kv2_dense", "qwen2_sparse")
"""
exec(SRC)

WORKER = """
import json, os
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
from repro_torch.convert import params_from_numpy
from repro_torch.core.spion import SpionController, SpionState, plan_digest
from repro_torch.data.pipeline import local_batch
from repro_torch.distributed.sharding import (gather_params, mesh_context,
                                              param_pspecs, shard_params,
                                              sharded_dim)
from repro_torch.launch.mesh import make_distributed_mesh
from repro_torch.launch.steps import compute_params, make_train_step
from repro_torch.launch.train import nest
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build
from repro_torch.optim import adamw_init
MESHES = {"seq2_model2": make_distributed_mesh(seq=2, model=2),
          "model4": make_distributed_mesh(model=4)}
MESH_OF = dict(STEPS)
out, info = {}, {m: {"coords": mesh.coords(), "model": mesh.line("model"),
                     "seq": mesh.line("seq")}
                 for m, mesh in MESHES.items()}


def record(key, loss, grads, specs, cfg, mesh):
    out[f"{key}/loss"] = loss.detach().numpy()
    for k, v in gather_params(grads, specs, mesh, cfg).items():
        out[f"{key}/g/{k}"] = v.numpy()
    for k, v in grads.items():
        out[f"{key}/local/{k}"] = v.numpy()
        if sharded_dim(specs[k]) is None:
            info.setdefault("replicated", {}).setdefault(key, []).append(k)


def shards(name, mesh):
    cfg = case_cfg(name)
    full = masters(cfg)
    specs = param_pspecs(full, mesh)
    return cfg, specs, ParamTree(nest(shard_params(full, mesh, specs, cfg)),
                                 trainable=True)


def step(name, key=None):
    mesh = MESHES[MESH_OF[name]]
    cfg, specs, params = shards(name, mesh)
    batch = local_batch(mesh, case_batch(name), "cpu")
    loss, grads = case_step(name, mesh)(params, batch, case_tables(name))
    record(key or name, loss, grads, specs, cfg, mesh)
    if name in FALLBACK:
        info.setdefault("shapes", {})[name] = {
            n: list(p.shape) for n, p in params.named_parameters()
            if n.split(".")[-1] in ("wq", "wk", "wv", "wo", "bq", "bk")}


for name, _ in STEPS:
    step(name)
for fault, name in FAULT_CASES:
    try:
        with Planted(fault):
            step(name, f"planted_{fault}/{name}")
    except RuntimeError as e:
        info.setdefault("raised", {})[fault] = str(e)[:300]

# a clipped train step, sound and with the norm summed over 'seq' too
mesh = MESHES[MESH_OF[CLIP_CASE]]
for kind in ("sound", "planted"):
    cfg, specs, params = shards(CLIP_CASE, mesh)
    tables = case_tables(CLIP_CASE)
    stepf = make_train_step(cfg, spion=True, mesh=mesh, specs=specs,
                            halo=tables["halo"])
    args = (params, adamw_init(params),
            local_batch(mesh, case_batch(CLIP_CASE), "cpu"), 0, tables)
    if kind == "planted":
        with Planted("norm_over_seq", mesh):
            metrics = stepf(*args)[2]
    else:
        metrics = stepf(*args)[2]
    out[f"clip_{kind}/gnorm"] = metrics["gnorm"].numpy()

# the fallback's capture: every head on every rank, no line mean
mesh = MESHES[MESH_OF[CAPTURE_CASE]]
cfg, _, params = shards(CAPTURE_CASE, mesh)
cap = SpionController(cfg.spion, causal=cfg.causal,
                      seq_len=S).capture_kwargs(SpionState())
with torch.no_grad(), mesh_context(mesh):
    pooled, frob = build(cfg).forward(
        compute_params(params, torch.float32),
        local_batch(mesh, case_batch(CAPTURE_CASE), "cpu"),
        capture=cap)[1]["captured"]
out["capture/pooled"], out["capture/frob"] = pooled.numpy(), frob.numpy()

# the JAX package's parameters, each rank's shard through params_from_numpy
for name in JAX_CASES:
    cfg, mesh = case_cfg(name), MESHES[MESH_OF[name]]
    with np.load(os.path.join(os.environ["MP_JAX"], f"{name}.npz")) as z:
        tree = nest({k.replace("/", "."): z[k] for k in z.files})
    jp = ParamTree(dict(params_from_numpy(tree, cfg, "cpu",
                                          mesh=mesh).items()),
                   trainable=True)
    loss, grads = case_step(name, mesh)(
        jp, local_batch(mesh, case_batch(name), "cpu"), case_tables(name))
    record(f"jax_{name}", loss, grads, param_pspecs(tree, mesh), cfg, mesh)

# the three-phase Trainers on (seq 2, model 2); zamba2's checkpoint at 8
mesh = MESHES["seq2_model2"]
for arch in ("spion-lra", "zamba2-1.2b"):
    ckpt = os.path.join(OUT, "ckpt") if arch == "zamba2-1.2b" else None
    tr = trainer(arch, mesh=mesh, ckpt_dir=ckpt)
    phases = []
    tr.step_callback = lambda s, l: phases.append(tr.spion_state.phase)
    losses = tr.train(8, ckpt_every=8, log_every=100, log=lambda *a: None)
    st = tr.spion_state
    for k, v in gather_params(dict(tr.params.named_parameters()), tr._specs,
                              mesh, tr.cfg).items():
        out[f"trainer_{arch}/p/{k}"] = v.detach().numpy()
    for k, v in tr.params.named_parameters():
        out[f"trainer_{arch}/local/{k}"] = v.detach().numpy()
    info[f"trainer_{arch}"] = {
        "losses": losses, "phases": phases, "phase": st.phase,
        "digest": plan_digest(st.table_arrays(), st.tables["block"])}

# a one-process checkpoint of zamba2 restored on (seq 2, model 2)
back = trainer("zamba2-1.2b", mesh=mesh, ckpt_dir=os.environ["MP_CKPT"])
assert back.maybe_resume()
info["restored_step"] = back.step
for part, named in (("p", dict(back.params.named_parameters())),
                    ("mu", back.opt["mu"]), ("nu", back.opt["nu"])):
    for k, v in gather_params(named, back._specs, mesh, back.cfg).items():
        out[f"restored/{part}/{k}"] = v.detach().numpy()

np.savez(os.path.join(OUT, f"rank{pid}.npz"), **out)
json.dump(info, open(os.path.join(OUT, f"info{pid}.json"), "w"))
print("SEQ_MODEL_OK")
runtime.shutdown(0)
"""


def jax_case(name):
    """(JAX parameters as {'/'-path: array}, the reference's loss and
    {dotted name: gradient}) of case `name`'s step in one process, fp32; a
    sparse case runs the reference's jnp gather path on its own dry-run
    tables, which equal the port's."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch.steps import spion_dryrun_tables
    from repro.models.registry import build as jbuild
    arch, kw, kind = CASES[name]
    tc = case_cfg(name)
    jc = jget(arch).reduced()
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=16, kernel="jnp" if kind else "fused"), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc.replace(
        spion=dataclasses.replace(tc.spion, kernel=jc.spion.kernel)))
    jp = jbuild(jc).init(jax.random.key(0))
    b = {k: jnp.asarray(v) for k, v in case_batch(name).items()}
    spion = None
    if kind:
        spion = spion_dryrun_tables(jc, S, max_extent=1 if kind == "halo"
                                    else None)
        for k in ("col_idx", "nvalid"):
            np.testing.assert_array_equal(np.asarray(spion[k]),
                                          np.asarray(case_tables(name)[k]))
    (loss, _), g = jax.value_and_grad(
        lambda p: jbuild(jc).loss(p, b, spion=spion), has_aux=True)(jp)

    def flat(tree, sep):
        return {sep.join(k.key for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    return flat(jp, "/"), float(loss), flat(g, ".")


@pytest.fixture(scope="module")
def mp_job(tmp_path_factory):
    """The 4-rank job's records: per rank its npz and info json; the JAX
    cases; the one-process checkpoint's state; and the run directory."""
    d = tmp_path_factory.mktemp("seq_model_job")
    jax_runs = {}
    (d / "jax").mkdir()
    for name in JAX_CASES:
        jparams, jloss, jgrads = jax_case(name)
        np.savez(d / "jax" / f"{name}.npz", **jparams)
        jax_runs[name] = (jloss, jgrads)
    # a one-process checkpoint of zamba2 (step 4, dense phase) for the
    # ranks to restore
    one = trainer("zamba2-1.2b", ckpt_dir=str(d / "one"))
    one.train(4, ckpt_every=4, log_every=100, log=lambda *a: None)
    state = {"p": {n: p.detach().numpy().copy()
                   for n, p in one.params.named_parameters()},
             "mu": {n: v.numpy().copy() for n, v in one.opt["mu"].items()},
             "nu": {n: v.numpy().copy() for n, v in one.opt["nu"].items()}}
    shutil.copytree(d / "one", d / "one_copy")
    outs = run_distributed_case(
        SRC + WORKER, nproc=4, timeout=300,
        env_extra=dict(MP_ENV, MP_OUT=str(d), MP_JAX=str(d / "jax"),
                       MP_CKPT=str(d / "one_copy")))
    assert all("SEQ_MODEL_OK" in o for o in outs)
    return {"dir": d, "jax": jax_runs, "one_ckpt": state,
            "ranks": [dict(np.load(d / f"rank{i}.npz")) for i in range(4)],
            "info": [json.load(open(d / f"info{i}.json")) for i in range(4)]}


_ONE = {}


def one_process(name):
    """(loss, {leaf: gradient}) of case `name`'s step in one process on the
    global batch (cached)."""
    if name not in _ONE:
        cfg = case_cfg(name)
        batch = {k: torch.as_tensor(v) for k, v in case_batch(name).items()}
        loss, grads = case_step(name)(masters(cfg), batch, case_tables(name))
        _ONE[name] = (float(loss.detach()),
                      {k: g.numpy() for k, g in grads.items()})
    return _ONE[name]


def grad_gap(rec, key, want):
    """The worst leaf's max |difference| over its largest |element|."""
    return max(float(np.abs(rec[f"{key}/g/{k}"] - g).max()
                     / max(np.abs(g).max(), 1e-30)) for k, g in want.items())


def lines(job, mesh_name, axis):
    return {tuple(i[mesh_name][axis]) for i in job["info"]}


@pytest.mark.parametrize("name,mesh_name", STEPS)
def test_seq_model_steps_match_one_process(mp_job, name, mesh_name):
    """Each case's step on its mesh: loss within 3e-5 of one process's, its
    gradients, gathered over the model line, within 1e-4 of each leaf's
    largest; every rank holds the same gathered gradients, the replicated
    leaves' gradients agree bitwise across each model line, and every
    leaf's gradient (the rank's shard) bitwise across each 'seq' line."""
    loss, grads = one_process(name)
    ranks = mp_job["ranks"]
    for r, rec in enumerate(ranks):
        assert abs(float(rec[f"{name}/loss"]) - loss) <= LOSS_TOL, \
            (name, r, float(rec[f"{name}/loss"]), loss)
        assert grad_gap(rec, name, grads) <= GRAD_TOL, (name, r)
        for k in grads:
            np.testing.assert_array_equal(rec[f"{name}/g/{k}"],
                                          ranks[0][f"{name}/g/{k}"])
    rep = mp_job["info"][0]["replicated"][name]
    assert rep
    for line in lines(mp_job, mesh_name, "model"):
        for r in line[1:]:
            for k in rep:
                np.testing.assert_array_equal(
                    ranks[r][f"{name}/local/{k}"],
                    ranks[line[0]][f"{name}/local/{k}"], err_msg=k)
    for line in lines(mp_job, mesh_name, "seq"):
        for r in line[1:]:
            for k in grads:
                np.testing.assert_array_equal(
                    ranks[r][f"{name}/local/{k}"],
                    ranks[line[0]][f"{name}/local/{k}"], err_msg=k)


def test_meshes_and_lines(mp_job):
    """make_distributed_mesh(seq=2, model=2) is the reference's (pod, seq,
    data, model) mesh with model ranks adjacent: model lines {0, 1} and
    {2, 3}, 'seq' lines {0, 2} and {1, 3}; model 4 is one line."""
    assert lines(mp_job, "seq2_model2", "model") == {(0, 1), (2, 3)}
    assert lines(mp_job, "seq2_model2", "seq") == {(0, 2), (1, 3)}
    assert lines(mp_job, "model4", "model") == {(0, 1, 2, 3)}
    assert mp_job["info"][3]["seq2_model2"]["coords"] == {
        "pod": 0, "seq": 1, "data": 0, "model": 1}


def test_fallback_shards_are_the_reference_specs(mp_job):
    """Under the fallback every rank holds the reference's spec shard of
    wq, wk, wv and wo: whisper-tiny's 6 heads of 16 on model 4 are 24
    columns of wq a rank (1.5 heads) and 24 rows of wo; qwen2-7b's 2 KV
    heads of 16 are 8 columns of wk and 8 of bk (half a head). The specs
    are bitwise the JAX package's (test_torch_model_parallel holds
    param_pspecs and zero1_pspecs on every config)."""
    from repro.distributed import sharding as ref
    from repro_torch.distributed import sharding as port
    from repro_torch.launch.mesh import Mesh
    shapes = mp_job["info"][0]["shapes"]
    w6 = shapes["whisper6_dense"]
    assert w6["dec_layers.attn.wq"] == [2, 64, 24]
    assert w6["dec_layers.attn.wo"] == [2, 24, 64]
    assert w6["dec_layers.attn.wk"] == [2, 64, 24]
    q2 = shapes["qwen2kv2_dense"]
    assert q2["layers.attn.wq"] == [2, 64, 16]
    assert q2["layers.attn.wk"] == [2, 64, 8]
    assert q2["layers.attn.bk"] == [2, 8]
    mesh = Mesh(np.arange(4).reshape(1, 4), ("data", "model"))
    leaves = masters(case_cfg("whisper6_dense"))
    for n, p in leaves.named_parameters():
        if n.split(".")[-1] in ("wq", "wk", "wv", "wo"):
            assert port.best_spec(mesh, n.replace(".", "/"), p) == \
                tuple(ref.best_spec(mesh, n.replace(".", "/"), p))


@pytest.mark.parametrize("name", JAX_CASES)
def test_step_matches_the_jax_package(mp_job, name):
    """The case's step on its mesh, its shards loaded from the JAX
    package's parameters through params_from_numpy(mesh=), against the JAX
    package's one-device loss and jax.grad: loss within 3e-5, gathered
    gradients within 1e-4 of each leaf's largest. The cases: whisper-tiny
    with 6 heads sparse (the reference's jnp gather path) and qwen2-7b with
    2 KV heads on model 4 (the fallback), qwen2-7b sparse on (seq 2,
    model 2)."""
    jloss, jgrads = mp_job["jax"][name]
    assert sorted(jgrads) == sorted(one_process(name)[1])
    for rec in mp_job["ranks"]:
        assert abs(float(rec[f"jax_{name}/loss"]) - jloss) <= LOSS_TOL
        assert grad_gap(rec, f"jax_{name}", jgrads) <= GRAD_TOL


def test_fallback_capture_and_clipped_norm(mp_job):
    """The fallback's capture (whisper-tiny's 6 heads on model 4: every
    rank holds every head and takes no line mean) equals one process's
    within 1e-6; a clipped step's global norm on (seq 2, model 2) is
    within 1e-5 of one process's, and summing the sharded leaves' squares
    over 'seq' as well moves it past that."""
    from repro_torch.core.spion import SpionController, SpionState
    from repro_torch.launch.steps import compute_params, make_train_step
    from repro_torch.models.registry import build
    from repro_torch.optim import adamw_init
    cfg = case_cfg(CAPTURE_CASE)
    cap = SpionController(cfg.spion, causal=cfg.causal,
                          seq_len=S).capture_kwargs(SpionState())
    with torch.no_grad():
        pooled, frob = build(cfg).forward(
            compute_params(masters(cfg), torch.float32),
            {k: torch.as_tensor(v)
             for k, v in case_batch(CAPTURE_CASE).items()},
            capture=cap)[1]["captured"]
    for rec in mp_job["ranks"]:
        np.testing.assert_allclose(rec["capture/pooled"], pooled.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rec["capture/frob"], frob.numpy(),
                                   rtol=1e-6)
    cfg = case_cfg(CLIP_CASE)
    tables = case_tables(CLIP_CASE)
    p = masters(cfg)
    want = float(make_train_step(cfg, spion=True)(
        p, adamw_init(p), {k: torch.as_tensor(v)
                           for k, v in case_batch(CLIP_CASE).items()},
        0, tables)[2]["gnorm"])
    assert want > 1.0              # the step clips
    for rec in mp_job["ranks"]:
        assert abs(float(rec["clip_sound/gnorm"]) - want) <= GNORM_TOL * want
        assert abs(float(rec["clip_planted/gnorm"]) - want) > \
            100 * GNORM_TOL * want


@pytest.mark.parametrize("fault,name", FAULT_CASES)
def test_planted_faults_miss_a_gate(mp_job, fault, name):
    """Each planted fault moves the loss past 3e-5, a gathered gradient past
    1e-4 of its leaf's largest, or a replicated leaf's gradient apart
    across the model line: the gradient all-reduce over the data axes only
    (no 'seq'), the halo neighbours from the global rank order, RoPE on
    each rank's columns before the fallback's gather, that gather's
    backward without its sum or summed twice. `qkv` deciding on the query
    heads alone for 2 KV heads on 4 ranks cuts wk's 8 columns into heads
    of 16: it raises in the reshape, before any collective, on every
    rank."""
    info = mp_job["info"]
    if fault == "heads_by_H":
        for i in info:
            assert "shape" in i["raised"][fault], i["raised"][fault]
        return
    assert all(fault not in i.get("raised", {}) for i in info)
    loss, grads = one_process(name)
    key = f"planted_{fault}/{name}"
    ranks = mp_job["ranks"]
    rep = info[0]["replicated"][key]
    apart = any(not np.array_equal(ranks[0][f"{key}/local/{k}"],
                                   ranks[1][f"{key}/local/{k}"]) for k in rep)
    assert any(abs(float(rec[f"{key}/loss"]) - loss) > LOSS_TOL or
               grad_gap(rec, key, grads) > 10 * GRAD_TOL
               for rec in ranks) or apart, (fault, name)


@pytest.mark.parametrize("arch", ["spion-lra", "zamba2-1.2b"])
def test_trainer_one_plan(mp_job, arch):
    """The three-phase Trainer on (seq 2, model 2): one plan on every rank,
    the one-process Trainer's; dense losses within 3e-5 of it; every rank
    the same losses, the masters' shards equal across each 'seq' line."""
    from repro_torch.core.spion import plan_digest
    runs = [i[f"trainer_{arch}"] for i in mp_job["info"]]
    assert all(r["phase"] == "sparse" for r in runs)
    assert len({r["digest"] for r in runs}) == 1
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    one = trainer(arch)
    phases = []
    one.step_callback = lambda s, l: phases.append(one.spion_state.phase)
    want = one.train(8, log_every=100, log=lambda *a: None)
    assert phases == runs[0]["phases"]
    for i, p in enumerate(phases):
        if p == "dense":
            assert abs(runs[0]["losses"][i] - want[i]) <= LOSS_TOL, i
    st = one.spion_state
    assert plan_digest(st.table_arrays(), st.tables["block"]) == \
        runs[0]["digest"]
    ranks = mp_job["ranks"]
    for line in lines(mp_job, "seq2_model2", "seq"):
        for k in ranks[line[0]]:
            if k.startswith(f"trainer_{arch}/local/"):
                np.testing.assert_array_equal(ranks[line[1]][k],
                                              ranks[line[0]][k], err_msg=k)


def test_checkpoints_both_ways(mp_job):
    """zamba2's checkpoint written on (seq 2, model 2) (process 0, every
    sharded leaf gathered over its model line) restores in one process
    onto the mesh's gathered masters, plan and all; a one-process
    checkpoint restores on the mesh onto each rank's shards, moments
    included, bitwise."""
    from repro_torch.core.spion import plan_digest
    digest = mp_job["info"][0]["trainer_zamba2-1.2b"]["digest"]
    back = trainer("zamba2-1.2b", ckpt_dir=str(mp_job["dir"] / "ckpt"))
    assert back.maybe_resume() and back.step == 8
    assert plan_digest(back.spion_state.table_arrays(),
                       back.spion_state.tables["block"]) == digest
    rec = mp_job["ranks"][0]
    for n, p in back.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      rec[f"trainer_zamba2-1.2b/p/{n}"],
                                      err_msg=n)
    state = mp_job["one_ckpt"]
    for r, rec in enumerate(mp_job["ranks"]):
        assert mp_job["info"][r]["restored_step"] == 4
        for kind, named in state.items():
            for n, v in named.items():
                np.testing.assert_array_equal(rec[f"restored/{kind}/{n}"], v,
                                              err_msg=f"{kind} {n}")
