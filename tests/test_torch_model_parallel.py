"""Port parity, the 'model' axis (tensor, expert and vocabulary parallelism)
for the encoder, dense, moe and vlm families.

  - The parameter rules (`spec_for_path`, `spec_candidates`,
    `sanitize_spec`, `best_spec`, `param_pspecs`, `zero1_pspecs`) against
    the JAX package's, compared as tuples, on every architecture's
    full-size leaf shapes (an init on the meta device) and five meshes. The
    reference's functions read only `mesh.shape` and `axis_names`, so a
    port `Mesh` is passed to both.
  - One 4-rank gloo job on (data 2, model 2) runs every step case and the
    planted faults; the tests hold its records against one process on the
    same global batch and masters (the reference's own mesh step does not
    run here: ROADMAP.md §C notes): reduced spion-lra dense and sparse (the
    kernels' plain versions, on each rank's KV-head shard), reduced
    qwen2-7b with 2 KV heads dense and sparse, reduced mixtral with its 4
    experts over 'model' and with 3 (d_ff split within each expert),
    reduced internvl2-2b with a vocabulary of 127 (the embedding and the
    head replicated); loss within 3e-5, gathered gradients within 1e-4 of
    each leaf's largest, the replicated leaves' gradients bitwise equal
    across the model line. Also the capture and the plan, the global norm
    of a clipped step, the three-phase Trainer, the checkpoint both ways
    between one process and (data 2, model 2), and five cases' steps
    against the JAX package's one-device step (their parameters through
    `params_from_numpy(mesh=)`): qwen2-7b dense and sparse (the
    reference's jnp gather path), mixtral's experts over 'model' and its
    d_ff fallback, internvl2-2b's replicated vocabulary.
  - The layouts that once raised build and convert: KV heads, whisper's
    heads and SSM widths |model| does not divide (the reference's
    fallbacks) and 'seq' with 'model'; they step in
    test_torch_seq_model.py and test_torch_model_scan.py.
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

# shared by the workers and the test process: configs, batches, masters
SRC = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config


def arch_cfg(arch, **kw):
    c = get_config(arch).reduced()
    if arch in ("qwen2-7b", "internvl2-2b"):
        kw.setdefault("num_kv_heads", 2)
    if "num_experts" in kw:
        kw["moe"] = dataclasses.replace(c.moe,
                                        num_experts=kw.pop("num_experts"))
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=32, kernel="fused"), **kw)


# case: (config, global batch rows, sequence length (vlm: patches + text),
# sparse)
CASES = {
    "lra_dense": (("spion-lra", {}), 4, 128, False),
    "lra_sparse": (("spion-lra", {}), 4, 128, True),
    "qwen2_dense": (("qwen2-7b", {}), 4, 128, False),
    "qwen2_sparse": (("qwen2-7b", {}), 4, 128, True),
    "mixtral_experts": (("mixtral-8x7b", {}), 4, 512, False),
    "mixtral_ff": (("mixtral-8x7b", {"num_experts": 3}), 4, 512, False),
    "internvl2_vocab127": (("internvl2-2b", {"vocab_size": 127}), 4, 128,
                           False),
}


def case_cfg(case):
    (arch, kw), *_ = case
    return arch_cfg(arch, **dict(kw))


def case_batch(case, seed=7):
    cfg = case_cfg(case)
    _, B, L, _ = case
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
    if not case[3]:
        return None
    return spion_dryrun_tables(case_cfg(case), case[2])


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


def trainer(**kw):
    from repro_torch.launch.train import Trainer
    return Trainer(lra_cfg(), seq_len=128, batch=4, lr=0.05,
                   total_steps=100, steps_per_epoch=2, data_fn=trainer_data,
                   device="cpu", sentinel=False, **kw)


def planted(fault):
    \"\"\"[(module, name, replacement)] of a planted fault.\"\"\"
    from repro_torch.launch import steps
    from repro_torch.models import attention, moe, registry
    from repro_torch.optim import clip_by_global_norm
    return {
        # the loss terms and gradients summed over the whole mesh
        "whole_mesh": [(steps, "reduce_axes", lambda mesh: mesh.axis_names)],
        # a norm of this rank's shards alone
        "local_norm": [(steps, "clip_by_global_norm",
                        lambda g, n, sharded=(), group=None:
                        clip_by_global_norm(g, n))],
        # the capture averaging this rank's heads only
        "local_heads": [(attention, "model_mean", lambda x: x)],
        # attn_out's partial output kept without its sum
        "attn_out": [(attention, "row_parallel",
                      lambda x, w: x @ w.to(x.dtype))],
        # the vocab-parallel loss without the model line's max and sums
        "vocab_loss": [(registry, "model_max", lambda x: x),
                       (registry, "reduce_from_model",
                        lambda x, dtype=None: x)],
        # the MoE's partial combine without its sum
        "moe_combine": [(moe, "reduce_from_model",
                         lambda x, dtype=None: x.to(dtype or x.dtype))],
    }[fault]


class Planted:
    def __init__(self, fault):
        self.patches = planted(fault)

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


FAULT_CASES = {"whole_mesh": "lra_dense", "attn_out": "qwen2_dense",
               "vocab_loss": "qwen2_dense", "moe_combine": "mixtral_experts"}
CLIP_CASE = "qwen2_sparse"      # global norm 1.058 at init: clipped
# the cases also held against the JAX package's one-device step
JAX_CASES = ("qwen2_dense", "qwen2_sparse", "mixtral_experts", "mixtral_ff",
             "internvl2_vocab127")
"""
exec(SRC)

WORKER = """
import hashlib, json, os
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
from repro_torch.launch.steps import (compute_params, make_loss_and_grads,
                                      make_train_step)
from repro_torch.launch.train import nest
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build
from repro_torch.optim import adamw_init
mesh = make_distributed_mesh(model=2, data=2)
out, info = {}, {"coords": mesh.coords()}


def shards(cfg, full):
    specs = param_pspecs(full, mesh)
    return specs, ParamTree(nest(shard_params(full, mesh, specs)),
                            trainable=True)


def record(name, loss, grads, specs):
    out[f"{name}/loss"] = loss.detach().numpy()
    for k, v in gather_params(grads, specs, mesh).items():
        out[f"{name}/g/{k}"] = v.numpy()
    for k, v in grads.items():
        if sharded_dim(specs[k]) is None:
            out[f"{name}/local/{k}"] = v.numpy()


def step(name):
    case = CASES[name]
    cfg = case_cfg(case)
    specs, params = shards(cfg, masters(cfg))
    f = make_loss_and_grads(cfg, mesh=mesh)
    batch = local_batch(mesh, case_batch(case), "cpu")
    info[f"{name}/batch"] = hashlib.sha256(
        batch["tokens"].numpy().tobytes()).hexdigest()
    return f(params, batch, case_tables(case)), specs


for name in CASES:
    (loss, grads), specs = step(name)
    record(name, loss, grads, specs)
for fault, name in FAULT_CASES.items():
    with Planted(fault):
        (loss, grads), specs = step(name)
    record(f"planted_{fault}", loss, grads, specs)

# the JAX package's parameters, each rank's shard through params_from_numpy
for name in JAX_CASES:
    case = CASES[name]
    cfg = case_cfg(case)
    with np.load(os.path.join(os.environ["MP_JAX"], f"{name}.npz")) as z:
        tree = nest({k.replace("/", "."): z[k] for k in z.files})
    jp = ParamTree(dict(params_from_numpy(tree, cfg, "cpu",
                                          mesh=mesh).items()),
                   trainable=True)
    loss, grads = make_loss_and_grads(cfg, mesh=mesh)(
        jp, local_batch(mesh, case_batch(case), "cpu"), case_tables(case))
    record(f"jax_{name}", loss, grads, param_pspecs(tree, mesh))

# a clipped train step, sound and with a local norm
case = CASES[CLIP_CASE]
cfg = case_cfg(case)
for kind in ("sound", "planted"):
    specs, params = shards(cfg, masters(cfg))
    stepf = make_train_step(cfg, spion=True, mesh=mesh, specs=specs)
    args = (params, adamw_init(params), local_batch(mesh, case_batch(case),
                                                    "cpu"), 0,
            case_tables(case))
    if kind == "planted":
        with Planted("local_norm"):
            metrics = stepf(*args)[2]
    else:
        metrics = stepf(*args)[2]
    out[f"clip_{kind}/gnorm"] = metrics["gnorm"].numpy()

# the capture, sound and averaging the rank's heads only
cfg = lra_cfg()
cap = SpionController(cfg.spion, causal=cfg.causal,
                      seq_len=128).capture_kwargs(SpionState())
_, params = shards(cfg, masters(cfg))
batch = local_batch(mesh, lra_batch(), "cpu")
for name in ("capture", "planted_local_heads"):
    with torch.no_grad(), mesh_context(mesh):
        if name == "capture":
            pooled, frob = build(cfg).forward(compute_params(
                params, torch.float32), batch, capture=cap)[1]["captured"]
        else:
            with Planted("local_heads"):
                pooled, frob = build(cfg).forward(compute_params(
                    params, torch.float32), batch,
                    capture=cap)[1]["captured"]
    out[f"{name}/pooled"], out[f"{name}/frob"] = pooled.numpy(), frob.numpy()

# the three-phase Trainer on (data 2, model 2); its checkpoint at step 8
tr = trainer(mesh=mesh, ckpt_dir=os.path.join(OUT, "ckpt"))
phases = []
tr.step_callback = lambda s, l: phases.append(tr.spion_state.phase)
losses = tr.train(8, ckpt_every=8, log_every=100, log=lambda *a: None)
st = tr.spion_state
for k, v in gather_params(dict(tr.params.named_parameters()), tr._specs,
                          mesh).items():
    out[f"trainer/p/{k}"] = v.detach().numpy()
info["trainer"] = {"losses": losses, "phases": phases, "phase": st.phase,
                   "digest": plan_digest(st.table_arrays(),
                                         st.tables["block"]),
                   "shards": {n: list(p.shape)
                              for n, p in tr.params.named_parameters()}}

# a one-process checkpoint restored on (data 2, model 2)
back = trainer(mesh=mesh, ckpt_dir=os.environ["MP_CKPT"])
assert back.maybe_resume()
info["restored_step"] = back.step
for kind, named in (("p", dict(back.params.named_parameters())),
                    ("mu", back.opt["mu"]), ("nu", back.opt["nu"])):
    for k, v in gather_params(named, back._specs, mesh).items():
        out[f"restored/{kind}/{k}"] = v.detach().numpy()

np.savez(os.path.join(OUT, f"rank{pid}.npz"), **out)
json.dump(info, open(os.path.join(OUT, f"info{pid}.json"), "w"))
print("MODEL_OK")
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
    case = CASES[name]
    (arch, kw), _, L, sparse = case
    kw = dict(kw)
    tc = case_cfg(case)
    jc = jget(arch).reduced()
    if arch in ("qwen2-7b", "internvl2-2b"):
        kw.setdefault("num_kv_heads", 2)
    if "num_experts" in kw:
        kw["moe"] = dataclasses.replace(jc.moe,
                                        num_experts=kw.pop("num_experts"))
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=32, kernel="jnp" if sparse else "fused"), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc.replace(
        spion=dataclasses.replace(tc.spion, kernel=jc.spion.kernel)))
    jp = jbuild(jc).init(jax.random.key(0))
    b = {k: jnp.asarray(v) for k, v in case_batch(case).items()}
    spion = None
    if sparse:
        spion = spion_dryrun_tables(jc, L)
        for k in ("col_idx", "nvalid"):
            np.testing.assert_array_equal(np.asarray(spion[k]),
                                          case_tables(case)[k].numpy())
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
    case; the one-process checkpoint's state; and the run directory."""
    d = tmp_path_factory.mktemp("model_job")
    jax_runs = {}
    (d / "jax").mkdir()
    for name in JAX_CASES:
        jparams, jloss, jgrads = jax_case(name)
        np.savez(d / "jax" / f"{name}.npz", **jparams)
        jax_runs[name] = (jloss, jgrads)
    # a one-process checkpoint (step 4, dense phase) for the ranks to restore
    one = trainer(ckpt_dir=str(d / "one"))
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
    assert all("MODEL_OK" in o for o in outs)
    return {"dir": d, "jax": jax_runs, "one_ckpt": state,
            "ranks": [dict(np.load(d / f"rank{i}.npz")) for i in range(4)],
            "info": [json.load(open(d / f"info{i}.json")) for i in range(4)]}


_ONE = {}


def one_process(name):
    """(loss, {leaf: gradient}) of case `name`'s step in one process on the
    global batch (cached)."""
    if name not in _ONE:
        from repro_torch.launch.steps import make_loss_and_grads
        case = CASES[name]
        cfg = case_cfg(case)
        batch = {k: torch.as_tensor(v) for k, v in case_batch(case).items()}
        loss, grads = make_loss_and_grads(cfg)(masters(cfg), batch,
                                               case_tables(case))
        _ONE[name] = (float(loss.detach()),
                      {k: g.numpy() for k, g in grads.items()})
    return _ONE[name]


def grad_gap(rec, key, want):
    """The worst leaf's max |difference| over its largest |element|."""
    return max(float(np.abs(rec[f"{key}/g/{k}"] - g).max()
                     / max(np.abs(g).max(), 1e-30)) for k, g in want.items())


@pytest.mark.parametrize("name", list(CASES))
def test_model_steps_match_one_process(mp_job, name):
    """On (data 2, model 2) each case's loss is within 3e-5 of one
    process's and its gradients, gathered over the model line, within 1e-4
    of each leaf's largest; every rank holds the same gathered gradients,
    and the replicated leaves' gradients agree bitwise across the model
    line (copy_to_model's backward, checked rather than assumed)."""
    loss, grads = one_process(name)
    ranks = mp_job["ranks"]
    for r, rec in enumerate(ranks):
        assert abs(float(rec[f"{name}/loss"]) - loss) <= LOSS_TOL, \
            (name, r, float(rec[f"{name}/loss"]), loss)
        assert grad_gap(rec, name, grads) <= GRAD_TOL, (name, r)
        for k in grads:
            np.testing.assert_array_equal(rec[f"{name}/g/{k}"],
                                          ranks[0][f"{name}/g/{k}"])
    local = [k for k in ranks[0] if k.startswith(f"{name}/local/")]
    assert local      # the norms at least are replicated
    for a, b in ((0, 1), (2, 3)):   # the model lines
        assert mp_job["info"][a]["coords"]["data"] == \
            mp_job["info"][b]["coords"]["data"]
        for k in local:
            np.testing.assert_array_equal(ranks[a][k], ranks[b][k], err_msg=k)


def test_model_ranks_share_the_batch(mp_job):
    """host_shard splits the batch over the data axes only: the ranks of a
    model line hold the same rows, the data lines different ones."""
    h = [i["lra_dense/batch"] for i in mp_job["info"]]
    assert h[0] == h[1] and h[2] == h[3] and h[0] != h[2]


def test_layout_of_each_family(mp_job):
    """The shards the Trainer keeps are the rules': spion-lra's heads, d_ff
    and vocabulary (512 / 2) split; mixtral's experts and internvl2's
    replicated vocabulary are held by the step cases' gates."""
    shapes = mp_job["info"][0]["trainer"]["shards"]
    assert shapes["layers.attn.wq"] == [2, 64, 32]
    assert shapes["layers.attn.wo"] == [2, 32, 64]
    assert shapes["layers.mlp.w_in"] == [2, 64, 64]
    assert shapes["tok_embed.w"] == [64, 64]
    assert shapes["pos_embed.w"][0] == 65_536
    assert shapes["layers.attn_norm.scale"] == [2, 64]


@pytest.mark.parametrize("name", JAX_CASES)
def test_step_matches_the_jax_package(mp_job, name):
    """The case's step on (data 2, model 2), its shards loaded from the JAX
    package's parameters through params_from_numpy(mesh=), against the JAX
    package's one-device loss and jax.grad: loss within 3e-5, gathered
    gradients within 1e-4 of each leaf's largest. The cases: reduced
    qwen2-7b dense and sparse, mixtral's experts over 'model' and its d_ff
    split within each expert, internvl2-2b's replicated vocabulary."""
    jloss, jgrads = mp_job["jax"][name]
    assert sorted(jgrads) == sorted(one_process(name)[1])
    for rec in mp_job["ranks"]:
        assert abs(float(rec[f"jax_{name}/loss"]) - jloss) <= LOSS_TOL
        assert grad_gap(rec, f"jax_{name}", jgrads) <= GRAD_TOL


def test_clipped_step_global_norm(mp_job):
    """A train step whose gradients are clipped (global norm > 1): the norm
    over the shards equals one process's (the sharded leaves' squares
    summed over the model line, the replicated ones counted once); a norm
    of the rank's shards alone misses it."""
    from repro_torch.optim import global_norm
    _, grads = one_process(CLIP_CASE)
    want = float(global_norm({k: torch.as_tensor(g)
                              for k, g in grads.items()}))
    assert want > 1.0
    for rec in mp_job["ranks"]:
        got = float(rec["clip_sound/gnorm"])
        assert abs(got - want) <= 1e-6 * want, (got, want)
        bad = float(rec["clip_planted/gnorm"])
        assert abs(bad - want) > 1e-2 * want, (bad, want)


def test_capture_and_plan_match_one_process(mp_job):
    """The capture on (data 2, model 2), each rank holding half the heads
    and half the batch: pooled map and Frobenius term within 1e-6 of one
    process on every rank, and the plan from the ranks' map bitwise the
    plan from one process's. Averaging the rank's own heads only misses
    the gate."""
    from repro_torch.core.spion import SpionController, SpionState
    from repro_torch.launch.steps import compute_params
    from repro_torch.models.registry import build
    cfg = lra_cfg()
    ctl = SpionController(cfg.spion, causal=cfg.causal, seq_len=128)
    batch = {k: torch.as_tensor(v) for k, v in lra_batch().items()}
    with torch.no_grad():
        pooled, frob = build(cfg).forward(
            compute_params(masters(cfg), torch.float32), batch,
            capture=ctl.capture_kwargs(SpionState()))[1]["captured"]
    for rec in mp_job["ranks"]:
        np.testing.assert_allclose(rec["capture/pooled"], pooled.numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(rec["capture/frob"], frob.numpy(),
                                   atol=0, rtol=1e-6)
        assert np.abs(rec["planted_local_heads/pooled"]
                      - pooled.numpy()).max() > 1e-6
    want = ctl.generate(SpionState(), pooled.numpy()).table_arrays()
    got = ctl.generate(SpionState(),
                       mp_job["ranks"][0]["capture/pooled"]).table_arrays()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("fault", list(FAULT_CASES))
def test_planted_step_faults_miss_a_gate(mp_job, fault):
    """Each planted fault of a step moves the loss past 3e-5 or a gathered
    gradient past 1e-4 of its leaf's largest: the gradients summed over the
    whole mesh (not the data line), attn_out without its model-line sum,
    the vocab-parallel loss without the line's max and sums, the MoE's
    partial combine without its sum."""
    loss, grads = one_process(FAULT_CASES[fault])
    rec = mp_job["ranks"][0]
    key = f"planted_{fault}"
    assert abs(float(rec[f"{key}/loss"]) - loss) > LOSS_TOL or \
        grad_gap(rec, key, grads) > 10 * GRAD_TOL, fault


def test_trainer_one_plan_and_checkpoints(mp_job):
    """The three-phase Trainer on (data 2, model 2): one plan on every rank,
    the one-process Trainer's; dense losses within 3e-5 of it. Its
    checkpoint (written by process 0 with every sharded leaf gathered)
    restores in one process onto the gathered masters, plan and all; and a
    one-process checkpoint restores on the mesh onto each rank's slices,
    moments included, bitwise."""
    from repro_torch.core.spion import plan_digest
    runs = [i["trainer"] for i in mp_job["info"]]
    assert all(r["phase"] == "sparse" for r in runs)
    assert len({r["digest"] for r in runs}) == 1
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    one = trainer()
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
    # the mesh's checkpoint in one process
    back = trainer(ckpt_dir=str(mp_job["dir"] / "ckpt"))
    assert back.maybe_resume() and back.step == 8
    assert plan_digest(back.spion_state.table_arrays(),
                       back.spion_state.tables["block"]) == runs[0]["digest"]
    rec = mp_job["ranks"][0]
    for n, p in back.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      rec[f"trainer/p/{n}"], err_msg=n)
    # the one-process checkpoint on the mesh
    state = mp_job["one_ckpt"]
    for r, rec in enumerate(mp_job["ranks"]):
        assert mp_job["info"][r]["restored_step"] == 4
        for kind, named in state.items():
            for n, v in named.items():
                np.testing.assert_array_equal(rec[f"restored/{kind}/{n}"], v,
                                              err_msg=f"{kind} {n}")


# ---------------------------------------------------------------------------
# the parameter rules against the reference's
# ---------------------------------------------------------------------------

MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "model4": ((4,), ("model",)),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
          "data1_model16": ((1, 16), ("data", "model")),
          "seq2_data2_model2": ((2, 2, 2), ("seq", "data", "model"))}
_META = {}


def meta_tree(arch):
    """{dotted name: meta tensor} of `arch`'s full-size parameters."""
    if arch not in _META:
        from repro_torch.configs import get_config
        from repro_torch.models.registry import build
        tree = build(get_config(arch)).init(torch.Generator().manual_seed(0),
                                            device="meta")
        _META[arch] = dict(tree.named_parameters())
    return _META[arch]


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return ARCH_IDS


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", _arch_ids())
def test_param_specs_match_reference(arch, mesh_name):
    """spec_for_path, spec_candidates, sanitize_spec, best_spec,
    param_pspecs (with and without a mesh) and zero1_pspecs of the port
    equal the JAX package's, as tuples, on every leaf of `arch` at full
    size."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.distributed import sharding as ref
    from repro_torch.distributed import sharding as port
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import nest
    shape, axes = MESHES[mesh_name]
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    leaves = meta_tree(arch)
    for name, leaf in leaves.items():
        path = name.replace(".", "/")
        assert port.spec_for_path(path, leaf.ndim) == \
            tuple(ref.spec_for_path(path, leaf.ndim)), path
        cands = port.spec_candidates(path, leaf.ndim)
        assert cands == [tuple(c) for c in
                         ref.spec_candidates(path, leaf.ndim)], path
        for c in cands:
            assert port.sanitize_spec(mesh, c, leaf.shape) == \
                tuple(ref.sanitize_spec(mesh, P(*c), leaf.shape)), path
        assert port.best_spec(mesh, path, leaf) == \
            tuple(ref.best_spec(mesh, path, leaf)), path

    def flat(tree):
        got = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]
        return {".".join(k.key for k in p): tuple(s) for p, s in got}
    nested = nest(leaves)
    for mine, theirs in ((port.param_pspecs(leaves, mesh),
                          ref.param_pspecs(nested, mesh)),
                         (port.param_pspecs(leaves),
                          ref.param_pspecs(nested)),
                         (port.zero1_pspecs(leaves, mesh),
                          ref.zero1_pspecs(nested, mesh))):
        assert mine == flat(theirs)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

REFUSALS = {
    # the reference's fallbacks (test_torch_seq_model and
    # test_torch_model_scan step them): KV heads |model| does not divide,
    # 'seq' with 'model', whisper's 6 heads on 4, zamba2's B and C columns
    # (2N = 10 on 4 ranks) and rwkv6's heads (6 on 4)
    "kv_heads": ("qwen2-7b", {"num_kv_heads": 2},
                 ((1, 4), ("data", "model"))),
    "seq_with_model": ("spion-lra", {},
                       ((2, 1, 2), ("seq", "data", "model"))),
    "hybrid": ("zamba2-1.2b", {"ssm_state": 5},
               ((1, 4), ("data", "model"))),
    "ssm": ("rwkv6-7b", {"num_heads": 6, "num_kv_heads": 6},
            ((1, 4), ("data", "model"))),
    "encdec": ("whisper-tiny", {"num_heads": 6, "num_kv_heads": 6},
               ((1, 4), ("data", "model"))),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_name_the_item(what):
    """What once raised on a 'model' axis builds: the step, the conversion
    of parameters (each leaf the rank's shard) and the Trainer's checks
    (the Trainer stops at its first collective, the masters' broadcast, on
    a mesh without process groups). KV heads and whisper's heads |model|
    does not divide and 'seq' with 'model' take the reference's fallbacks
    (test_torch_seq_model steps them on 4 ranks); so do an SSM width
    |model| does not divide (zamba2's 2N of 10, rwkv6's 6 heads on 4:
    test_torch_model_scan steps them), whose packed in_proj is then the
    reference's contiguous shard (zamba2's 274 columns do not divide 4, so
    it is whole; rwkv6's w_r holds 24 of 96 columns, mid-head).
    make_seq_mesh builds 'seq' with 'model'."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import scan_split
    from repro_torch.launch.mesh import Mesh, make_seq_mesh
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import Trainer, nest
    from repro_torch.models.registry import build
    arch, kw, (shape, axes) = REFUSALS[what]
    sound = get_config(arch).reduced()
    sound = sound.replace(spion=dataclasses.replace(sound.spion,
                                                    block_size=16))
    kw = dict(kw)
    if "ssm_state" in kw:
        kw["ssm"] = dataclasses.replace(sound.ssm,
                                        state_size=kw.pop("ssm_state"))
        assert isinstance(kw["ssm"], SSMConfig)
    cfg = sound.replace(**kw)
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    assert callable(make_loss_and_grads(cfg, mesh=mesh))
    with pytest.raises(RuntimeError, match="no process groups"):
        Trainer(cfg, seq_len=64, batch=2, mesh=mesh, device="cpu")
    full = build(cfg).init(torch.Generator().manual_seed(0),
                           device="cpu")
    tree = {n: p.float().numpy() for n, p in full.named_parameters()}
    local = params_from_numpy(nest(tree), cfg, "cpu", mesh=mesh)
    assert len(list(local.parameters())) == len(tree)
    if what == "seq_with_model":
        assert make_seq_mesh(2, 1, model=2).shape == {
            "seq": 2, "data": 1, "model": 2}
    if what == "hybrid":
        assert not scan_split(cfg, mesh) and scan_split(sound, mesh)
        np.testing.assert_array_equal(
            local["layers"]["mamba"]["in_proj"].numpy(),
            tree["layers.mamba.in_proj"])
        assert list(local["layers"]["mamba"]["out_proj"].shape) == \
            [2, 32, 64]
    if what == "ssm":
        assert not scan_split(cfg, mesh) and scan_split(sound, mesh)
        np.testing.assert_array_equal(
            local["layers"]["tm"]["w_r"].numpy(),
            tree["layers.tm.w_r"][..., :24])
    assert callable(make_loss_and_grads(sound, mesh=mesh))