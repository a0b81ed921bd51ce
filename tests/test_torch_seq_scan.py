"""Port parity, the hybrid, ssm and encdec families over a 'seq' axis: real
`torch.distributed` CPU processes (gloo) run the port's scans, steps,
capture and Trainer on shards of the sequence, and each is held against
the JAX reference's function on the whole sequence, or against the same
work in one process on the global batch (which the per-family parity
files hold to the reference; the reference's own mesh train step does not
run here: ROADMAP.md §C notes).

One 4-rank job (a 'seq' mesh of 4, so that a shard's incoming state
composes the summaries of more than one earlier shard):
  - `mamba.ssd_chunked` and `rwkv.wkv6_chunked` with the cross-shard state
    carry, forward within 3e-5 and input gradients within 1e-3 of the
    reference's whole-sequence function (and its jax.vjp);
  - `mamba._causal_conv` and `rwkv.token_shift` with the left halo rows
    (`distributed.sharding.seq_left_rows`), the same way;
  - planted carry faults that the forward gate must see: every shard's
    scan from zero, and each shard's state from the previous shard alone
    (which a line of 2 cannot tell from the right composition).
One 2-rank job (a 'seq' mesh of 2):
  - make_loss_and_grads for reduced zamba2-1.2b dense and sparse (a plan
    banded to halo (1, 0): the halo exchange), whisper-tiny dense and
    sparse, rwkv6-7b dense: loss within 3e-5, gradients within 1e-3, the
    ranks' gradients bitwise equal. zamba2's sparse step is ROADMAP §C's
    C2 reproduction (the forward that ignored the mesh read 4.865709
    against 4.869279);
  - planted faults that the gates must see: a carry that drops the
    incoming state, a halo of zeros, a cross-attention that reads only the
    local encoder shard, and the three together with positions from 0
    (C2's forward);
  - the capture on shards, zamba2 (a layer without and one with the
    shared block) and whisper's decoder, against one process;
  - a zamba2 'seq' Trainer through the transition: one plan on both
    ranks, the JAX controller's plan from the maps the ranks captured;
    rwkv6's and whisper's (frames through `data_fn=`) dense Trainers
    against one process.
In this process: the hybrid pairing of per-layer captures with
per-application tables against the reference's (ROADMAP §A), and the
remat recompute of every family on another thread under the forward's
mesh.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from conftest import run_distributed_case

S, BLOCK = 64, 16
FWD_TOL, GRAD_TOL, LOSS_TOL = 3e-5, 1e-3, 3e-5
MP_ENV = {"OMP_NUM_THREADS": "1"}

# shared by the workers and the test process: inputs, configs, batches
SRC = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config

SCAN = dict(b=2, S=64, H=3, P=4, N=5, chunk=8)


def scan_inputs():
    sh = SCAN
    b, S_, H, P, N = sh["b"], sh["S"], sh["H"], sh["P"], sh["N"]
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ssd = {"x": f(b, S_, H, P), "dt": np.abs(f(b, S_, H)) * 0.5,
           "A": -np.abs(f(H)), "B": f(b, S_, 1, N), "C": f(b, S_, 1, N),
           "D": f(H)}
    wkv = {"r": f(b, S_, H, P), "k": f(b, S_, H, P), "v": f(b, S_, H, P),
           "a": -np.exp(f(b, S_, H, P) - 3).clip(1e-3, 4.0), "u": f(H, P)}
    conv = {"x": f(b, S_, 6), "w": f(4, 6), "b": f(6)}
    cot = {"ssd": f(b, S_, H, P), "wkv": f(b, S_, H, P), "conv": f(b, S_, 6),
           "shift": f(b, S_, 6)}
    return ssd, wkv, conv, cot


SHARDED = {"x", "dt", "B", "C", "r", "k", "v", "a"}


def fam_cfg(arch, **kw):
    c = get_config(arch).reduced()
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=16, kernel="fused"), **kw)


# case: (arch, sparse)
CASES = {
    "zamba2_dense": ("zamba2-1.2b", False),
    "zamba2_sparse": ("zamba2-1.2b", True),
    "whisper_dense": ("whisper-tiny", False),
    "whisper_sparse": ("whisper-tiny", True),
    "rwkv6_dense": ("rwkv6-7b", False),
}


def case_batch(arch):
    cfg = fam_cfg(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 65)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((2, 64, cfg.d_model)).astype(
            np.float32)
    return b


def case_tables(arch, sparse):
    from repro_torch.launch.steps import spion_dryrun_tables
    return spion_dryrun_tables(fam_cfg(arch), 64, max_extent=1) \\
        if sparse else None


def masters(cfg):
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    return masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu"))


def capture_kwargs(cfg):
    from repro_torch.core.spion import SpionController, SpionState
    return SpionController(cfg.spion, causal=cfg.causal,
                           seq_len=64).capture_kwargs(SpionState())


def trainer_cfg():
    c = fam_cfg("zamba2-1.2b")
    return c.replace(spion=dataclasses.replace(
        c.spion, min_dense_epochs=1, max_dense_epochs=3))


def trainer_data(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(2, 65)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def frames_data(step):     # whisper's: trainer_data and 64 frames a row
    b = trainer_data(step)
    rng = np.random.default_rng([4, step])
    b["frames"] = rng.standard_normal((2, 64, 64)).astype(np.float32)
    return b


# the dense 'seq' Trainers: (arch, data_fn)
DENSE_TRAINERS = {"rwkv6-7b": "trainer_data", "whisper-tiny": "frames_data"}


def dense_trainer(arch, **kw):
    from repro_torch.launch.train import Trainer
    return Trainer(fam_cfg(arch), seq_len=64, batch=2, lr=0.05,
                   total_steps=100, steps_per_epoch=2,
                   data_fn=globals()[DENSE_TRAINERS[arch]], device="cpu",
                   sentinel=False, **kw)
"""
exec(SRC)

HEAD = """
import json, os
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import mesh_context, seq_left_rows
from repro_torch.launch.mesh import make_seq_mesh
from repro_torch.models import encdec as E
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
mesh = make_seq_mesh(nproc, 1)
out = {}
"""

# 4 ranks: the scans' carry and the halos, forward and input gradients
SCAN_WORKER = """
ssd, wkv, conv, cot = scan_inputs()
L = SCAN["S"] // nproc
sl = slice(pid * L, (pid + 1) * L)


def shard(name, a):
    t = torch.tensor(a[:, sl] if name in SHARDED else a)
    return t.requires_grad_(True)


def run(tag, fn, inputs, cot_):
    ts = {k: shard(k, v) for k, v in inputs.items()}
    with mesh_context(mesh):
        y = fn(ts)
        gs = torch.autograd.grad((y * torch.tensor(cot_[:, sl])).sum(),
                                 list(ts.values()))
    out[f"{tag}/y"] = y.detach().numpy()
    out.update({f"{tag}/d{k}": g.numpy() for k, g in zip(ts, gs)})


ch = SCAN["chunk"]
ssd_fn = lambda t: M.ssd_chunked(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                 t["D"], ch)
wkv_fn = lambda t: R.wkv6_chunked(t["r"], t["k"], t["v"], t["a"], t["u"], ch)
run("ssd", ssd_fn, ssd, cot["ssd"])
run("wkv", wkv_fn, wkv, cot["wkv"])
run("conv", lambda t: M._causal_conv(t["x"], t["w"], t["b"],
                                     seq_left_rows(t["x"], 3))[0],
    conv, cot["conv"])
run("shift", lambda t: R.token_shift(t["x"], seq_left_rows(t["x"], 1)),
    {"x": conv["x"]}, cot["shift"])
# the planted faults: every shard's scan starts from zero (C2); each
# shard starts from the previous shard's final state alone (right on 2
# shards, where no earlier summaries compose)


def last_only(decay, final):
    lines = sharding.gather_seq(final[None], 0)
    first = torch.tensor(pid == 0)
    return torch.where(first, 0.0, lines[max(pid - 1, 0)])


inner = sharding.seq_carry
for tag, fault in (("dropped", lambda decay, final: torch.zeros_like(final)),
                   ("last_only", last_only)):
    sharding.seq_carry = fault
    run(f"ssd_{tag}", ssd_fn, ssd, cot["ssd"])
    run(f"wkv_{tag}", wkv_fn, wkv, cot["wkv"])
sharding.seq_carry = inner
np.savez(os.path.join(OUT, f"scan{pid}.npz"), **out)
print("SCAN_OK")
runtime.shutdown(0)
"""

# 2 ranks: steps, planted faults, captures, the Trainer
STEP_WORKER = """
import contextlib
from repro_torch.data.pipeline import local_batch
from repro_torch.launch.steps import compute_params, make_loss_and_grads
from repro_torch.models.registry import build
info = {}


@contextlib.contextmanager
def planted(kind):
    saved = []

    def put(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    if kind == "carry":          # each shard's scan from zero
        put(sharding, "seq_carry", lambda decay, final: torch.zeros_like(final))
    elif kind == "halo":         # zeros for the conv's and shift's rows
        for mod in (M, R):
            put(mod, "seq_left_rows", lambda x, rows: x.new_zeros(
                (x.shape[0], rows, *x.shape[2:])))
    elif kind == "cross":        # the local encoder shard only
        put(E, "gather_seq", lambda x, dim: x)
    elif kind == "c2":           # C2's forward: no carry, no halo, and
        put(sharding, "seq_carry",   # positions from 0 on every shard
            lambda decay, final: torch.zeros_like(final))
        for mod in (M, R):
            put(mod, "seq_left_rows", lambda x, rows: x.new_zeros(
                (x.shape[0], rows, *x.shape[2:])))
        from repro_torch.models import hybrid
        put(hybrid, "seq_positions", lambda rows, device: (
            0, *[torch.arange(rows, device=device)] * 2))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def step(arch, sparse, fault=None):
    cfg = fam_cfg(arch)
    tables = case_tables(arch, sparse)
    f = make_loss_and_grads(cfg, mesh=mesh,
                            halo=None if tables is None else tables["halo"])
    batch = local_batch(mesh, case_batch(arch), "cpu")
    with planted(fault):
        return f(masters(cfg), batch, tables)


for name, (arch, sparse) in CASES.items():
    loss, grads = step(arch, sparse)
    out[f"{name}/loss"] = loss.numpy()
    out.update({f"{name}/{k}": g.numpy() for k, g in grads.items()})
for name, fault in (("zamba2_sparse", "c2"),
                    ("zamba2_sparse", "carry"), ("rwkv6_dense", "carry"),
                    ("zamba2_dense", "halo"), ("rwkv6_dense", "halo"),
                    ("whisper_dense", "cross")):
    loss, grads = step(*CASES[name], fault=fault)
    out[f"{fault}:{name}/loss"] = loss.numpy()
    out.update({f"{fault}:{name}/{k}": g.numpy() for k, g in grads.items()})

# the capture on the shards
for arch in ("zamba2-1.2b", "whisper-tiny"):
    cfg = fam_cfg(arch)
    params = compute_params(masters(cfg), torch.float32)
    with torch.no_grad(), mesh_context(mesh):
        aux = build(cfg).forward(params, local_batch(mesh, case_batch(arch),
                                                     "cpu"),
                                 capture=capture_kwargs(cfg))[1]
    pooled, frob = aux["captured"]
    out[f"capture:{arch}/pooled"] = pooled.numpy()
    out[f"capture:{arch}/frob"] = frob.numpy()
np.savez(os.path.join(OUT, f"steps{pid}.npz"), **out)

# zamba2's three-phase Trainer on the 'seq' mesh; its sparse phase takes
# the gather path, since a trained plan may be too wide for the halo
# exchange and this mesh has no data axis for the kernels' fallback
from repro_torch.core.spion import plan_digest
from repro_torch.launch.train import Trainer
tr = Trainer(trainer_cfg(), seq_len=64, batch=2, lr=0.05, total_steps=100,
             steps_per_epoch=2, data_fn=trainer_data, device="cpu",
             sentinel=False, mesh=mesh, sparse_kernel="jnp")
pooled = []
inner_obs = tr.spion_ctl.observe_epoch
def observe(state, p, f):
    pooled.append(np.array(p))
    return inner_obs(state, p, f)
tr.spion_ctl.observe_epoch = observe
phases = []
tr.step_callback = lambda s, l: phases.append(tr.spion_state.phase)
losses = tr.train(8, log_every=100, log=lambda *a: None)
st = tr.spion_state
np.savez(os.path.join(OUT, f"pooled{pid}.npz"),
         **{f"p{i}": p for i, p in enumerate(pooled)})
dense = {}
for arch in DENSE_TRAINERS:
    t = dense_trainer(arch, mesh=mesh)
    dense[arch] = {"losses": t.train(4, log_every=100, log=lambda *a: None),
                   "phase": t.spion_state.phase}
json.dump({"losses": losses, "phases": phases, "phase": st.phase,
           "digest": plan_digest(st.table_arrays(), st.tables["block"]),
           "tables": {k: v.tolist() for k, v in st.table_arrays().items()},
           "stats": st.plan_stats, "dense": dense},
          open(os.path.join(OUT, f"trainer{pid}.json"), "w"))
print("STEP_OK")
runtime.shutdown(0)
"""


@pytest.fixture(scope="module")
def scan_job(tmp_path_factory):
    """The 4-rank job's per-rank records of the scans and halos."""
    d = tmp_path_factory.mktemp("scan_job")
    outs = run_distributed_case(SRC + HEAD + SCAN_WORKER, nproc=4,
                                timeout=300,
                                env_extra=dict(MP_ENV, MP_OUT=str(d)))
    assert all("SCAN_OK" in o for o in outs)
    return [dict(np.load(d / f"scan{i}.npz")) for i in range(4)]


@pytest.fixture(scope="module")
def step_job(tmp_path_factory):
    """The 2-rank job's records: per rank the steps' and captures' npz,
    the pooled maps and the trainer's json."""
    d = tmp_path_factory.mktemp("step_job")
    outs = run_distributed_case(SRC + HEAD + STEP_WORKER, nproc=2,
                                timeout=400,
                                env_extra=dict(MP_ENV, MP_OUT=str(d)))
    assert all("STEP_OK" in o for o in outs)
    return {"steps": [dict(np.load(d / f"steps{i}.npz")) for i in range(2)],
            "pooled": [dict(np.load(d / f"pooled{i}.npz")) for i in range(2)],
            "trainer": [json.load(open(d / f"trainer{i}.json"))
                        for i in range(2)]}


# -- the scans and halos on 4 ranks against the reference ---------------------

def _reference(tag):
    """(the reference's whole-sequence output, {input: gradient}) of `tag`
    through jax.vjp with the workers' cotangent."""
    import jax
    import jax.numpy as jnp
    from repro.models import mamba as jm
    from repro.models import rwkv as jr
    ssd, wkv, conv, cot = scan_inputs()
    ch = SCAN["chunk"]
    fns = {
        "ssd": (lambda t: jm.ssd_chunked(t["x"], t["dt"], t["A"], t["B"],
                                         t["C"], t["D"], ch), ssd),
        "wkv": (lambda t: jr.wkv6_chunked(t["r"], t["k"], t["v"], t["a"],
                                          t["u"], ch), wkv),
        "conv": (lambda t: jm._causal_conv(t["x"], t["w"], t["b"])[0], conv),
        "shift": (lambda t: jr.token_shift(t["x"]), {"x": conv["x"]}),
    }
    fn, inputs = fns[tag]
    y, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in inputs.items()})
    (g,) = vjp(jnp.asarray(cot[tag]))
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


def _gathered(ranks, key, sharded):
    """A sharded record concatenated along the sequence, a replicated
    one's per-rank gradient shares summed."""
    parts = [r[key] for r in ranks]
    return np.concatenate(parts, axis=1) if sharded else np.sum(parts, 0)


@pytest.mark.parametrize("tag", ["ssd", "wkv"])
def test_scan_carry_on_four_shards_matches_the_reference(scan_job, tag):
    """`ssd_chunked` / `wkv6_chunked` on 4 'seq' shards of 2 chunks each,
    each shard's state composed from the summaries of every earlier shard
    (`seq_carry`): the shards concatenated within 3e-5 of the reference's
    function on the whole sequence, every input's gradient (the shards'
    concatenated, the replicated A, D, u summed) within 1e-3 of its
    jax.vjp."""
    want, grads = _reference(tag)
    np.testing.assert_allclose(_gathered(scan_job, f"{tag}/y", True), want,
                               atol=FWD_TOL, rtol=0)
    for k, g in grads.items():
        np.testing.assert_allclose(
            _gathered(scan_job, f"{tag}/d{k}", k in SHARDED), g,
            atol=GRAD_TOL, rtol=0, err_msg=f"{tag} d{k}")


@pytest.mark.parametrize("tag", ["conv", "shift"])
def test_halo_rows_on_four_shards_match_the_reference(scan_job, tag):
    """Mamba2's causal conv (3 rows of the previous shard) and RWKV6's
    token shift (1 row), each with `seq_left_rows` as its left state: the
    shards concatenated within 3e-5 of the reference's whole-sequence
    function, the gradients of x (the halo's backward sums them onto the
    shard that owns the rows), w and b within 1e-3."""
    want, grads = _reference(tag)
    np.testing.assert_allclose(_gathered(scan_job, f"{tag}/y", True), want,
                               atol=FWD_TOL, rtol=0)
    for k, g in grads.items():
        np.testing.assert_allclose(
            _gathered(scan_job, f"{tag}/d{k}", k == "x"), g, atol=GRAD_TOL,
            rtol=0, err_msg=f"{tag} d{k}")


@pytest.mark.parametrize("tag", ["ssd", "wkv"])
def test_dropped_carry_misses_the_scan_gate(scan_job, tag):
    """With the planted carry fault (every shard's scan from zero, as the
    forward of ROADMAP §C's C2 ran it) the first shard still matches the
    reference and the later shards miss it by far more than the gate."""
    want, _ = _reference(tag)
    got = _gathered(scan_job, f"{tag}_dropped/y", True)
    L = SCAN["S"] // 4
    np.testing.assert_allclose(got[:, :L], want[:, :L], atol=FWD_TOL, rtol=0)
    assert np.abs(got - want).max() > 100 * FWD_TOL


@pytest.mark.parametrize("tag", ["ssd", "wkv"])
def test_carry_from_the_previous_shard_alone_misses_on_four_shards(scan_job,
                                                                    tag):
    """A carry that hands each shard only the previous shard's final state
    is right on the first two shards, all that a 'seq' line of 2 holds,
    and misses the reference on the later ones, where the summaries of
    more than one earlier shard must compose."""
    want, _ = _reference(tag)
    got = _gathered(scan_job, f"{tag}_last_only/y", True)
    L = SCAN["S"] // 4
    np.testing.assert_allclose(got[:, :2 * L], want[:, :2 * L], atol=FWD_TOL,
                               rtol=0)
    assert np.abs(got[:, 2 * L:] - want[:, 2 * L:]).max() > 100 * FWD_TOL


@pytest.mark.parametrize("mod", ["mamba", "rwkv"])
def test_scan_off_a_mesh_is_the_per_token_recurrence(mod):
    """Off a mesh the chunks' state combine (`carried_combine`) runs from
    zeros alone: `ssd_chunked` / `wkv6_chunked` on the whole sequence
    within 3e-5 of the plain per-token recurrence (the decode form's
    arithmetic)."""
    from repro_torch.models import mamba as M
    from repro_torch.models import rwkv as R
    ssd, wkv, _, _ = scan_inputs()
    ch, ys = SCAN["chunk"], []
    if mod == "mamba":
        x, dt, A, B, C, D = (torch.tensor(ssd[k])
                             for k in ("x", "dt", "A", "B", "C", "D"))
        got = M.ssd_chunked(x, dt, A, B, C, D, ch)
        b, S, H, P = x.shape
        st = torch.zeros((b, H, B.shape[-1], P))
        for i in range(S):
            st = st * torch.exp(dt[:, i] * A)[..., None, None] + torch.einsum(
                "bn,bhp,bh->bhnp", B[:, i, 0], x[:, i], dt[:, i])
            ys.append(torch.einsum("bn,bhnp->bhp", C[:, i, 0], st)
                      + D[:, None] * x[:, i])
    else:
        r, k, v, a, u = (torch.tensor(wkv[n]) for n in "rkvau")
        got = R.wkv6_chunked(r, k, v, a, u, ch)
        b, S, H, K = k.shape
        st = torch.zeros((b, H, K, v.shape[-1]))
        for i in range(S):
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], st)
                      + torch.einsum("bhk,hk,bhk,bhv->bhv", r[:, i], u,
                                     k[:, i], v[:, i]))
            st = st * torch.exp(a[:, i])[..., None] + torch.einsum(
                "bhk,bhv->bhkv", k[:, i], v[:, i])
    torch.testing.assert_close(got, torch.stack(ys, dim=1), atol=FWD_TOL,
                               rtol=0)


# -- steps, faults, captures and the Trainer on 2 ranks -----------------------

def one_process(name):
    """(loss, {leaf: gradient}) of the case's step in one process on the
    global batch."""
    from repro_torch.launch.steps import make_loss_and_grads
    arch, sparse = CASES[name]
    cfg = fam_cfg(arch)
    batch = {k: torch.as_tensor(v) for k, v in case_batch(arch).items()}
    loss, grads = make_loss_and_grads(cfg)(masters(cfg), batch,
                                           case_tables(arch, sparse))
    return float(loss.detach()), {k: g.numpy() for k, g in grads.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_seq_steps_match_one_process(step_job, name):
    """A 2-rank 'seq' step equals the one-process step on the global batch:
    loss within 3e-5, every gradient within 1e-3, the ranks' gradients
    bitwise equal. zamba2_sparse is C2's reproduction: one process reads
    4.869279, where C2's forward on the shards read 4.865709."""
    loss, grads = one_process(name)
    if name == "zamba2_sparse":
        assert abs(loss - 4.869279) < 1e-5, loss
    ranks = step_job["steps"]
    for r in ranks:
        assert abs(float(r[f"{name}/loss"]) - loss) <= LOSS_TOL, \
            (name, float(r[f"{name}/loss"]), loss)
        for k, g in grads.items():
            np.testing.assert_allclose(r[f"{name}/{k}"], g, atol=GRAD_TOL,
                                       rtol=0, err_msg=f"{name} {k}")
            np.testing.assert_array_equal(r[f"{name}/{k}"],
                                          ranks[0][f"{name}/{k}"])


@pytest.mark.parametrize("fault,name", [
    ("c2", "zamba2_sparse"),
    ("carry", "zamba2_sparse"), ("carry", "rwkv6_dense"),
    ("halo", "zamba2_dense"), ("halo", "rwkv6_dense"),
    ("cross", "whisper_dense")])
def test_planted_faults_miss_the_step_gates(step_job, fault, name):
    """Each planted fault moves the step past the gates of
    test_seq_steps_match_one_process: the dropped carry, the zero halo
    rows, the cross-attention over the local encoder shard only, and all
    that C2's forward did (no carry, no halo, positions from 0 on each
    shard), which reads its 4.865709 again."""
    loss, grads = one_process(name)
    r = step_job["steps"][0]
    gap = abs(float(r[f"{fault}:{name}/loss"]) - loss)
    worst = max(np.abs(r[f"{fault}:{name}/{k}"] - g).max()
                for k, g in grads.items())
    assert gap > LOSS_TOL or worst > GRAD_TOL, (gap, worst)
    if fault == "c2":
        assert abs(float(r[f"{fault}:{name}/loss"]) - 4.865709) < 1e-5


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-tiny"])
def test_capture_on_seq_shards_matches_one_process(step_job, arch):
    """The capture on 2 'seq' shards: zamba2's zero map for its Mamba-only
    layer 0 at the whole sequence's block count and the shared block's map
    at layer 1, whisper's decoder layers; pooled maps within 1e-6 and the
    Frobenius terms within 1e-6 relative of one process, on both ranks."""
    from repro_torch.launch.steps import compute_params
    from repro_torch.models.registry import build
    cfg = fam_cfg(arch)
    batch = {k: torch.as_tensor(v) for k, v in case_batch(arch).items()}
    with torch.no_grad():
        pooled, frob = build(cfg).forward(
            compute_params(masters(cfg), torch.float32), batch,
            capture=capture_kwargs(cfg))[1]["captured"]
    if arch == "zamba2-1.2b":
        assert not pooled[0].any() and pooled[1].any()
    for r in step_job["steps"]:
        got = r[f"capture:{arch}/pooled"]
        assert got.shape == tuple(pooled.shape)
        np.testing.assert_allclose(got, pooled.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(r[f"capture:{arch}/frob"], frob.numpy(),
                                   atol=0, rtol=1e-6)


def test_zamba2_seq_trainer_one_plan(step_job):
    """A 2-rank zamba2 'seq' Trainer through the transition: both ranks in
    the sparse phase with one plan digest, the captured maps bitwise equal
    across the ranks, the plan (tables and stats) bitwise the JAX
    controller's on the ranks' last map, and the dense losses within 3e-5
    of the one-process Trainer's."""
    from repro.configs import get_config as jget
    from repro.core.spion import SpionController, SpionState
    from repro_torch.launch.train import Trainer
    runs = step_job["trainer"]
    assert all(r["phase"] == "sparse" for r in runs)
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[0]["losses"] == runs[1]["losses"]
    pooled = step_job["pooled"]
    assert pooled[0]
    for k in pooled[0]:
        np.testing.assert_array_equal(pooled[0][k], pooled[1][k])
    jc = jget("zamba2-1.2b").reduced()
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=BLOCK, min_dense_epochs=1, max_dense_epochs=3))
    last = pooled[0][f"p{len(pooled[0]) - 1}"]
    jst = SpionController(jc.spion, causal=jc.causal,
                          seq_len=S).generate(SpionState(), last)
    for k, v in runs[0]["tables"].items():
        np.testing.assert_array_equal(np.asarray(jst.tables[k]),
                                      np.asarray(v, np.int32), err_msg=k)
    assert runs[0]["stats"] == jst.plan_stats
    one = Trainer(trainer_cfg(), seq_len=S, batch=2, lr=0.05,
                  total_steps=100, steps_per_epoch=2, data_fn=trainer_data,
                  device="cpu", sentinel=False)
    phases = []
    one.step_callback = lambda s, l: phases.append(one.spion_state.phase)
    want = one.train(8, log_every=100, log=lambda *a: None)
    dense = [i for i, p in enumerate(runs[0]["phases"]) if p == "dense"]
    assert dense and dense == [i for i, p in enumerate(phases)
                               if p == "dense"]
    for i in dense:
        assert abs(runs[0]["losses"][i] - want[i]) <= LOSS_TOL, \
            (i, runs[0]["losses"][i], want[i])


@pytest.mark.parametrize("arch", list(DENSE_TRAINERS))
def test_dense_seq_trainer_matches_one_process(step_job, arch):
    """rwkv6 (no attention: dense only) and whisper (frames through
    `data_fn=`, each rank keeping its shard of the frames and of the
    tokens) train 4 steps on the 2-rank 'seq' mesh with the ranks' losses
    equal and within 3e-5 of the one-process Trainer's."""
    runs = [r["dense"][arch] for r in step_job["trainer"]]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert all(r["phase"] == "dense" for r in runs)
    want = dense_trainer(arch).train(4, log_every=100, log=lambda *a: None)
    np.testing.assert_allclose(runs[0]["losses"], want, atol=LOSS_TOL,
                               rtol=0)


def test_trainer_refuses_shards_of_partial_chunks():
    """A 'seq' shard must hold whole chunks of the whole sequence's scan,
    so that its chunk boundaries are the reference's: the Trainer refuses
    other lengths at construction (ValueError), before any collective."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import Trainer
    seq = Mesh([[0], [1]], ("seq", "data"))
    for arch in ("zamba2-1.2b", "rwkv6-7b"):
        cfg = fam_cfg(arch)
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=32))
        # 48 rows a shard: whole blocks of 16, not whole chunks of 32
        with pytest.raises(ValueError, match="whole chunks of 32"):
            Trainer(cfg, seq_len=96, batch=2, device="cpu", mesh=seq)


# -- the hybrid pairing (ROADMAP §A) ------------------------------------------

def test_hybrid_plan_pairs_layer_captures_with_applications():
    """The hybrid Trainer's pairing, held to the reference: one pooled map
    per LAYER (zeros for the Mamba-only layers 0 and 2 of reduced zamba2
    with 4 layers, the block every 2nd) gives the same stacked plan,
    bitwise, from the port's SpionController and the JAX one; the port's
    forward then reads application i's tables from the plan's row i (the
    reference's `ex.attend_app(..., app_idx)`, src/repro/models/
    hybrid.py:60), and its logits are the reference's within 3e-5 on that
    plan."""
    import jax.numpy as jnp
    from repro.core.spion import SpionController as JCtl
    from repro.core.spion import SpionState as JState
    from repro.models.registry import build as jbuild
    from repro_torch.core.attention_exec import SparseAttentionExec as TExec
    from repro_torch.core.spion import SpionController, SpionState
    from repro_torch.models.registry import build as tbuild
    from torch_parity import arch_configs, params
    jc, tc = arch_configs("zamba2-1.2b", num_layers=4)
    jc, tc = (c.replace(spion=dataclasses.replace(c.spion, block_size=BLOCK,
                                                  kernel="auto"))
              for c in (jc, tc))
    nb = S // BLOCK
    rng = np.random.default_rng(4)
    maps = rng.random((4, nb, nb)).astype(np.float32)
    maps[[0, 2]] = 0.0
    tst = SpionController(tc.spion, causal=tc.causal,
                          seq_len=S).generate(SpionState(), maps)
    jst = JCtl(jc.spion, causal=jc.causal, seq_len=S).generate(JState(), maps)
    tabs = tst.table_arrays()
    assert tabs["col_idx"].shape[0] == 4
    for k, v in tabs.items():
        np.testing.assert_array_equal(np.asarray(jst.tables[k]), v,
                                      err_msg=k)
    assert tst.plan_stats == jst.plan_stats
    # application i reads row i (layer i's capture), not the row of the
    # layer it runs after
    seen = []
    inner = TExec.attend

    def attend(self, cfg, q, k, v, layer_tables):
        seen.append({n: t.clone() for n, t in layer_tables.items()})
        return inner(self, cfg, q, k, v, layer_tables)
    jp, tp = params(jc, tc)
    toks = np.random.default_rng(5).integers(0, 128, (2, S)).astype(np.int32)
    TExec.attend = attend
    try:
        tl, _ = tbuild(tc).forward(tp, {"tokens": torch.as_tensor(toks)},
                                   spion=SpionController(
                                       tc.spion, causal=tc.causal,
                                       seq_len=S).attention_exec(tst))
    finally:
        TExec.attend = inner
    assert len(seen) == 2
    for i, got in enumerate(seen):
        for n, t in got.items():
            np.testing.assert_array_equal(t.numpy(), tabs[n][i], err_msg=n)
    jl, _ = jbuild(jc).forward(jp, {"tokens": jnp.asarray(toks)},
                               spion=JCtl(jc.spion, causal=jc.causal,
                                          seq_len=S).attention_exec(jst))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL,
                               rtol=0)


# -- remat's recompute under the forward's mesh -------------------------------

@pytest.mark.parametrize("arch,hook", [("zamba2-1.2b", "mamba.seq_left_rows"),
                                       ("rwkv6-7b", "rwkv.seq_left_rows"),
                                       ("whisper-tiny", "encdec.gather_kv")])
def test_remat_recompute_runs_under_the_forward_mesh(monkeypatch, arch, hook):
    """With cfg.remat the backward runs each layer again; for CUDA tensors
    it does so on autograd's device thread, where the forward's mesh
    context is not set. Here the backward runs on another thread, as
    autograd's would, and the layer's collective entry point (the halo
    rows of zamba2's Mamba layers and of rwkv6's mixes, the K/V gather of
    whisper's encoder and decoder layers) records the mesh it sees: the
    forward's, every time."""
    import importlib
    from repro_torch.distributed.sharding import current_mesh, mesh_context
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import compute_params
    from repro_torch.models.registry import build
    modname, fn = hook.split(".")
    mod = importlib.import_module(f"repro_torch.models.{modname}")
    seen = []
    inner = getattr(mod, fn)

    def spy(*a):
        seen.append(current_mesh())
        return inner(*a)
    monkeypatch.setattr(mod, fn, spy)
    cfg = fam_cfg(arch, remat=True)
    mesh = Mesh([[0], [1]], ("data", "model"))   # no 'seq': no collective
    params = masters(cfg)
    batch = {k: torch.as_tensor(v) for k, v in case_batch(arch).items()}
    with mesh_context(mesh):
        loss, _ = build(cfg).loss(compute_params(params, torch.float32),
                                  batch)
    n = len(seen)
    assert n and seen == [mesh] * n
    grads = []
    t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(
        loss, list(params.parameters()), allow_unused=True)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and grads
    assert len(seen) > n and seen == [mesh] * len(seen)
