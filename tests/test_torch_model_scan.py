"""Port parity, the 'model' axis for the hybrid, ssm and encdec families
(zamba2-1.2b, rwkv6-7b, whisper-tiny).

  - One 4-rank gloo job runs every step case on three meshes built from
    the same four processes: (data 1, model 2) (each pair of ranks its own
    line), (data 2, model 2) and, for zamba2, (model 4). The cases: reduced
    zamba2-1.2b dense and sparse (remat, its shared block on the kernels'
    plain versions), reduced rwkv6-7b dense, reduced whisper-tiny dense and
    sparse (remat) with its vocabulary of 128 (vocab-parallel) and of 127
    (the tied embedding replicated). Each is held against one process on
    the same global batch and masters: loss within 3e-5, gathered
    gradients within 1e-4 of each leaf's largest, the replicated leaves'
    gradients bitwise equal across the model line.
  - Mamba2's packed in_proj: each rank's columns are the r-th part of z,
    x, B‖C and dt (`sharding.local_index`), a partition of the reference's
    spec shard's shape at full size; `shard_params` -> `gather_params`
    gives the masters back bitwise.
  - Three cases against the JAX package's one-device step, their
    parameters through `params_from_numpy(mesh=)`: zamba2 sparse (the
    reference's jnp gather path), rwkv6, whisper.
  - Planted faults, each past a gate: in_proj cut contiguously, the
    whole-width norms' statistic of the rank's slice alone or summed in the
    forward only, the replicated leaves used without `copy_to_model`, a
    restore that cuts in_proj contiguously.
  - zamba2's Trainer through the three phases on (data 2, model 2): one
    plan digest, the one-process Trainer's; its checkpoint restores in one
    process and a one-process checkpoint on the mesh, bitwise.
  - The scan fallback (a scan width |model| does not divide), in the same
    job on model 4 and on (seq 2, model 2): zamba2 with 2N = 10 (sparse,
    remat), with 6 SSM heads, with in_proj split and out_proj whole, and
    wholly replicated; rwkv6 with 6 heads (1.5 a rank) and wholly
    replicated; zamba2 with 3 SSM heads and rwkv6 with 3 heads on (seq 2,
    model 2). Each step as above (loss, gathered gradients, the replicated
    leaves bitwise across the line), the masters through shard_params /
    gather_params bitwise, and 4 decode steps from a cache cut by
    shard_cache within 3e-5 of one process. Two of them on the mesh from
    the JAX package's parameters; each config in one process against the
    JAX package (fp32 3e-5 / 1e-4; bf16 6e-2). Planted faults: whole
    leaves without copy_to_model where out_proj is row-parallel, summed
    where the layer is wholly replicated (each > 10x the gradient gate),
    and a cut by segment where the reference cuts contiguously (the conv
    state's misses the decode gate by > 10x; in_proj's cannot be formed
    and raises).
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

S = 64           # tokens a sequence: 4 blocks of 16, 4 chunks of 16
ENC = 32         # whisper's frames a sequence
B = 4            # sequences of the global batch


def arch_cfg(arch, **kw):
    c = get_config(arch).reduced()
    if "ssm" in kw:
        kw = dict(kw, ssm=dataclasses.replace(c.ssm, **kw["ssm"]))
    return c.replace(dtype="float32", spion=dataclasses.replace(
        c.spion, block_size=16, kernel="fused"), **kw)


# case: (arch, config overrides, sparse)
CASES = {
    "zamba2_dense": ("zamba2-1.2b", {"remat": True}, False),
    "zamba2_sparse": ("zamba2-1.2b", {"remat": True}, True),
    "rwkv6_dense": ("rwkv6-7b", {}, False),
    "whisper_dense": ("whisper-tiny", {"remat": True}, False),
    "whisper_sparse": ("whisper-tiny", {"remat": True}, True),
    "whisper127_dense": ("whisper-tiny", {"vocab_size": 127}, False),
    "whisper127_sparse": ("whisper-tiny", {"vocab_size": 127}, True),
}
# (case, mesh) pairs of the step job: every case on (data 1, model 2) and
# (data 2, model 2), zamba2 on (model 4) too
STEPS = [(c, m) for c in CASES for m in ("data1_model2", "data2_model2")] + \\
    [("zamba2_dense", "model4"), ("zamba2_sparse", "model4")]
# the scan fallback: a scan width |model| does not divide. On model 4:
# zamba2 with 2N = 10 (in_proj's 274 columns whole, out_proj's 128 rows
# split: partial output gradients; the shared block on its heads through
# the kernels' plain versions), with 6 SSM heads (the conv state cut
# contiguously), with in_proj's 196 columns split and out_proj's 90 rows
# whole (d_model 45, 6 heads of 15), and wholly replicated (d_model 45, 9
# heads of 10: inner 90); rwkv6 with 6 heads (inner 96: 24 columns a rank,
# 1.5 heads) and wholly replicated (6 heads of 9: inner 54). On (seq 2,
# model 2): zamba2 with 3 SSM heads of 32 and rwkv6 with 3 heads (inner
# 48), each split mid-head.
CASES.update({
    "zamba2_n5": ("zamba2-1.2b", {"remat": True, "ssm": {"state_size": 5}},
                  True),
    "zamba2_h6": ("zamba2-1.2b", {"d_model": 48}, False),
    "zamba2_c": ("zamba2-1.2b", {"d_model": 45, "ssm": {
        "head_dim": 15, "state_size": 5}}, False),
    "zamba2_d45": ("zamba2-1.2b", {"d_model": 45, "ssm": {"head_dim": 10}},
                   False),
    "zamba2_h3": ("zamba2-1.2b", {"d_model": 48, "ssm": {"head_dim": 32}},
                  False),
    "rwkv6_h6": ("rwkv6-7b", {"num_heads": 6, "num_kv_heads": 6}, False),
    "rwkv6_h6x9": ("rwkv6-7b", {"num_heads": 6, "num_kv_heads": 6,
                                "head_dim": 9, "d_model": 54}, False),
    "rwkv6_h3": ("rwkv6-7b", {"num_heads": 3, "num_kv_heads": 3}, False),
})
FALLBACK = [("zamba2_n5", "model4"), ("zamba2_h6", "model4"),
            ("zamba2_c", "model4"), ("zamba2_d45", "model4"),
            ("rwkv6_h6", "model4"), ("rwkv6_h6x9", "model4"),
            ("zamba2_h3", "seq2_model2"), ("rwkv6_h3", "seq2_model2")]
STEPS += FALLBACK
DECODE_B, DECODE_LEN, DECODE_START, DECODE_STEPS = 2, 32, 12, 4


def case_cfg(name):
    arch, kw, _ = CASES[name]
    return arch_cfg(arch, **kw)


def case_batch(name, seed=7):
    cfg = case_cfg(name)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, ENC, cfg.d_model)).astype(
            np.float32)
    return b


def case_tables(name):
    from repro_torch.launch.steps import spion_dryrun_tables
    if not CASES[name][2]:
        return None
    return spion_dryrun_tables(case_cfg(name), S)


def masters(cfg):
    from repro_torch.launch.train import masters_of
    from repro_torch.models.registry import build
    return masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu"))


def decode_tokens(name):
    rng = np.random.default_rng(13)
    return rng.integers(0, case_cfg(name).vocab_size, size=(
        DECODE_START + DECODE_STEPS, DECODE_B, 1)).astype(np.int64)


def start_cache(name, params):
    \"\"\"One process's decode cache after DECODE_START tokens.\"\"\"
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import build
    cfg = case_cfg(name)
    cache = build(cfg).init_cache(DECODE_B, DECODE_LEN, device="cpu")
    serve = make_serve_step(cfg)
    toks = torch.as_tensor(decode_tokens(name))
    with torch.no_grad():
        for p in range(DECODE_START):
            _, cache = serve(params, cache, toks[p], p)
    return cache


def trainer_cfg():
    c = case_cfg("zamba2_dense")
    return c.replace(spion=dataclasses.replace(
        c.spion, min_dense_epochs=1, max_dense_epochs=3))


def trainer_data(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(B, S + 1)).astype(np.int32)
    toks[:, 1::2] = toks[:, ::2][:, : toks[:, 1::2].shape[1]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def trainer(**kw):
    from repro_torch.launch.train import Trainer
    return Trainer(trainer_cfg(), seq_len=S, batch=B, lr=0.05,
                   total_steps=100, steps_per_epoch=2, data_fn=trainer_data,
                   device="cpu", sentinel=False, **kw)


def planted(fault):
    \"\"\"[(module, name, replacement)] of a planted fault.\"\"\"
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.models import layers, mamba, rwkv
    return {
        # in_proj's reference shard (contiguous columns) read as segments
        "in_proj_contiguous": [(sharding, "packed_segments",
                                lambda name, cfg: None)],
        # the whole-width norms' statistic of the rank's slice alone
        "norm_local": [(layers, "model_line_sum",
                        lambda x: x * sharding.model_size())],
        # the statistic summed over the line in the forward only
        "norm_forward_only": [(layers, "model_line_sum",
                               sharding.reduce_from_model)],
        # the replicated leaves (conv_w, A_log, ...; w0, u, ...) used in
        # part without copy_to_model
        "leaf_no_copy": [(mamba, "model_part", lambda leaf, idx: leaf[idx]),
                         (rwkv, "model_part", lambda leaf, idx: leaf[idx])],
        # the Trainer's restore cutting in_proj contiguously
        "restore_contiguous": [(train, "local_index",
                                lambda mesh, name, spec, shape, cfg=None,
                                rank=None: sharding.local_slices(
                                    mesh, spec, shape, rank))],
        # the scan fallback's whole leaves without copy_to_model where
        # out_proj is row-parallel
        "whole_no_copy": [(mamba, "model_whole", lambda leaf, part: leaf),
                          (rwkv, "model_whole", lambda leaf, part: leaf)],
        # their gradients summed where the layer runs wholly replicated
        "whole_summed": [(mamba, "model_whole",
                          lambda leaf, part: sharding.copy_to_model(leaf)),
                         (rwkv, "model_whole",
                          lambda leaf, part: sharding.copy_to_model(leaf))],
        # in_proj and the conv state cut by segment under the fallback,
        # where the reference cuts them contiguously
        "segments_always": [(sharding, "_segments",
                             lambda mesh, name, cfg:
                             sharding.packed_segments(name, cfg))],
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


# the planted step faults, each on (data 2, model 2)
FAULT_CASES = [("in_proj_contiguous", "zamba2_dense"),
               ("norm_local", "zamba2_dense"), ("norm_local", "rwkv6_dense"),
               ("norm_forward_only", "zamba2_dense"),
               ("norm_forward_only", "rwkv6_dense"),
               ("leaf_no_copy", "zamba2_dense"),
               ("leaf_no_copy", "rwkv6_dense")]
# the cases also held against the JAX package's one-device step, on
# (data 2, model 2) or the mesh named
JAX_CASES = ("zamba2_sparse", "rwkv6_dense", "whisper_dense", "zamba2_n5",
             "rwkv6_h6", "zamba2_h3")
JAX_MESH = {"zamba2_n5": "model4", "rwkv6_h6": "model4",
            "zamba2_h3": "seq2_model2"}
# the fallback's planted faults: (fault, case) of a step on the case's
# fallback mesh, and the decode's
FALLBACK_FAULTS = [("whole_no_copy", "zamba2_n5"),
                   ("whole_no_copy", "rwkv6_h6"),
                   ("whole_summed", "zamba2_d45"),
                   ("whole_summed", "rwkv6_h6x9")]
FALLBACK_MESH = dict(FALLBACK)
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
from repro_torch.core.spion import plan_digest
from repro_torch.data.pipeline import local_batch
from repro_torch.distributed.sharding import (data_axes, gather_cache,
                                              gather_params, param_pspecs,
                                              reshard, sanitize_spec,
                                              shard_cache, shard_params,
                                              sharded_dim)
from repro_torch.launch.mesh import make_distributed_mesh, make_mesh
from repro_torch.launch.steps import (cache_pspecs, make_loss_and_grads,
                                      make_serve_step)
from repro_torch.launch.train import nest
from repro_torch.models.layers import ParamTree
lines = [make_mesh((1, 2), ("data", "model"), ranks=r)
         for r in ([0, 1], [2, 3])]
MESHES = {"data1_model2": lines[pid // 2],
          "data2_model2": make_distributed_mesh(model=2, data=2),
          "model4": make_distributed_mesh(model=4),
          "seq2_model2": make_distributed_mesh(seq=2, model=2)}
out, info = {}, {m: {"coords": mesh.coords(), "line": mesh.line("model")}
                 for m, mesh in MESHES.items()}


def record(key, loss, grads, specs, cfg, mesh):
    out[f"{key}/loss"] = loss.detach().numpy()
    for k, v in gather_params(grads, specs, mesh, cfg).items():
        out[f"{key}/g/{k}"] = v.numpy()
    for k, v in grads.items():
        if sharded_dim(specs[k]) is None:
            out[f"{key}/local/{k}"] = v.numpy()


def step(name, mesh_name, key=None):
    cfg, mesh = case_cfg(name), MESHES[mesh_name]
    full = masters(cfg)
    specs = param_pspecs(full, mesh)
    params = ParamTree(nest(shard_params(full, mesh, specs, cfg)),
                       trainable=True)
    batch = local_batch(mesh, case_batch(name), "cpu")
    loss, grads = make_loss_and_grads(cfg, mesh=mesh)(params, batch,
                                                      case_tables(name))
    record(key or f"{name}@{mesh_name}", loss, grads, specs, cfg, mesh)
    return full, specs, params


def decode(name, mesh_name, key):
    \"\"\"DECODE_STEPS decode steps on the mesh from one process's cache cut
    by shard_cache: the logits, and the final cache through gather_cache.\"\"\"
    cfg, mesh = case_cfg(name), MESHES[mesh_name]
    full = masters(cfg)
    local = ParamTree(nest(shard_params(full, mesh, param_pspecs(full, mesh),
                                        cfg)))
    cache = start_cache(name, full)
    specs = cache_pspecs(cfg, cache, mesh, DECODE_B)
    shard = shard_cache(cache, specs, mesh, cfg)
    info.setdefault("cache_shape", {})[key] = {
        k: list(v.shape) for k, v in shard.items()}
    serve = make_serve_step(cfg, mesh=mesh, specs=specs)
    toks = torch.as_tensor(decode_tokens(name))
    ospec = sanitize_spec(mesh, (data_axes(mesh), "model"),
                          (DECODE_B, cfg.vocab_size))
    logits = []
    for i in range(DECODE_STEPS):
        lg, shard = serve(local, shard, toks[DECODE_START + i],
                          DECODE_START + i)
        logits.append(reshard(lg, ospec, (), mesh).numpy())
    out[f"{key}/decode/logits"] = np.stack(logits)
    for k, v in gather_cache(shard, specs, mesh, cfg).items():
        out[f"{key}/decode/cache/{k}"] = v.numpy()


for name, mesh_name in STEPS:
    full, specs, params = step(name, mesh_name)
    if (name, mesh_name) in FALLBACK:
        back = gather_params(dict(params.named_parameters()), specs,
                             MESHES[mesh_name], case_cfg(name))
        info.setdefault("roundtrip", {})[name] = all(
            torch.equal(back[n], p) for n, p in full.named_parameters())
        decode(name, mesh_name, f"{name}@{mesh_name}")
    if name == "zamba2_dense":
        # the shards back to the whole masters, bitwise; in_proj's shard
        mesh = MESHES[mesh_name]
        back = gather_params(dict(params.named_parameters()), specs, mesh,
                             case_cfg(name))
        info[mesh_name]["roundtrip"] = all(
            torch.equal(back[n], p) for n, p in full.named_parameters())
        info[mesh_name]["in_proj"] = list(
            params["layers"]["mamba"]["in_proj"].shape)
        out[f"in_proj@{mesh_name}"] = \\
            params["layers"]["mamba"]["in_proj"].detach().numpy()
for fault, name in FAULT_CASES:
    with Planted(fault):
        step(name, "data2_model2", f"planted_{fault}/{name}@data2_model2")
for fault, name in FALLBACK_FAULTS:
    with Planted(fault):
        step(name, FALLBACK_MESH[name], f"planted_{fault}/{name}")
with Planted("segments_always"):
    # in_proj's 196 columns split on 4 but its segments (90, 90, 10, 6) do
    # not: a cut by segment cannot be formed
    try:
        step("zamba2_c", "model4", "planted_segments_always/zamba2_c")
    except ValueError as e:
        info["segments_raised"] = str(e)
    # the conv state's 112 columns and its segments (96, 16) split on 4:
    # cut by segment, read as the contiguous cut
    decode("zamba2_h6", "model4", "planted_segments_always/zamba2_h6")

# the JAX package's parameters, each rank's shard through params_from_numpy
for name in JAX_CASES:
    cfg, mesh = case_cfg(name), MESHES[JAX_MESH.get(name, "data2_model2")]
    with np.load(os.path.join(os.environ["MP_JAX"], f"{name}.npz")) as z:
        tree = nest({k.replace("/", "."): z[k] for k in z.files})
    jp = ParamTree(dict(params_from_numpy(tree, cfg, "cpu",
                                          mesh=mesh).items()),
                   trainable=True)
    loss, grads = make_loss_and_grads(cfg, mesh=mesh)(
        jp, local_batch(mesh, case_batch(name), "cpu"), case_tables(name))
    record(f"jax_{name}", loss, grads, param_pspecs(tree, mesh), cfg, mesh)

# zamba2's three-phase Trainer on (data 2, model 2); its checkpoint at 8
mesh = MESHES["data2_model2"]
tr = trainer(mesh=mesh, ckpt_dir=os.path.join(OUT, "ckpt"))
phases = []
tr.step_callback = lambda s, l: phases.append(tr.spion_state.phase)
losses = tr.train(8, ckpt_every=8, log_every=100, log=lambda *a: None)
st = tr.spion_state
for k, v in gather_params(dict(tr.params.named_parameters()), tr._specs,
                          mesh, tr.cfg).items():
    out[f"trainer/p/{k}"] = v.detach().numpy()
info["trainer"] = {"losses": losses, "phases": phases, "phase": st.phase,
                   "digest": plan_digest(st.table_arrays(),
                                         st.tables["block"]),
                   "shards": {n: list(p.shape)
                              for n, p in tr.params.named_parameters()}}

# a one-process checkpoint restored on (data 2, model 2), sound and with
# the restore cutting in_proj contiguously
for kind in ("restored", "planted_restore"):
    back = trainer(mesh=mesh, ckpt_dir=os.environ["MP_CKPT"])
    if kind == "restored":
        assert back.maybe_resume()
    else:
        with Planted("restore_contiguous"):
            assert back.maybe_resume()
    info[f"{kind}_step"] = back.step
    for part, named in (("p", dict(back.params.named_parameters())),
                        ("mu", back.opt["mu"]), ("nu", back.opt["nu"])):
        for k, v in gather_params(named, back._specs, mesh, back.cfg).items():
            out[f"{kind}/{part}/{k}"] = v.detach().numpy()

np.savez(os.path.join(OUT, f"rank{pid}.npz"), **out)
json.dump(info, open(os.path.join(OUT, f"info{pid}.json"), "w"))
print("MODEL_SCAN_OK")
runtime.shutdown(0)
"""


_JAX_ONE = {}


def jax_case(name):
    """(JAX parameters as {'/'-path: array}, the reference's loss and
    {dotted name: gradient}) of case `name`'s step in one process, fp32; a
    sparse case runs the reference's jnp gather path on its own dry-run
    tables, which equal the port's. Cached."""
    if name in _JAX_ONE:
        return _JAX_ONE[name]
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch.steps import spion_dryrun_tables
    from repro.models.registry import build as jbuild
    arch, kw, sparse = CASES[name]
    tc = case_cfg(name)
    jc = jget(arch).reduced()
    if "ssm" in kw:
        kw = dict(kw, ssm=dataclasses.replace(jc.ssm, **kw["ssm"]))
    jc = jc.replace(dtype="float32", spion=dataclasses.replace(
        jc.spion, block_size=16, kernel="jnp" if sparse else "fused"), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc.replace(
        spion=dataclasses.replace(tc.spion, kernel=jc.spion.kernel)))
    jp = jbuild(jc).init(jax.random.key(0))
    b = {k: jnp.asarray(v) for k, v in case_batch(name).items()}
    spion = None
    if sparse:
        spion = spion_dryrun_tables(jc, S)
        for k in ("col_idx", "nvalid"):
            np.testing.assert_array_equal(np.asarray(spion[k]),
                                          case_tables(name)[k].numpy())
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: jbuild(jc).loss(p, b, spion=spion), has_aux=True))(jp)

    def flat(tree, sep):
        return {sep.join(k.key for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    _JAX_ONE[name] = (flat(jp, "/"), float(loss), flat(g, "."))
    return _JAX_ONE[name]


@pytest.fixture(scope="module")
def mp_job(tmp_path_factory):
    """The 4-rank job's records: per rank its npz and info json; the JAX
    cases; the one-process checkpoint's state; and the run directory."""
    d = tmp_path_factory.mktemp("model_scan_job")
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
    assert all("MODEL_SCAN_OK" in o for o in outs)
    return {"dir": d, "jax": jax_runs, "one_ckpt": state,
            "ranks": [dict(np.load(d / f"rank{i}.npz")) for i in range(4)],
            "info": [json.load(open(d / f"info{i}.json")) for i in range(4)]}


_ONE = {}


def one_process(name):
    """(loss, {leaf: gradient}) of case `name`'s step in one process on the
    global batch (cached)."""
    if name not in _ONE:
        from repro_torch.launch.steps import make_loss_and_grads
        cfg = case_cfg(name)
        batch = {k: torch.as_tensor(v) for k, v in case_batch(name).items()}
        loss, grads = make_loss_and_grads(cfg)(masters(cfg), batch,
                                               case_tables(name))
        _ONE[name] = (float(loss.detach()),
                      {k: g.numpy() for k, g in grads.items()})
    return _ONE[name]


def grad_gap(rec, key, want):
    """The worst leaf's max |difference| over its largest |element|."""
    return max(float(np.abs(rec[f"{key}/g/{k}"] - g).max()
                     / max(np.abs(g).max(), 1e-30)) for k, g in want.items())


@pytest.mark.parametrize("name,mesh_name", STEPS)
def test_model_scan_steps_match_one_process(mp_job, name, mesh_name):
    """Each case's step on the mesh: loss within 3e-5 of one process's,
    its gradients, gathered over the model line (in_proj's columns put
    back in order), within 1e-4 of each leaf's largest; every rank holds
    the same gathered gradients, and the replicated leaves' gradients
    (norm scales, Mamba2's conv_w, A_log, D, dt_bias, RWKV6's mix, w0,
    w_lora_*, u, ln_x, whisper's replicated embedding) agree bitwise
    across each model line."""
    loss, grads = one_process(name)
    ranks, key = mp_job["ranks"], f"{name}@{mesh_name}"
    for r, rec in enumerate(ranks):
        assert abs(float(rec[f"{key}/loss"]) - loss) <= LOSS_TOL, \
            (key, r, float(rec[f"{key}/loss"]), loss)
        assert grad_gap(rec, key, grads) <= GRAD_TOL, (key, r)
        for k in grads:
            np.testing.assert_array_equal(rec[f"{key}/g/{k}"],
                                          ranks[0][f"{key}/g/{k}"])
    local = [k for k in ranks[0] if k.startswith(f"{key}/local/")]
    assert local
    lines = {tuple(i[mesh_name]["line"]) for i in mp_job["info"]}
    assert len(lines) == {"model4": 1}.get(mesh_name, 2)
    for line in lines:
        for r in line[1:]:
            for k in local:
                np.testing.assert_array_equal(ranks[r][k], ranks[line[0]][k],
                                              err_msg=k)


_DECODE = {}


def one_process_decode(name):
    """{record: array} of case `name`'s DECODE_STEPS decode steps in one
    process from the same start (cached): the logits and final cache."""
    if name not in _DECODE:
        from repro_torch.launch.steps import make_serve_step
        full = masters(case_cfg(name))
        cache = start_cache(name, full)
        serve = make_serve_step(case_cfg(name))
        toks = torch.as_tensor(decode_tokens(name))
        logits = []
        with torch.no_grad():
            for i in range(DECODE_STEPS):
                lg, cache = serve(full, cache, toks[DECODE_START + i],
                                  DECODE_START + i)
                logits.append(lg.numpy())
        res = {"logits": np.stack(logits)}
        res.update({f"cache/{k}": v.numpy() for k, v in cache.items()})
        _DECODE[name] = res
    return _DECODE[name]


def rel_gap(got, want):
    """max |got - want| over want's largest |element| (inf where `got` is
    not finite)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,mesh_name", FALLBACK)
def test_fallback_decode_matches_one_process(mp_job, name, mesh_name):
    """The scan fallback's decode: 4 steps on the mesh from one process's
    cache cut by shard_cache (the SSM and WKV states over heads and the
    conv state over its columns where |model| divides them, contiguous),
    each Mamba2 or WKV6 layer gathering the state leaves that are split,
    running the whole step and keeping its shard: the logits and the final
    cache after gather_cache within 3e-5 of one process's (of each
    record's largest element), the same on every rank; the masters round
    trip through shard_params and gather_params bitwise."""
    want = one_process_decode(name)
    ranks, key = mp_job["ranks"], f"{name}@{mesh_name}"
    for r, rec in enumerate(ranks):
        assert mp_job["info"][r]["roundtrip"][name], (name, r)
        for k, v in want.items():
            g = rel_gap(rec[f"{key}/decode/{k}"], v)
            assert g <= LOSS_TOL, (key, r, k, g)
            np.testing.assert_array_equal(rec[f"{key}/decode/{k}"],
                                          ranks[0][f"{key}/decode/{k}"])


def test_fallback_layouts(mp_job):
    """The fallback's cache shards are cache_pspecs' contiguous cuts:
    zamba2 with 2N = 10 on 4 holds 2 of its 8 SSM heads and the whole conv
    state (138 columns do not divide 4); with 6 SSM heads on 4 the whole
    SSM state and 28 of the conv state's 112 columns; with 6 heads of 15
    25 of 100; rwkv6's 6 heads keep the WKV state whole. The planted cut
    by segment of in_proj's 196 columns (segments 90, 90, 10, 6) cannot be
    formed on 4 ranks and raises before any collective."""
    info = mp_job["info"][0]
    cs = info["cache_shape"]
    assert cs["zamba2_n5@model4"]["conv"] == [2, 2, 3, 138]
    assert cs["zamba2_n5@model4"]["ssm"] == [2, 2, 2, 5, 16]
    assert cs["zamba2_h6@model4"]["conv"] == [2, 2, 3, 28]
    assert cs["zamba2_h6@model4"]["ssm"] == [2, 2, 6, 8, 16]
    assert cs["zamba2_c@model4"]["conv"] == [2, 2, 3, 25]
    assert cs["rwkv6_h6@model4"]["S"] == [2, 2, 6, 16, 16]
    assert "does not split over 4 ranks" in info["segments_raised"]


@pytest.mark.parametrize("fault,name", FALLBACK_FAULTS)
def test_fallback_faults_miss_a_gate(mp_job, fault, name):
    """Each planted fault of the scan fallback moves a gathered gradient
    past 10x its gate (1e-4 of the leaf's largest): the whole leaves
    (Mamba2's conv_w, conv_b, A_log, D, dt_bias, out_norm and in_proj;
    RWKV6's w0, w_lora_b, u, ln_x) read without copy_to_model where
    out_proj is row-parallel (each rank's gradient one rank's share), or
    summed over the line where the layer runs wholly replicated (|model|
    times too large)."""
    loss, grads = one_process(name)
    key = f"planted_{fault}/{name}"
    worst = min(grad_gap(rec, key, grads) for rec in mp_job["ranks"])
    assert worst > 10 * GRAD_TOL, (fault, name, worst)


def test_fallback_conv_cut_by_segment_misses_the_gate(mp_job):
    """The conv state cut by segment where the scan runs the fallback (112
    columns, segments 96 and 16: the cut forms, but the layer reads its
    shard as the reference's contiguous cut) moves the decode's logits
    past 10x the 3e-5 gate."""
    want = one_process_decode("zamba2_h6")["logits"]
    worst = min(rel_gap(rec["planted_segments_always/zamba2_h6/decode/"
                            "logits"], want) for rec in mp_job["ranks"])
    assert worst > 10 * LOSS_TOL, worst


@pytest.mark.parametrize("name", [n for n, _ in FALLBACK])
def test_fallback_configs_one_process_match_the_jax_package(name):
    """Each fallback case's config in one process against the JAX package's
    one-device step on the same parameters and batch (fp32): loss within
    3e-5, every gradient within 1e-4 of its leaf's largest; the sparse
    case on the reference's jnp gather path."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import nest
    from repro_torch.models.layers import ParamTree
    jparams, jloss, jgrads = jax_case(name)
    cfg = case_cfg(name)
    tp = ParamTree(dict(params_from_numpy(
        nest({k.replace("/", "."): v for k, v in jparams.items()}), cfg,
        "cpu").items()), trainable=True)
    loss, grads = make_loss_and_grads(cfg)(
        tp, {k: torch.as_tensor(v) for k, v in case_batch(name).items()},
        case_tables(name))
    assert abs(float(loss) - jloss) <= LOSS_TOL
    for k, g in jgrads.items():
        assert rel_gap(grads[k].numpy(), g) <= GRAD_TOL, k


@pytest.mark.parametrize("name", ["zamba2_n5", "rwkv6_h6"])
def test_fallback_configs_bf16_match_the_jax_package(name):
    """The same in bf16 (the step casts the fp32 masters of ndim >= 2):
    the forward's logits within 6e-2 of the JAX package's largest and the
    loss within 6e-2; rwkv6's gradients within 6e-2 of each leaf's largest
    too (as C3's test holds them). The hybrid family's bf16 is held by its
    forward, as test_torch_hybrid holds it: a bf16 step's A_log gradient
    sums rounded terms in another order than XLA's (7e-2 of its largest
    on zamba2 with 2N = 10)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch.steps import spion_dryrun_tables
    from repro.models.registry import build as jbuild
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.models.layers import ParamTree
    arch, kw, sparse = CASES[name]
    jc = jget(arch).reduced()
    if "ssm" in kw:
        kw = dict(kw, ssm=dataclasses.replace(jc.ssm, **kw["ssm"]))
    jc = jc.replace(dtype="bfloat16", spion=dataclasses.replace(
        jc.spion, block_size=16, kernel="jnp" if sparse else "fused"), **kw)
    tc = case_cfg(name).replace(dtype="bfloat16")

    def cast(p, dtype):
        return jax.tree_util.tree_map(
            lambda x: x.astype(dtype)
            if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
    masters = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.ndim >= 2 else x,
        jbuild(jc).init(jax.random.key(0)))
    b = case_batch(name)
    spion = spion_dryrun_tables(jc, S) if sparse else None
    jlogits, _ = jbuild(jc).forward(
        cast(masters, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in b.items()}, spion=spion)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jbuild(jc).loss(cast(p, jnp.bfloat16),
                                  {k: jnp.asarray(v) for k, v in b.items()},
                                  spion=spion), has_aux=True))(masters)
    tp = ParamTree(dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, masters), tc, "cpu").items()),
        trainable=True)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    loss, grads = make_loss_and_grads(tc)(tp, tb, case_tables(name))
    assert abs(float(loss) - float(jloss)) <= 6e-2
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.core.sparse_attention import PLAN_TABLE_KEYS
    from repro_torch.launch.steps import compute_params
    from repro_torch.models.registry import build as tbuild
    tabs = case_tables(name)
    with torch.no_grad():
        logits, _ = tbuild(tc).forward(
            compute_params(tp, torch.bfloat16), tb,
            spion=None if tabs is None else SparseAttentionExec(
                {k: tabs[k] for k in PLAN_TABLE_KEYS if k in tabs},
                block=16, phase="train"))
    assert rel_gap(logits.float().numpy(),
                   np.asarray(jlogits, np.float32)) <= 6e-2
    if CASES[name][0] != "rwkv6-7b":
        return
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key, g = ".".join(k.key for k in path), np.asarray(g)
        gap = rel_gap(grads[key].float().numpy(), g)
        assert gap <= 6e-2, (key, gap)


def test_whisper_vocab_layout(mp_job):
    """whisper's tied embedding: vocab-parallel over 128 (the loss never
    gathers the logits), replicated over 127 (its gradient whole on every
    rank, held bitwise by the step cases)."""
    rec = mp_job["ranks"][0]
    assert "whisper_dense@data2_model2/local/tok_embed.w" not in rec
    assert "whisper127_dense@data2_model2/local/tok_embed.w" in rec


def test_in_proj_segments_partition_the_reference_shard():
    """At zamba2-1.2b's full size on |model| 2 and 4, each rank's in_proj
    columns are the rank-th part of z, x, B‖C and dt (2048 + 2048 + 64 + 32
    = 4192 on 2 ranks), the ranks' columns partition the whole, and the
    shard's shape is the reference's spec shard's (param_pspecs bitwise
    the JAX package's: test_torch_model_parallel). Without the config a
    packed leaf raises."""
    from repro.distributed import sharding as ref
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as port
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import build
    cfg = get_config("zamba2-1.2b")
    tree = build(cfg).init(torch.Generator().manual_seed(0), device="meta")
    leaf = tree["layers"]["mamba"]["in_proj"]
    name = "layers.mamba.in_proj"
    inner, N, H = 4096, 64, 64
    assert leaf.shape[-1] == 2 * inner + 2 * N + H == 8384
    for m in (2, 4):
        mesh = Mesh(np.arange(m).reshape(1, m), ("data", "model"))
        spec = port.param_pspecs(tree, mesh)[name]
        assert spec == tuple(ref.best_spec(mesh, "layers/mamba/in_proj",
                                           leaf)) == (None, None, "model")
        cols = [port.local_index(mesh, name, spec, leaf.shape, cfg, rank=r)
                [2] for r in range(m)]
        assert sorted(np.concatenate(cols).tolist()) == list(range(8384))
        for r, c in enumerate(cols):
            assert len(c) == leaf.shape[-1] // m == \
                len(range(*port.local_slices(mesh, spec, leaf.shape,
                                             r)[2].indices(8384)))
            bounds = [0, inner, 2 * inner, 2 * inner + 2 * N, 8384]
            for lo, hi in zip(bounds, bounds[1:]):
                w = (hi - lo) // m
                np.testing.assert_array_equal(
                    c[(c >= lo) & (c < hi)], np.arange(lo + r * w,
                                                       lo + (r + 1) * w))
        if m == 2:
            assert [(c < inner).sum() for c in cols] == [2048, 2048]
            assert [((c >= 2 * inner) & (c < 2 * inner + 2 * N)).sum()
                    for c in cols] == [64, 64]
    with pytest.raises(ValueError, match="needs the model's config"):
        port.local_index(mesh, name, spec, leaf.shape)


def test_shards_round_trip_and_in_proj_shape(mp_job):
    """shard_params -> gather_params gives reduced zamba2's masters back
    bitwise on every mesh, in_proj's shard is the reference's shard shape
    (its columns / |model|), and on (data 2, model 2) the shards of a
    model line hold different in_proj columns while the data line's hold
    the same."""
    width = 2 * 128 + 2 * 8 + 8
    for r, i in enumerate(mp_job["info"]):
        for mesh_name, m in (("data1_model2", 2), ("data2_model2", 2),
                             ("model4", 4)):
            assert i[mesh_name]["roundtrip"], (r, mesh_name)
            assert i[mesh_name]["in_proj"] == [2, 64, width // m]
    ranks = mp_job["ranks"]
    a = [ranks[r]["in_proj@data2_model2"] for r in range(4)]
    assert not np.array_equal(a[0], a[1])
    np.testing.assert_array_equal(a[0], a[2])


@pytest.mark.parametrize("name", JAX_CASES)
def test_step_matches_the_jax_package(mp_job, name):
    """The case's step on (data 2, model 2), its shards loaded from the JAX
    package's parameters through params_from_numpy(mesh=) (in_proj by
    segment and head), against the JAX package's one-device loss and
    jax.grad: loss within 3e-5, gathered gradients within 1e-4 of each
    leaf's largest. The only check that in_proj's segment order (z, x, B,
    C, dt) is the reference's. The cases: reduced zamba2 sparse (the
    reference's jnp gather path), rwkv6, whisper."""
    jloss, jgrads = mp_job["jax"][name]
    assert sorted(jgrads) == sorted(one_process(name)[1])
    for rec in mp_job["ranks"]:
        assert abs(float(rec[f"jax_{name}/loss"]) - jloss) <= LOSS_TOL
        assert grad_gap(rec, f"jax_{name}", jgrads) <= GRAD_TOL


@pytest.mark.parametrize("fault,name", FAULT_CASES)
def test_planted_faults_miss_a_gate(mp_job, fault, name):
    """Each planted fault moves the loss past 3e-5, a gathered gradient past
    1e-4 of its leaf's largest, or a replicated leaf's gradient apart
    across the model line: in_proj's reference shard read as segments,
    the whole-width norm's statistic of the rank's slice alone, or summed
    over the line in the forward only, the replicated leaves used in part
    without copy_to_model."""
    loss, grads = one_process(name)
    key = f"planted_{fault}/{name}@data2_model2"
    r0, r1 = mp_job["ranks"][:2]
    apart = any(not np.array_equal(r0[k], r1[k])
                for k in r0 if k.startswith(f"{key}/local/"))
    assert abs(float(r0[f"{key}/loss"]) - loss) > LOSS_TOL or \
        grad_gap(r0, key, grads) > 10 * GRAD_TOL or apart, (fault, name)


def test_trainer_one_plan_and_checkpoints(mp_job):
    """zamba2's three-phase Trainer on (data 2, model 2): one plan on every
    rank, the one-process Trainer's; dense losses within 3e-5 of it. Its
    checkpoint (written by process 0 with every sharded leaf gathered,
    in_proj's columns in the reference's order) restores in one process
    onto the gathered masters, plan and all; a one-process checkpoint
    restores on the mesh onto each rank's shards, moments included,
    bitwise; a restore that cuts in_proj contiguously misses that."""
    from repro_torch.core.spion import plan_digest
    runs = [i["trainer"] for i in mp_job["info"]]
    assert all(r["phase"] == "sparse" for r in runs)
    assert len({r["digest"] for r in runs}) == 1
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert runs[0]["shards"]["layers.mamba.in_proj"] == [2, 64, 140]
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
        bad = rec["planted_restore/p/layers.mamba.in_proj"]
        assert not np.array_equal(bad, state["p"]["layers.mamba.in_proj"])


def test_rwkv6_bf16_step_matches_the_jax_package():
    """ROADMAP.md §C, C3: reduced rwkv6-7b's bf16 train step in one
    process. The step casts the fp32 masters of ndim >= 2 to bf16, w_lora_a
    and w_lora_b among them, and the reference's fp32 @ bf16 promotes to
    fp32 (src/repro/models/rwkv.py:131); the port's matmul of an fp32 and a
    bf16 tensor raised instead. Now the LoRA runs in fp32 and the step's
    loss is within 6e-2 (the bf16 forward tolerance) of the JAX package's
    on the same masters, every gradient within 6e-2 of its leaf's
    largest."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models.registry import build as jbuild
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.models.layers import ParamTree
    jc, tc = jget("rwkv6-7b").reduced(), get_config("rwkv6-7b").reduced()
    assert jc.dtype == tc.dtype == "bfloat16"

    def cast(p, dtype):
        return jax.tree_util.tree_map(
            lambda x: x.astype(dtype)
            if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
    masters = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.ndim >= 2 else x,
        jbuild(jc).init(jax.random.key(0)))
    toks = np.random.default_rng(3).integers(0, 128, (2, 65)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jbuild(jc).loss(cast(p, jnp.bfloat16),
                                  {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True)(masters)
    tp = ParamTree(dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, masters), tc, "cpu").items()),
        trainable=True)
    loss, grads = make_loss_and_grads(tc)(
        tp, {k: torch.as_tensor(v) for k, v in b.items()})
    assert abs(float(loss) - float(jloss)) <= 6e-2
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        name, g = ".".join(k.key for k in path), np.asarray(g)
        gap = np.abs(grads[name].numpy() - g).max() / np.abs(g).max()
        assert gap <= 6e-2, (name, gap)
