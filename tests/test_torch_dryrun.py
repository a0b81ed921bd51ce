"""Port parity, the dry run (`repro_torch.launch.dryrun`) against the JAX
package's (`repro.launch.dryrun`).

  - In this process, on every `ARCH_IDS` config x `SHAPES` entry x the
    production meshes (single, multi-pod, 'seq' 2 and 4): the meshes'
    shapes and axes, `choose_n_micro`, `_spion_layers`, the skip reasons,
    `spion_table_pspecs`, `kernel_pspecs` and `train_shardings`' specs
    equal the reference's (its functions read only `mesh.shape` and
    `axis_names`, so a port Mesh without groups serves both; the
    reference's meshes are taken with `make_mesh` stubbed, since 256
    devices do not exist here).
  - The kernels' work (kernels/work.py) against a brute-force count of
    the kept (q, k) pairs from a dense mask.
  - A dense one-rank cell: the meta pass's FLOPs bitwise
    FlopCounterMode's on the same step with real CPU tensors, its peak
    within 1% of MemTracker's on the real tensors.
  - Three subprocesses: the reference's two tiny `dryrun_cell` cases
    (tests/test_sharded_attention.py, tests/test_seq_parallel.py), the
    port's cells in a fake world (those two, one reduced cell a family on
    a train, a prefill and a decode shape, a scan width |model| does not
    divide and `main`'s exit code, the meta pass's collectives), and one
    4-rank gloo job whose real steps record the same collectives as the meta pass.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = ("single", "multi", "seq2", "seq4")


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return ARCH_IDS


def _ref_dryrun():
    """The reference's dryrun module. Importing it sets XLA_FLAGS to 512
    host devices (before any jax import, in its own process); here jax is
    initialised first and the environment is restored, so no other test
    in this process sees it."""
    import jax
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _port_mesh(kind):
    """The port's production mesh, without process groups."""
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=kind == "multi",
                                seq={"seq2": 2, "seq4": 4}.get(kind, 1))


def _ref_mesh(kind, monkeypatch):
    """The reference's production mesh as (shape, axes), make_mesh
    stubbed."""
    import repro.launch.mesh as jmesh
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    return jmesh.make_production_mesh(
        multi_pod=kind == "multi", seq={"seq2": 2, "seq4": 4}.get(kind, 1))


def _tuples(tree, sep="."):
    """{path joined by `sep`: spec tuple} of a JAX tree of PartitionSpecs
    (None kept)."""
    import jax
    from jax.sharding import PartitionSpec as P
    got = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)[0]
    return {sep.join(str(getattr(k, "key", k)) for k in path):
            None if leaf is None else tuple(leaf) for path, leaf in got}


_CACHE = {}


def _arch_state(arch):
    """Per-arch inputs shared by the mesh cases (computed once): both
    configs, the reference's param tree (ShapeDtypeStructs) and the port's
    (meta), and both dry-run tables at four row blocks."""
    if arch in _CACHE:
        return _CACHE[arch]
    import jax
    from repro.configs import get_config as jget
    from repro.launch import steps as jsteps
    from repro.models.registry import build as jbuild
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models.registry import params_specs
    jc, cfg = jget(arch), get_config(arch)
    jparams = jax.eval_shape(lambda: jbuild(jc).init(jax.random.key(0)))
    seq = 4 * cfg.spion.block_size
    ref = _ref_dryrun()
    layers = ref._spion_layers(jc)
    st = dict(jc=jc, cfg=cfg, jparams=jparams,
              params=params_specs(cfg),
              jtables=jsteps.spion_dryrun_tables(jc, seq, layers),
              tables=steps.spion_dryrun_tables(cfg, seq, layers))
    _CACHE[arch] = st
    return st


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", _arch_ids())
def test_cell_decisions_match_reference(arch, shape_name, mesh_kind,
                                        monkeypatch, tmp_path):
    """The production mesh, choose_n_micro, _spion_layers, the skip
    records, spion_table_pspecs, kernel_pspecs and train_shardings' specs
    of one (config, shape, mesh) equal the reference's."""
    import repro.launch.steps as jsteps
    from repro.configs import SHAPES as JSHAPES
    from repro.distributed.sharding import kernel_pspecs as jkernel_pspecs
    from repro.models.registry import input_specs as jinput
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import kernel_pspecs
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.registry import input_specs
    ref = _ref_dryrun()
    st = _arch_state(arch)
    jc, cfg = st["jc"], st["cfg"]
    shape = SHAPES[shape_name]
    mesh = _port_mesh(mesh_kind)
    assert (tuple(mesh.devices.shape), mesh.axis_names) == \
        _ref_mesh(mesh_kind, monkeypatch)
    assert mesh.size == (512 if mesh_kind == "multi" else 256)
    assert dryrun.FSDP_PARAM_THRESHOLD == ref.FSDP_PARAM_THRESHOLD
    n = dryrun.choose_n_micro(cfg, shape, mesh)
    assert n == ref.choose_n_micro(jc, JSHAPES[shape_name], mesh)
    assert dryrun._spion_layers(cfg) == ref._spion_layers(jc)
    # the skip records (neither traces nor compiles a skipped cell)
    for mode in ("dense", "sparse"):
        d_ref, d_port = tmp_path / "ref", tmp_path / "port"
        d_ref.mkdir(exist_ok=True)
        d_port.mkdir(exist_ok=True)
        skipped = bool(jc.skip_reason(shape_name)) or (
            mode == "sparse" and (not jc.spion.enabled
                                  or shape.kind == "decode"))
        assert skipped == (bool(cfg.skip_reason(shape_name)) or (
            mode == "sparse" and (not cfg.spion.enabled
                                  or shape.kind == "decode")))
        if skipped:
            want = ref.run_cell(arch, shape_name, mesh_kind == "multi", mode,
                                str(d_ref), verbose=False)
            got = dryrun.run_cell(arch, shape_name, mesh_kind == "multi",
                                  mode, str(d_port), verbose=False)
            assert got == want
    # the specs
    assert steps.spion_table_pspecs(st["tables"]) == \
        _tuples(jsteps.spion_table_pspecs(st["jtables"]))
    B = max(shape.global_batch // n, 1)
    assert kernel_pspecs(mesh, B, cfg.num_kv_heads) == tuple(
        tuple(s) for s in jkernel_pspecs(mesh, B, jc.num_kv_heads))
    mine, theirs = input_specs(cfg, shape), jinput(jc, JSHAPES[shape_name])
    batch = mine.get("batch", {"tokens": mine.get("tokens")})
    jbatch = theirs.get("batch", {"tokens": theirs.get("tokens")})
    monkeypatch.setattr(jsteps, "_ns", lambda m, s: s)
    for zero1 in (True, False):
        psp, osp, bsp = steps.train_shardings(cfg, mesh, st["params"], None,
                                              batch, zero1=zero1)
        jpsp, josp, jbsp = jsteps.train_shardings(
            jc, mesh, st["jparams"], None, jbatch, zero1=zero1)
        assert psp == _tuples(jpsp)
        assert {"mu": osp["mu"], "nu": osp["nu"]} == \
            {"mu": _tuples(josp["mu"]), "nu": _tuples(josp["nu"])}
        assert osp["count"] == tuple(josp["count"])
        assert bsp == _tuples(jbsp)


def test_production_mesh_refuses_seq_3():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="must divide the data axis"):
        make_production_mesh(seq=3)


# ---------------------------------------------------------------------------
# the kernels' work against a brute-force count
# ---------------------------------------------------------------------------

def _brute_pairs(col, nv, block, causal, window, offsets, transposed):
    """(pairs, tiles, distinct) from a dense mask of every listed tile."""
    row0, col0 = offsets
    pairs, tiles, blocks = 0, 0, set()
    p = np.arange(block)
    for r in range(len(nv)):
        for c in col[r, :nv[r]]:
            rb, cb = (int(c), r) if transposed else (r, int(c))
            qpos = (rb + row0) * block + p[:, None]
            kpos = (cb + col0) * block + p[None, :]
            ok = np.ones((block, block), dtype=bool)
            if causal:
                ok &= qpos >= kpos
            if window:
                ok &= qpos - kpos < window
            if ok.any():
                pairs += int(ok.sum())
                tiles += 1
                blocks.add(int(c))
    return pairs, tiles, len(blocks)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", ["plain", "causal", "window", "offsets"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_work_matches_brute_force(seed, case, transposed):
    """masked_pairs (and through it the three kernels' FLOPs) equals the
    dense-mask count on seeded tables with clamped padding (repeated ids
    past nvalid), out-of-range ids (negative, past the blocks) and empty
    rows."""
    from repro_torch.kernels import work
    rng = np.random.default_rng(seed)
    nrb, K, block = 12, 5, 16
    col = rng.integers(-2, nrb + 3, size=(nrb, K)).astype(np.int32)
    nv = rng.integers(0, K + 1, size=nrb).astype(np.int32)
    for r in range(nrb):              # clamped padding past the prefix
        if 0 < nv[r] < K:
            col[r, nv[r]:] = col[r, nv[r] - 1]
    causal = case in ("causal", "window", "offsets")
    window = 40 if case in ("window", "offsets") else None
    offsets = (3, 1) if case == "offsets" else (0, 0)
    kw = dict(causal=causal, sliding_window=window, offsets=offsets)
    got = work.masked_pairs(torch.from_numpy(col), torch.from_numpy(nv),
                            block, kw, transposed=transposed)
    assert got == _brute_pairs(col, nv, block, causal, window, offsets,
                               transposed)
    q = torch.zeros(2, 3, nrb * block, 16, dtype=torch.bfloat16)
    fn = work.dkv_work if transposed else work.fwd_work
    flops, _ = fn(q, q[:, 0], torch.from_numpy(col), torch.from_numpy(nv),
                  block=block, **kw)
    assert flops == (8 if transposed else 4) * 2 * 3 * got[0] * 16


def test_kernel_work_refuses_fake_tables_without_values():
    """A meta table (no values) raises: the count never falls back to
    shapes, and the dry run keeps its tables real (work.table_device)."""
    from repro_torch.kernels import work
    with pytest.raises(ValueError, match="no host values"):
        work.masked_pairs(torch.empty(4, 2, dtype=torch.int32,
                                      device="meta"),
                          torch.empty(4, dtype=torch.int32, device="meta"),
                          16, {})


# ---------------------------------------------------------------------------
# a one-rank cell: the meta pass against real CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_one_rank_dense_cell_matches_real_step(kind):
    """The meta pass's FLOPs equal FlopCounterMode's on the same step with
    real CPU tensors, bitwise; its MemTracker peak is within 1% of the
    real step's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeSpec("tiny", 256, 2, kind)
    meta = dryrun.build_cell(cfg, shape, None, "dense",
                             device=torch.device("meta"))
    fake = dryrun.trace_cell(*meta)
    real = dryrun.build_cell(cfg, shape, None, "dense",
                             device=torch.device("cpu"),
                             make=dryrun.random_inputs(cfg))
    done = dryrun.trace_cell(*real)
    assert fake["flops"].get_total_flops() == done["flops"].get_total_flops()
    assert fake["flops"].get_total_flops() > 0
    a, b = dryrun.analyse_memory(fake), dryrun.analyse_memory(done)
    assert a["inputs_bytes"] == b["inputs_bytes"]
    assert abs(a["total_bytes"] - b["total_bytes"]) <= 0.01 * b["total_bytes"]
    assert dryrun.cost_of(fake)["census"] == dryrun.cost_of(done)["census"]


# ---------------------------------------------------------------------------
# the subprocess cells
# ---------------------------------------------------------------------------

_TINY = """
import dataclasses
from repro{p}.configs import get_config
def tiny_lra():
    cfg = get_config("spion-lra").reduced()
    return cfg.replace(num_heads=4, num_kv_heads=2, head_dim=16,
                       spion=dataclasses.replace(cfg.spion, block_size=16))
"""

REF_CELLS = _TINY.format(p="") + """
import json, tempfile
import jax
jax.devices()
from repro.configs.base import SHAPES, ShapeSpec
from repro.launch import dryrun
from repro.launch.mesh import make_mesh, make_seq_mesh
out = {}
with tempfile.TemporaryDirectory() as d:
    SHAPES["tiny_train"] = ShapeSpec("tiny_train", 64, 4, "train")
    out["sharded"] = dryrun.run_cell(
        "spion-lra", "tiny_train", False, "sparse", d, verbose=False,
        cfg_override=tiny_lra(), skip_costs=True,
        mesh_override=make_mesh((2, 2), ("data", "model")))
    SHAPES["tiny_train"] = ShapeSpec("tiny_train", 128, 4, "train")
    out["seq"] = dryrun.run_cell(
        "spion-lra", "tiny_train", False, "sparse", d, verbose=False,
        cfg_override=tiny_lra(), skip_costs=True,
        mesh_override=make_seq_mesh(2, 2))
print("RESULT " + json.dumps(out))
"""

# the gloo job's and the meta pass's collective cells: (arch, shape)
COLL_CELLS = """
def coll_cells():
    from repro_torch.configs.base import ShapeSpec
    lra = tiny_lra()
    qwen = get_config("qwen2-7b").reduced()
    return {"lra_train": (lra, ShapeSpec("c_train", 64, 4, "train"),
                          "dense"),
            "qwen_decode": (qwen, ShapeSpec("c_decode", 64, 4, "decode"),
                            "dense")}
"""

PORT_CELLS = _TINY.format(p="_torch") + COLL_CELLS + """
import json, tempfile
import numpy as np
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

def mesh(shape, axes):
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)

out = {}
with tempfile.TemporaryDirectory() as d:
    SHAPES["tiny_train"] = ShapeSpec("tiny_train", 64, 4, "train")
    out["sharded"] = dryrun.run_cell(
        "spion-lra", "tiny_train", False, "sparse", d, verbose=False,
        cfg_override=tiny_lra(), skip_costs=True,
        mesh_override=mesh((2, 2), ("data", "model")))
    SHAPES["tiny_train"] = ShapeSpec("tiny_train", 128, 4, "train")
    out["seq"] = dryrun.run_cell(
        "spion-lra", "tiny_train", False, "sparse", d, verbose=False,
        cfg_override=tiny_lra(), skip_costs=True,
        mesh_override=mesh((2, 2), ("seq", "data")))
    # one reduced cell a family, the kernels where SPION applies
    for kind in ("train", "prefill", "decode"):
        SHAPES["f_" + kind] = ShapeSpec("f_" + kind, 512, 8, kind)
    fams = {}
    for arch in ("spion-lra", "qwen2-7b", "mixtral-8x7b", "internvl2-2b",
                 "zamba2-1.2b", "rwkv6-7b", "whisper-tiny"):
        cfg = get_config(arch).reduced()
        cfg = cfg.replace(spion=dataclasses.replace(cfg.spion,
                                                    block_size=16))
        for kind in ("train", "prefill", "decode"):
            mode = "sparse" if cfg.spion.enabled and kind != "decode" \\
                else "dense"
            rec = dryrun.run_cell(arch, "f_" + kind, False, mode, d,
                                  verbose=False, cfg_override=cfg,
                                  mesh_override=mesh((2, 2),
                                                     ("data", "model")))
            fams[f"{arch} {kind} {mode}"] = {
                k: rec.get(k) for k in ("status", "error", "chips",
                                        "per_device", "memory")}
    out["families"] = fams
    # a scan width |model| does not divide: the reference's fallback
    rw = get_config("rwkv6-7b").reduced()
    out["scan_width"] = dryrun.run_cell(
        "rwkv6-7b", "f_train", False, "dense", d, verbose=False,
        cfg_override=rw, mesh_override=mesh((1, 8), ("data", "model")))
    dryrun.get_config = lambda arch: rw
    try:
        dryrun.main(["--arch", "rwkv6-7b", "--shape", "train_4k",
                     "--out", d])
        out["main_exit"] = 0
    except SystemExit as e:
        out["main_exit"] = e.code
    # the meta pass's collectives of rank 0 (the gloo job's cells)
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch import hlo
    colls, counted = {}, {}
    dryrun.join_fake_world(4)
    m = mesh((2, 2), ("data", "model")).build_groups()
    for name, (cfg, shape, mode) in coll_cells().items():
        cell = dryrun.build_cell(cfg, shape, m, mode)
        with CommDebugMode() as cdm:
            recs = dryrun.trace_cell(*cell)["records"]
        colls[name] = dict(hlo.collective_stats(recs),
                           kinds=[r["kind"] for r in recs
                                  if r["kind"] and not r["done"]])
        counted[name] = cdm.get_total_counts()
    out["collectives"] = colls
    out["comm_debug"] = counted
print("RESULT " + json.dumps(out, default=str))
"""

GLOO_JOB = _TINY.format(p="_torch") + COLL_CELLS + """
import json, os
from repro_torch.distributed import runtime
pid, n, port = (int(os.environ[k]) for k in ("MP_PID", "MP_NPROC", "MP_PORT"))
runtime.initialize(f"localhost:{port}", n, pid)
import torch
from repro_torch.launch import dryrun, hlo
from repro_torch.launch.mesh import make_mesh
m = make_mesh((2, 2), ("data", "model"))
out = {}
for name, (cfg, shape, mode) in coll_cells().items():
    step, args, _ = dryrun.build_cell(
        cfg, shape, m, mode, device=torch.device("cpu"), rank=pid,
        make=dryrun.random_inputs(cfg, seed=pid))
    with hlo.OpRecorder() as rec:
        step(*args)
    out[name] = dict(hlo.collective_stats(rec.records),
                     kinds=[r["kind"] for r in rec.records
                            if r["kind"] and not r["done"]])
print("RESULT " + json.dumps(out))
runtime.shutdown(0)
"""


def _run(code, env_extra=None, timeout=600):
    env = {"PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           **(env_extra or {})}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return _result(r.stdout)


def _result(stdout):
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, stdout[-2000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def ref_cells():
    return _run(REF_CELLS, {"XLA_FLAGS":
                            "--xla_force_host_platform_device_count=4"})


@pytest.fixture(scope="module")
def port_cells():
    return _run(PORT_CELLS)


_KEYS = ("status", "sparse_kernel", "seq_sharded", "n_micro", "params",
         "active_params", "chips")


@pytest.mark.parametrize("cell", ["sharded", "seq"])
def test_tiny_cells_match_reference(cell, ref_cells, port_cells):
    """The reference's two dryrun_cell cases (reduced spion-lra tiny_train
    sparse on (data 2, model 2) and on (seq 2, data 2)): the port's record
    has the reference's status, sparse_kernel, seq_sharded (active, halo,
    detail), n_micro, params, active_params and chips, and the rank and
    layout the port adds."""
    want, got = ref_cells[cell], port_cells[cell]
    assert want["status"] == "ok", want
    assert {k: got.get(k) for k in _KEYS} == {k: want.get(k) for k in _KEYS}
    assert got["rank"] == 0 and got["layout"]["moments"] == "param_pspecs"
    assert got["memory"]["per_device_gb"] > 0


FAMILY_CELLS = [f"{a} {k}" for a in (
    "spion-lra", "qwen2-7b", "mixtral-8x7b", "internvl2-2b", "zamba2-1.2b",
    "rwkv6-7b", "whisper-tiny") for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("cell", FAMILY_CELLS)
def test_family_cell_is_ok(cell, port_cells):
    """One reduced cell a family on a train, a prefill and a decode shape
    on (data 2, model 2): ok, with memory and costs (the kernels' ops
    counted where SPION applies)."""
    (key, rec), = [(k, v) for k, v in port_cells["families"].items()
                   if k.rsplit(" ", 1)[0] == cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 4
    assert rec["per_device"]["flops"] > 0
    assert rec["memory"]["per_device_gb"] > 0
    assert rec["per_device"]["coll_bytes"] > 0
    calls = rec["per_device"]["census"]["custom-call"]
    assert (calls > 0) == key.endswith("sparse"), (key, calls)


def test_scan_width_refused(port_cells):
    """A scan width |model| does not divide (reduced rwkv6-7b's 4 heads on
    model 8) traces the reference's fallback: the record is ok, with the
    model line's all-gathers of the rank's r, k and v columns among its
    collectives (bytes > 0), and main exits 0 on the cell."""
    rec = port_cells["scan_width"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 8
    # (data 1, model 8): every collective is the model line's
    assert rec["per_device"]["coll_by_kind"].get("all-gather", 0) > 0, \
        rec["per_device"]["coll_by_kind"]
    assert port_cells["main_exit"] == 0


def test_collective_counts_match_comm_debug_mode(port_cells):
    """torch's CommDebugMode counts the same c10d ops in the meta pass as
    the records do (it records no operand bytes, which is why the dry run
    keeps its own records)."""
    for name, stats in port_cells["collectives"].items():
        assert sum(stats["count"].values()) == \
            port_cells["comm_debug"][name] > 0, name


def test_fake_collectives_match_gloo_job(port_cells):
    """One 4-rank gloo job on (data 2, model 2): rank 0's real steps
    (reduced spion-lra's dense train step, reduced qwen2-7b's decode)
    record the same collective kinds, counts and operand bytes, in the
    same order, as the meta pass of rank 0."""
    from conftest import run_distributed_case
    outs = run_distributed_case(GLOO_JOB, nproc=4,
                                env_extra={"OMP_NUM_THREADS": "1"})
    real = _result(outs[0])
    fake = port_cells["collectives"]
    assert sorted(real) == sorted(fake) == ["lra_train", "qwen_decode"]
    for name in real:
        assert real[name] == fake[name], name
        assert real[name]["total_bytes"] > 0
