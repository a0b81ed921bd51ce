"""Port parity, the sequence-parallel sparse attention (DESIGN.md §10):
the sharding decisions against the reference's (`kernel_seq_axis` and its
reasons, `kernel_shard_axes`, the spec layout), the dry-run patterns
bitwise, and `kernels/sharded.sharded_fused_attention` over real
`torch.distributed` CPU processes (gloo; the kernels' plain versions) with
2 and 4 ranks against the reference's unsharded fused op (interpret mode):
o within 3e-5, dq, dk, dv within 1e-3. Cases: non-causal, causal and a
window of 48, the plan's transposed tables and the plan-less local ones,
a (seq 2, data 2) mesh held against the reference's own
`sharded_fused_attention` (a subprocess with 4 host devices, as
tests/test_seq_parallel.py runs it), the too-wide fallback (a warning on
the coordinator alone, the batch sharded) and the no-axis error."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

from conftest import run_distributed_case, run_subprocess_case

MP_ENV = {"OMP_NUM_THREADS": "1"}

# the cases, built alike in the test, the workers and the JAX subprocess
CASE_SRC = """
import numpy as np
S, BLOCK, HD = 128, 16, 16
# name: (causal, sliding_window, H, KV, plan tables, batch, too wide)
CASES = {
    "enc_plan": (False, None, 4, 4, True, 2, False),
    "causal_planless": (True, None, 4, 2, False, 2, False),
    "window_plan": (True, 48, 2, 2, True, 2, False),
    "enc_planless": (False, None, 4, 2, False, 2, False),
    "window_planless": (True, 48, 4, 4, False, 2, False),
    "wide": (False, None, 2, 1, True, 4, True),
}


def case_inputs(name):
    causal, sw, H, KV, plan, B, wide = CASES[name]
    n = S // BLOCK
    rng = np.random.default_rng(sum(map(ord, name)))
    mask = np.zeros((n, n), bool)
    if wide:                         # a global column: halo (n - 1, 0)
        np.fill_diagonal(mask, True)
        mask[:, 0] = True
    else:                            # a near-diagonal band, extent <= 2
        for r in range(n):
            for c in range(max(r - 2, 0), min(r + 3, n)):
                mask[r, c] = rng.random() < 0.7
            mask[r, r] = True
    if causal:
        mask = np.tril(mask)
    G = H // KV
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(mask=mask, q=f(B, KV, G, S, HD), k=f(B, KV, S, HD),
                v=f(B, KV, S, HD), g=f(B, KV, G, S, HD))
"""
exec(CASE_SRC)

# (mesh, case) runs of each job size
RUNS = {2: [("seq2", "enc_plan"), ("seq2", "causal_planless"),
            ("seq2", "window_plan")],
        4: [("seq4", "enc_planless"), ("seq4", "window_planless"),
            ("seq2data2", "enc_plan"), ("seq2data2", "wide")]}
MESHES = {"seq2": (2, 1), "seq4": (4, 1), "seq2data2": (2, 2)}

WORKER = """
import os, json, warnings
import torch
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
from repro_torch.core.sparse_attention import (bcsr_from_blockmask,
                                               build_sparsity_plan)
from repro_torch.distributed.sharding import (data_axes,
                                              kernel_pspecs_from_axes,
                                              local_slices)
from repro_torch.kernels.sharded import sharded_fused_attention
from repro_torch.launch.mesh import make_seq_mesh
RUNS = json.loads(os.environ["MP_RUNS"])
MESHES = json.loads(os.environ["MP_MESHES"])
meshes = {m: make_seq_mesh(*MESHES[m]) for m in dict.fromkeys(
    m for m, _ in RUNS)}
for mname, case in RUNS:
    mesh = meshes[mname]
    causal, sw, H, KV, plan, B, wide = CASES[case]
    x = case_inputs(case)
    b = bcsr_from_blockmask(x["mask"], BLOCK)
    p = build_sparsity_plan(b.col_idx, b.nvalid, BLOCK)
    qs, ks, _ = kernel_pspecs_from_axes(data_axes(mesh), None, "seq")
    t = {n: torch.from_numpy(x[n][local_slices(mesh, qs if n in "qg" else ks,
                                               x[n].shape)]).clone()
         for n in ("q", "k", "v", "g")}
    for n in "qkv":
        t[n].requires_grad_()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        o = sharded_fused_attention(
            mesh, t["q"], t["k"], t["v"], b.col_idx.clamp(min=0).int(),
            b.nvalid.int(), block=BLOCK, causal=causal, sliding_window=sw,
            row_idx=p.tables["row_idx"][0] if plan else None,
            nvalid_t=p.tables["nvalid_t"][0] if plan else None,
            halo=tuple(p.stats["halo"]))
    (o * t["g"]).sum().backward()
    np.savez(os.path.join(OUT, f"{mname}-{case}-r{pid}.npz"),
             o=o.detach().numpy(), dq=t["q"].grad.numpy(),
             dk=t["k"].grad.numpy(), dv=t["v"].grad.numpy(),
             warned=np.asarray([any("falls back" in str(m.message)
                                    for m in w)]))
print("SEQ_OK")
runtime.shutdown(0)
"""

_REF = {}


def reference(case):
    """The JAX package's unsharded fused op (interpret mode) on the whole
    case: (o, dq, dk, dv) in the (B, KV, G, S, hd) / (B, KV, S, hd)
    layouts."""
    if case in _REF:
        return _REF[case]
    import jax
    import jax.numpy as jnp
    from repro.core.sparse_attention import (bcsr_from_blockmask,
                                             build_sparsity_plan)
    from repro.kernels.block_sparse_attn import fused_block_sparse_attention
    causal, sw, H, KV, plan, B, wide = CASES[case]
    x = case_inputs(case)
    b = bcsr_from_blockmask(x["mask"], BLOCK)
    p = build_sparsity_plan(b.col_idx, b.nvalid, BLOCK)
    G = H // KV
    kw = dict(block=BLOCK, causal=causal, sliding_window=sw, interpret=True)
    if plan:
        kw.update(row_idx=p.tables["row_idx"][0],
                  nvalid_t=p.tables["nvalid_t"][0])

    def f(q, k, v):
        return fused_block_sparse_attention(
            q.reshape(B * KV, G, S, HD), k.reshape(B * KV, S, HD),
            v.reshape(B * KV, S, HD), jnp.maximum(b.col_idx, 0), b.nvalid,
            **kw).reshape(B, KV, G, S, HD)
    o, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    _REF[case] = tuple(np.asarray(a) for a in (o, *vjp(jnp.asarray(x["g"]))))
    return _REF[case]


def assemble(tmp_path, mname, case, nproc):
    """The ranks' shards of o, dq, dk, dv placed into whole arrays, and
    which ranks warned."""
    from repro_torch.distributed.sharding import (data_axes,
                                                  kernel_pspecs_from_axes,
                                                  local_slices)
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(np.arange(nproc).reshape(MESHES[mname]), ("seq", "data"))
    qs, ks, _ = kernel_pspecs_from_axes(data_axes(mesh), None, "seq")
    x = case_inputs(case)
    full = {n: np.full_like(x[src], np.nan)
            for n, src in (("o", "q"), ("dq", "q"), ("dk", "k"), ("dv", "v"))}
    warned = []
    for r in range(nproc):
        got = np.load(tmp_path / f"{mname}-{case}-r{r}.npz")
        for n in full:
            spec = qs if n in ("o", "dq") else ks
            full[n][local_slices(mesh, spec, full[n].shape, r)] = got[n]
        warned.append(bool(got["warned"][0]))
    return full, warned


@pytest.mark.parametrize("nproc", [2, 4])
def test_seq_parallel_op_matches_reference(nproc, tmp_path):
    outs = run_distributed_case(
        CASE_SRC + WORKER, nproc=nproc, timeout=240, env_extra=dict(
            MP_ENV, MP_OUT=str(tmp_path), MP_RUNS=json.dumps(RUNS[nproc]),
            MP_MESHES=json.dumps(MESHES)))
    assert all("SEQ_OK" in o for o in outs)
    for mname, case in RUNS[nproc]:
        full, warned = assemble(tmp_path, mname, case, nproc)
        want = reference(case)
        tag = f"{mname} {case}"
        np.testing.assert_allclose(full["o"], want[0], atol=3e-5, rtol=0,
                                   err_msg=tag)
        for n, w in zip(("dq", "dk", "dv"), want[1:]):
            np.testing.assert_allclose(full[n], w, atol=1e-3, rtol=0,
                                       err_msg=f"{tag} {n}")
        # the too-wide pattern falls back loudly, once, on the coordinator
        assert warned == [case == "wide"] + [False] * (nproc - 1), tag
        if mname == "seq2data2" and case == "enc_plan":
            np.savez(tmp_path / "port_seq2data2.npz", **full)
    if nproc == 4:
        ref_sharded = reference_sharded(tmp_path)
        port = dict(np.load(tmp_path / "port_seq2data2.npz"))
        np.testing.assert_allclose(port["o"], ref_sharded["o"], atol=3e-5,
                                   rtol=0)
        for n in ("dq", "dk", "dv"):
            np.testing.assert_allclose(port[n], ref_sharded[n], atol=1e-3,
                                       rtol=0, err_msg=n)


JAX_SHARDED = """
import jax, jax.numpy as jnp
from repro.core.sparse_attention import bcsr_from_blockmask, build_sparsity_plan
from repro.distributed.sharding import mesh_context
from repro.kernels.sharded import sharded_fused_attention
from repro.launch.mesh import make_seq_mesh
mesh = make_seq_mesh(2, 2)
x = case_inputs("enc_plan")
b = bcsr_from_blockmask(x["mask"], BLOCK)
p = build_sparsity_plan(b.col_idx, b.nvalid, BLOCK, ncb=S // BLOCK)
def f(q, k, v):
    return sharded_fused_attention(
        mesh, q, k, v, jnp.maximum(b.col_idx, 0), b.nvalid, block=BLOCK,
        interpret=True, row_idx=p.tables["row_idx"][0],
        nvalid_t=p.tables["nvalid_t"][0], halo=tuple(p.stats["halo"]))
with mesh_context(mesh):
    o, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(x["g"]))
np.savez(OUT, o=np.asarray(o), dq=np.asarray(dq), dk=np.asarray(dk),
         dv=np.asarray(dv))
print("OK")
"""


def reference_sharded(tmp_path):
    """The reference's sharded_fused_attention on a (seq 2, data 2) mesh of
    4 host devices, for the case "enc_plan"."""
    out = tmp_path / "jax_seq2data2.npz"
    code = CASE_SRC + f"OUT = {str(out)!r}\n" + JAX_SHARDED
    assert "OK" in run_subprocess_case(code, devices=4)
    return dict(np.load(out))


# -- decisions ------------------------------------------------------------------

def _meshes():
    from repro_torch.launch.mesh import Mesh
    shapes = [((1,), ("data",)), ((2,), ("seq",)), ((2, 2), ("seq", "data")),
              ((4, 1), ("seq", "data")), ((2, 3), ("pod", "data")),
              ((2, 2, 2), ("pod", "seq", "data")),
              ((2, 2), ("data", "model")), ((4,), ("model",))]
    return [Mesh(np.arange(int(np.prod(s))).reshape(s), a) for s, a in shapes]


def test_kernel_seq_axis_is_the_references():
    from repro.distributed.sharding import kernel_seq_axis as jref
    from repro_torch.distributed.sharding import kernel_seq_axis
    halos = [None, (0, 0), (1, 0), (0, 1), (1, 1), (2, 1), (1, 2), (2, 2),
             (3, 3), (4, 3), (5, 0), (0, 5), (8, 8), (7, 0)]
    n = 0
    for mesh in _meshes():
        for nrb in (None, 4, 6, 7, 8, 16):
            for halo in halos:
                assert kernel_seq_axis(mesh, nrb, halo) == \
                    jref(mesh, nrb, halo), (mesh, nrb, halo)
                n += 1
    assert n == 8 * 6 * 14


def test_kernel_shard_axes_and_specs_are_the_references():
    from repro.distributed.sharding import kernel_pspecs_from_axes as jspecs
    from repro.distributed.sharding import kernel_shard_axes as jref
    from repro_torch.distributed.sharding import (kernel_pspecs_from_axes,
                                                  kernel_shard_axes)
    for mesh in _meshes():
        for batch in (1, 2, 3, 4, 6, 8, 12):
            for kv in (1, 2, 3, 4):
                got = kernel_shard_axes(mesh, batch, kv)
                assert got == jref(mesh, batch, kv), (mesh, batch, kv)
                for seq_ax in (None, "seq"):
                    # PartitionSpec writes a 1-tuple of axes as the name
                    want = [tuple(e[0] if isinstance(e, tuple) and
                                  len(e) == 1 else e for e in spec)
                            for spec in jspecs(*got, seq_ax)]
                    mine = [tuple(e[0] if isinstance(e, tuple) and
                                  len(e) == 1 else e for e in spec)
                            for spec in kernel_pspecs_from_axes(*got, seq_ax)]
                    assert mine == want


@pytest.mark.parametrize("arch,seq_len,layers,max_extent", [
    ("spion-lra", 2048, None, None), ("spion-lra", 2048, None, 2),
    ("spion-lra", 1024, 2, 1), ("qwen2-7b", 1024, 2, None),
    ("qwen2-7b", 2048, 3, 4)])
def test_dryrun_tables_are_the_references(arch, seq_len, layers, max_extent):
    import repro.configs as jcfgs
    import repro_torch.configs as tcfgs
    from repro.launch.steps import spion_dryrun_halo as jhalo
    from repro.launch.steps import spion_dryrun_tables as jtables
    from repro_torch.launch.steps import spion_dryrun_halo, spion_dryrun_tables
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    want = jtables(jc, seq_len, layers, max_extent)
    got = spion_dryrun_tables(tc, seq_len, layers, max_extent)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if hasattr(v, "shape"):
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)
        else:
            assert got[k] == v, k
    assert spion_dryrun_halo(tc, seq_len, layers, max_extent) == \
        jhalo(jc, seq_len, layers, max_extent) == list(want["halo"])


def test_no_axis_raises_the_references_error():
    """A 'seq' axis, a pattern too wide for it and no data axis to fall back
    to: the port raises the reference's RuntimeError, before any
    collective."""
    import jax.numpy as jnp
    import torch
    from repro.core.sparse_attention import bcsr_from_blockmask
    from repro.kernels.sharded import sharded_fused_attention as jref
    from repro_torch.kernels.sharded import sharded_fused_attention
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(np.arange(2).reshape(2, 1), ("seq", "data"))
    x = case_inputs("wide")
    b = bcsr_from_blockmask(x["mask"], BLOCK)
    halo = (S // BLOCK - 1, 0)
    with pytest.raises(RuntimeError) as want:
        jref(mesh, jnp.asarray(x["q"]), jnp.asarray(x["k"]),
             jnp.asarray(x["v"]), jnp.maximum(b.col_idx, 0), b.nvalid,
             block=BLOCK, interpret=True, halo=halo)
    half = S // 2      # the port's rank holds half the sequence
    with pytest.raises(RuntimeError) as got:
        sharded_fused_attention(
            mesh, torch.from_numpy(x["q"][:, :, :, :half]),
            torch.from_numpy(x["k"][:, :, :half]),
            torch.from_numpy(x["v"][:, :, :half]),
            torch.from_numpy(np.maximum(np.asarray(b.col_idx), 0)),
            torch.from_numpy(np.array(b.nvalid)), block=BLOCK, halo=halo)
    assert str(got.value) == str(want.value)
    assert "cannot seq-shard" in str(got.value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="no mesh axis shards"):
            sharded_fused_attention(
                Mesh(np.arange(1).reshape(1, 1), ("seq", "data")),
                torch.zeros(1, 1, 1, S, HD), torch.zeros(1, 1, S, HD),
                torch.zeros(1, 1, S, HD), torch.zeros(8, 1, dtype=torch.int32),
                torch.ones(8, dtype=torch.int32), block=BLOCK)
