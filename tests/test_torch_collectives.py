"""Port parity, the explicit collectives: int8 quantisation, the compressed
and hierarchical gradient syncs, the GPipe pipeline and the §4.4 op count.

  - In process: `quantize_int8` / `dequantize_int8` give q and the scale
    bitwise the JAX package's on the same numpy inputs (zeros, exact
    halves, +-amax, bf16 inputs, random), the reference's round-trip
    bound, and `bcsr_attention_ops` the JAX function's int.
  - One 4-rank gloo job for every multi-process case: the syncs on (pod 2,
    data 2) (the reference test's 0.25 -> 0.5 and -> 1.0, and random
    per-rank trees bitwise equal to a numpy recomputation of the
    reference's arithmetic and to the JAX package's `compressed_psum`
    under shard_map on the same per-device trees); `pipeline_apply` on
    (pod 4): the reference test's case, then random stage weights at
    n_micro 2, 4 and 8 and a stage with a bias and a tanh, the output and
    every stage's gradient and dx within 1e-6 of each's largest |element|
    of the sequential product's and of the JAX `pipeline_apply`'s (run in
    a subprocess with 4 fake CPU devices); a batch n_micro does not
    divide is refused.
  - Planted faults, each past its gate: the output's cotangent summed over
    the line (4x gradients), a stage whose backward sends zeros in place of
    its input's gradient, the scales summed instead of averaged.
"""
import json

import numpy as np
import pytest
import torch

from conftest import run_distributed_case, run_subprocess_case

MP_ENV = {"OMP_NUM_THREADS": "1"}
PIPE_TOL = 1e-6          # of each tensor's largest |element|
REF_TOL = 1e-5           # the reference test's bound on the 8 x 8 product

# shared by the workers, the JAX subprocess and the test process: numpy only
SRC = """
import numpy as np

S, D, B = 4, 8, 8
# pipeline case: (stage kind, n_micro, seed)
PIPE = {"ref4": ("eye", 4, 0), "rand2": ("matmul", 2, 1),
        "rand4": ("matmul", 4, 1), "rand8": ("matmul", 8, 1),
        "tanh4": ("tanh", 4, 2)}
FAULT_CASE = "rand4"


def pipe_inputs(name):
    \"\"\"(stacked stage params {leaf: (S, ...)}, x (B, D), cotangent (B, D))
    of a pipeline case, float32.\"\"\"
    kind, _, seed = PIPE[name]
    rng = np.random.default_rng(seed)
    diag = np.stack([np.eye(D) * (i + 1) for i in range(S)])
    if kind == "eye":
        p = {"w": diag}
    elif kind == "matmul":
        # the reference's probe: diag(i + 1) + 0.1 N(0, 1)
        p = {"w": diag + 0.1 * rng.standard_normal((S, D, D))}
    else:
        p = {"w": rng.standard_normal((S, D, D)) / np.sqrt(D),
             "b": 0.1 * rng.standard_normal((S, D))}
    x = rng.standard_normal((B, D))
    cot = np.ones((B, D)) if kind == "eye" else rng.standard_normal((B, D))
    f32 = lambda a: a.astype(np.float32)
    return {k: f32(v) for k, v in p.items()}, f32(x), f32(cot)


# sync trees: each rank's {leaf: array}, 'h' bfloat16 (given here as the
# float32 values of bfloat16 numbers: multiples of 2^-7 below 1)
SHAPES = {"w": (5, 7), "b": (3,), "h": (4, 6), "z": (3,), "e": (2, 2)}


def sync_tree(rank):
    rng = np.random.default_rng([11, rank])
    t = {"w": rng.standard_normal(SHAPES["w"]) * (rank + 1),
         "b": rng.standard_normal(SHAPES["b"]) * 1e-3,
         "h": np.round(rng.uniform(-1, 1, SHAPES["h"]) * 128) / 128,
         "z": np.zeros(SHAPES["z"]),
         # values at k + 0.5 of the scale (ties): the scale is rank + 1
         "e": np.array([[127.0, 2.5], [-3.5, 0.5]]) * (rank + 1)
         * (1 if rank % 2 else -1)}
    return {k: v.astype(np.float32) for k, v in t.items()}
"""
exec(SRC)

WORKER = """
import contextlib, json, os
import torch
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
import torch.distributed as dist
from repro_torch.distributed import pipeline
from repro_torch.distributed.collectives import (compressed_grad_sync,
                                                 hierarchical_grad_sync)
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import grad as grad_mod
syncs = make_mesh((2, 2), ("pod", "data"))
line = make_mesh((4,), ("pod",))
out = {}


def as_tree(t):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "h" else
                                      torch.float32) for k, v in t.items()}


def record(key, tree):
    for k, v in tree.items():
        out[f"{key}/{k}"] = v.float().numpy()


def run_syncs(key, tree):
    before = {k: v.clone() for k, v in tree.items()}
    record(f"{key}/data", compressed_grad_sync(syncs, tree))
    record(f"{key}/poddata", compressed_grad_sync(syncs, tree,
                                                  axes=("pod", "data")))
    record(f"{key}/hier", hierarchical_grad_sync(syncs, tree))
    for k in tree:
        assert torch.equal(tree[k], before[k]), "a sync changed its input"


quarter = {"w": torch.ones(8, 8) * 0.25}
run_syncs("quarter", quarter)
run_syncs("tree", as_tree(sync_tree(pid)))
# planted: the scales summed over the group, not averaged
with contextlib.ExitStack() as stack:
    sound_mean = grad_mod.line_mean
    grad_mod.line_mean = lambda v, group: sound_mean(v, group) * (
        1 if group is None else dist.get_world_size(group))
    stack.callback(setattr, grad_mod, "line_mean", sound_mean)
    record("planted_scales/data", compressed_grad_sync(syncs, quarter))


def stage_fn(kind):
    if kind == "tanh":
        return lambda p, a: torch.tanh(a @ p["w"] + p["b"])
    return lambda p, a: a @ p["w"]


class SumOverLine(torch.autograd.Function):
    # planted: the output's cotangent summed over the line in the backward
    @staticmethod
    def forward(ctx, y):
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=line.group("pod"))
        return g


def run_pipe(name, fault=None):
    kind, n_micro, _ = PIPE[name]
    stacked, x, cot = pipe_inputs(name)
    s = line.axis_index("pod")
    params = {k: torch.from_numpy(v[s]).requires_grad_() for k, v in
              stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    sound = pipeline.stage_backward
    if fault == "no_dx_send":
        def zero_from_stage2(*a, **kw):
            da, grads = sound(*a, **kw)
            return (torch.zeros_like(da) if s == 2 else da), grads
        pipeline.stage_backward = zero_from_stage2
    try:
        y = pipeline.pipeline_apply(line, "pod", stage_fn(kind), params, xt,
                                    n_micro)
        if fault == "cotangent_summed":
            y = SumOverLine.apply(y)
        y.backward(torch.from_numpy(cot))
    finally:
        pipeline.stage_backward = sound
    key = name if fault is None else f"planted_{fault}"
    out[f"{key}/out"] = y.detach().numpy()
    out[f"{key}/dx"] = xt.grad.numpy()
    for k, p in params.items():
        out[f"{key}/d{k}"] = p.grad.numpy()


for name in PIPE:
    run_pipe(name)
for fault in ("cotangent_summed", "no_dx_send"):
    run_pipe(FAULT_CASE, fault)
try:
    pipeline.pipeline_apply(line, "pod", stage_fn("matmul"),
                            {"w": torch.eye(D)}, torch.zeros(B, D), 3)
    refused = None
except ValueError as e:
    refused = str(e)
np.savez(os.path.join(OUT, f"rank{pid}.npz"), **out)
json.dump({"refused": refused, "hop_s": pipeline.hop_seconds,
           "coords": syncs.coords(), "stage": line.axis_index("pod")},
          open(os.path.join(OUT, f"info{pid}.json"), "w"))
print("COLLECTIVES_OK")
runtime.shutdown(0)
"""

JAX_CODE = """
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_mesh
from repro.optim.grad import compressed_psum
out = {}
line = make_mesh((4,), ("pod",))
for name, (kind, n_micro, _) in PIPE.items():
    stacked, x, cot = pipe_inputs(name)
    if kind == "tanh":
        fn = lambda p, a: jnp.tanh(a @ p["w"] + p["b"])
    else:
        fn = lambda p, a: a @ p["w"]

    def fwd_bwd(p, x, c, fn=fn, n_micro=n_micro):
        y, vjp = jax.vjp(lambda p, x: pipeline_apply(line, "pod", fn, p, x,
                                                     n_micro), p, x)
        return (y, *vjp(c))
    y, dp, dx = jax.jit(fwd_bwd)(stacked, x, jnp.asarray(cot))
    out[f"{name}/out"] = np.asarray(y)
    out[f"{name}/dx"] = np.asarray(dx)
    for k, v in dp.items():
        out[f"{name}/d{k}"] = np.asarray(v)
# the reference's compressed_psum on per-device trees: device (pod i, data
# j) holds rank 2 i + j's tree
mesh = make_mesh((2, 2), ("pod", "data"))
trees = [sync_tree(r) for r in range(4)]
stack = {k: jnp.asarray(np.stack([t[k] for t in trees]).reshape(
    (2, 2) + SHAPES[k])).astype(jnp.bfloat16 if k == "h" else jnp.float32)
         for k in SHAPES}
spec = {k: P("pod", "data") for k in SHAPES}


def hier(g):
    g = jax.tree_util.tree_map(lambda x: jax.lax.psum(x, "data"), g)
    return compressed_psum(g, "pod")


for key, f in (("data", lambda g: compressed_psum(g, "data")),
               ("poddata", lambda g: compressed_psum(g, ("pod", "data"))),
               ("hier", hier)):
    got = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=spec,
                            check_rep=False))(stack)
    for k, v in got.items():
        out[f"tree/{key}/{k}"] = np.asarray(v.astype(jnp.float32)).reshape(
            (4,) + SHAPES[k])
np.savez(OUTFILE, **out)
print("JAX_OK")
"""


def np_quantize(x):
    """The reference's quantize_int8 in numpy float32."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x))
    scale = np.float32(amax / np.float32(127.0)) if amax > 0 \
        else np.float32(1.0)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def np_compressed(parts, dtype):
    """The reference's compressed_psum over `parts` (each rank's float32
    values, in the group's order): int32 sums, the scales summed first to
    last and divided by the group's size, the result cast to `dtype`."""
    qs, ss = zip(*(np_quantize(p) for p in parts))
    total = sum(q.astype(np.int32) for q in qs)
    s = ss[0]
    for x in ss[1:]:
        s = np.float32(s + x)
    s = np.float32(s / np.float32(len(parts)))
    res = total.astype(np.float32) * s
    return torch.from_numpy(res).to(dtype).float().numpy()


def leaf_dtype(k):
    return torch.bfloat16 if k == "h" else torch.float32


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives_jax")
    path = str(d / "jax.npz")
    assert "JAX_OK" in run_subprocess_case(
        SRC + f"OUTFILE = {path!r}\n" + JAX_CODE)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def mp_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives_job")
    outs = run_distributed_case(SRC + WORKER, nproc=4, timeout=300,
                                env_extra=dict(MP_ENV, MP_OUT=str(d)))
    assert all("COLLECTIVES_OK" in o for o in outs)
    return {"ranks": [dict(np.load(d / f"rank{i}.npz")) for i in range(4)],
            "info": [json.load(open(d / f"info{i}.json")) for i in range(4)]}


# -- in process --------------------------------------------------------------

QUANT_CASES = {
    "zeros": np.zeros((4, 5), np.float32),
    # every value k + 0.5 times the scale (amax 127: scale 1): half to even
    "halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5],
                       np.float32),
    "plus_minus_amax": np.array([3.0, -3.0, 1.0, -1.0, 0.0], np.float32),
    "random": np.random.default_rng(5).standard_normal((16, 9)).astype(
        np.float32) * 7.3,
    "tiny": np.random.default_rng(6).standard_normal(33).astype(
        np.float32) * 1e-30,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_int8_is_the_reference_bitwise(case, dtype):
    """q and the scale bitwise the JAX package's on the same input, in
    fp32 and in bf16 (the bf16 numbers of the case); dequantize_int8 too."""
    import jax.numpy as jnp
    from repro.optim.grad import dequantize_int8 as jdeq
    from repro.optim.grad import quantize_int8 as jquant
    from repro_torch.optim.grad import dequantize_int8, quantize_int8
    t = torch.from_numpy(QUANT_CASES[case]).to(getattr(torch, dtype))
    x = jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
    jq, js = jquant(x)
    q, s = quantize_int8(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jdeq(jq, js)))
    if case == "halves":     # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -126.5 -> -126
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -126]


def test_quantize_int8_leaves_its_input_and_takes_bf16():
    from repro_torch.optim.grad import quantize_int8
    x = torch.tensor([1.0, -2.0, 0.25], dtype=torch.bfloat16)
    before = x.clone()
    q, s = quantize_int8(x)
    assert torch.equal(x, before)
    wq, ws = np_quantize(x.float().numpy())
    assert float(s) == ws and q.numpy().tolist() == wq.tolist()
    assert q[1] == -127


def test_quantize_roundtrip_error_bound():
    """The reference's bound (tests/test_substrates.py): each element of
    dequantize(quantize(x)) within half a scale of x, on the reference's
    range of inputs."""
    from hypothesis import given, strategies as st
    from repro_torch.optim.grad import dequantize_int8, quantize_int8

    @given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1,
                    max_size=64))
    def check(xs):
        x = torch.tensor(np.array(xs, np.float32))
        q, s = quantize_int8(x)
        err = (dequantize_int8(q, s) - x).abs().max().item()
        amax = x.abs().max().item()
        assert err <= amax / 127.0 * 0.5 + 1e-6
    check()


def test_compressed_psum_on_one_rank_is_the_round_trip():
    """No group: each leaf quantised and restored in its own dtype."""
    from repro_torch.optim.grad import (compressed_psum, dequantize_int8,
                                        quantize_int8)
    t = {"a": torch.from_numpy(QUANT_CASES["random"]),
         "b": torch.tensor([0.3, -0.7], dtype=torch.bfloat16)}
    got = compressed_psum(t, None)
    for k, v in t.items():
        assert got[k].dtype == v.dtype
        assert torch.equal(got[k], dequantize_int8(*quantize_int8(v)).to(
            v.dtype))


def _ops_cases():
    rng = np.random.default_rng(9)
    cases = [(512, 64, 64, np.eye(8, dtype=bool))]
    for L, blk, hd in ((256, 16, 16), (1024, 64, 64), (2048, 128, 128),
                       (384, 32, 24)):
        n = L // blk
        m = rng.random((n, n)) < 0.3
        np.fill_diagonal(m, True)
        cases.append((L, blk, hd, m))
    return cases


@pytest.mark.parametrize("i", range(5))
def test_bcsr_attention_ops_is_the_reference(i):
    """The §4.4 op count: the same int as the JAX function's, on
    tests/test_sparse_attention.py's case (an identity block mask, L 512,
    block 64, head dim 64) and on seeded random block masks."""
    from repro.configs import get_config as jget
    from repro.core.sparse_attention import bcsr_attention_ops as jops
    from repro.core.sparse_attention import bcsr_from_blockmask as jbcsr
    from repro_torch.configs import get_config
    from repro_torch.core.sparse_attention import (bcsr_attention_ops,
                                                   bcsr_from_blockmask)
    L, blk, hd, mask = _ops_cases()[i]
    kw = dict(head_dim=hd, num_heads=1, num_kv_heads=1)
    got = bcsr_attention_ops(get_config("spion-lra").replace(**kw),
                             bcsr_from_blockmask(mask, blk))
    want = jops(jget("spion-lra").replace(**kw), jbcsr(mask, blk))
    assert type(got) is int and got == want
    if i == 0:
        C = 8 * blk * blk
        assert got == 2 * C * (2 * 64 + 1) - L * (64 + 1)


def test_pipeline_refuses_a_batch_n_micro_does_not_divide():
    """The reference fails in a reshape; the port raises ValueError before
    any message (a mesh without process groups suffices)."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(np.arange(4), ("pod",))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(mesh, "pod", lambda p, a: a, {}, torch.zeros(6, 2), 4)


# -- the 4-rank job ----------------------------------------------------------

def test_syncs_reference_cases(mp_job):
    """The reference test's cases on (pod 2, data 2): 0.25 everywhere syncs
    to 0.5 over 'data' (within 0.01) and to 1.0 hierarchically (within
    0.02); over ('pod', 'data') to 1.0."""
    for rec in mp_job["ranks"]:
        assert np.abs(rec["quarter/data/w"] - 0.5).max() < 0.01
        assert np.abs(rec["quarter/hier/w"] - 1.0).max() < 0.02
        assert np.abs(rec["quarter/poddata/w"] - 1.0).max() < 0.02


def test_syncs_are_the_reference_arithmetic_bitwise(mp_job, jax_ref):
    """Random per-rank trees (fp32 and a bf16 leaf, zeros, ties at k + 0.5
    scales): each rank's result is bitwise the numpy recomputation of the
    reference's arithmetic (int8 payloads summed as int32, the scales
    averaged in the group's rank order) and bitwise the JAX package's
    compressed_psum under shard_map on the same per-device trees; every
    rank of a group holds the same bits."""
    ranks, info = mp_job["ranks"], mp_job["info"]
    trees = [sync_tree(r) for r in range(4)]
    coords = [i["coords"] for i in info]
    for r, rec in enumerate(ranks):
        pod, data = coords[r]["pod"], coords[r]["data"]
        data_line = [2 * pod + j for j in range(2)]
        for k in SHAPES:
            dt = leaf_dtype(k)
            want = {
                "data": np_compressed([trees[q][k] for q in data_line], dt),
                "poddata": np_compressed([trees[q][k] for q in range(4)], dt),
            }
            # hierarchical: fp32 sums over each data line (back in the
            # leaf's dtype), then the compressed sum over 'pod'
            sums = [torch.from_numpy(trees[2 * p][k] + trees[2 * p + 1][k])
                    .to(dt).float().numpy() for p in range(2)]
            want["hier"] = np_compressed(sums, dt)
            for key, w in want.items():
                got = rec[f"tree/{key}/{k}"]
                np.testing.assert_array_equal(got, w, err_msg=f"{key} {k}")
                np.testing.assert_array_equal(
                    got, jax_ref[f"tree/{key}/{k}"][r],
                    err_msg=f"{key} {k} vs the JAX package")


def test_planted_summed_scales_miss_the_gate(mp_job):
    """The scales summed over the group, not averaged: 0.25 syncs to 1.0
    over a data line of 2, past the 0.01 gate by 49x."""
    for rec in mp_job["ranks"]:
        gap = float(np.abs(rec["planted_scales/data/w"] - 0.5).max())
        assert gap == pytest.approx(0.5) and gap > 0.01


def _sequential(name):
    """(out, {leaf: (S, ...) gradients}, dx) of the stages applied in
    order in one process, fp32, on the whole batch."""
    kind, _, _ = PIPE[name]
    stacked, x, cot = pipe_inputs(name)
    ps = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    a = xt
    for s in range(S):
        a = a @ ps["w"][s]
        if kind == "tanh":
            a = torch.tanh(a + ps["b"][s])
    a.backward(torch.from_numpy(cot))
    return (a.detach().numpy(), {k: p.grad.numpy() for k, p in ps.items()},
            xt.grad.numpy())


def _gap(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pipe_gaps(rec, key, want_out, want_grads, want_dx, stage):
    gaps = {"out": _gap(rec[f"{key}/out"], want_out),
            "dx": _gap(rec[f"{key}/dx"], want_dx)}
    for k, g in want_grads.items():
        gaps[f"d{k}"] = _gap(rec[f"{key}/d{k}"], g[stage])
    return gaps


@pytest.mark.parametrize("name", sorted(PIPE))
def test_pipeline_matches_sequential_and_reference(mp_job, jax_ref, name):
    """pipeline_apply on (pod 4), each rank one stage: the whole output on
    every rank, each stage's gradients and the whole dx within 1e-6 of
    each's largest |element| of the sequential product's and of the JAX
    pipeline_apply's (4 fake devices); the reference test's case (a @ w_i,
    w_i = (i + 1) I, n_micro 4) within 1e-5 of the product."""
    out, grads, dx = _sequential(name)
    for rec, inf in zip(mp_job["ranks"], mp_job["info"]):
        s = inf["stage"]
        seq = _pipe_gaps(rec, name, out, grads, dx, s)
        ref = _pipe_gaps(rec, name, jax_ref[f"{name}/out"],
                         {k[1:]: jax_ref[f"{name}/{k}"]
                          for k in ("dw", "db") if f"{name}/{k}" in jax_ref},
                         jax_ref[f"{name}/dx"], s)
        assert max(seq.values()) <= PIPE_TOL, (name, s, seq)
        assert max(ref.values()) <= PIPE_TOL, (name, s, ref)
        if name == "ref4":
            assert np.abs(rec[f"{name}/out"] - out).max() < REF_TOL
            assert np.abs(rec[f"{name}/dw"]).max() > 0
    assert sorted(i["stage"] for i in mp_job["info"]) == [0, 1, 2, 3]


@pytest.mark.parametrize("fault,factor", [("cotangent_summed", 3.0),
                                          ("no_dx_send", 1.0)])
def test_planted_pipeline_faults_miss_the_gates(mp_job, fault, factor):
    """The output's cotangent summed over the line gives 4x every gradient
    (3x the largest past the 1e-6 gate); stage 2 sending zeros in place of
    its input's gradient leaves stages 0 and 1 and dx with none (1.0 past
    it). The output itself is sound in both."""
    out, grads, dx = _sequential(FAULT_CASE)
    worst = 0.0
    for rec, inf in zip(mp_job["ranks"], mp_job["info"]):
        gaps = _pipe_gaps(rec, f"planted_{fault}", out, grads, dx,
                          inf["stage"])
        assert gaps["out"] <= PIPE_TOL
        worst = max(worst, max(gaps.values()))
    assert worst == pytest.approx(factor, rel=1e-4) and worst > PIPE_TOL


def test_pipeline_refusal_and_hops_in_the_job(mp_job):
    """B 8 in 3 microbatches raises ValueError on every rank, before any
    message; each rank spent host time in its hops."""
    for inf in mp_job["info"]:
        assert inf["refused"] and "microbatches" in inf["refused"]
        assert inf["hop_s"] > 0
