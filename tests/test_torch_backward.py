"""Port parity, sparse attention backward: the plain versions of the Hopper
dQ and dK/dV kernels (`fused_dq_reference`, `fused_dkv_reference`, what
the wrappers run on CPU tensors) against the JAX package's Pallas kernels
in interpret mode; the port's differentiable op against `jax.grad` of the
JAX op and of the dense reference; the plan's transposed tables against
the fallback ones; and `bcsr_transpose` against the reference's.

Tolerances are the JAX package's (tests/test_kernels.py): gradients 1e-3
against the dense reference, the plan path against the fallback 1e-6.
The plain versions and the Pallas kernels compute the same sums in fp32
from the same inputs, so they are held to the forward's fp32 3e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_attention import bcsr_from_blockmask as j_bcsr
from repro.core.sparse_attention import bcsr_transpose as j_transpose
from repro.core.sparse_attention import build_sparsity_plan as j_plan
from repro.kernels import ref as jref
from repro.kernels.block_sparse_attn import (_fused_dkv, _fused_dq,
                                             _fused_forward)
from repro.kernels.block_sparse_attn import \
    fused_block_sparse_attention as j_op
from repro_torch.core.sparse_attention import bcsr_transpose
from repro_torch.core.sparse_attention import build_sparsity_plan as t_plan
from repro_torch.kernels.block_sparse_attn import (
    block_sparse_dkv, block_sparse_dq, fused_block_sparse_attention,
    fused_dkv_reference, fused_dq_reference)
from torch_parity import (FWD_TOL, assert_close, normal, random_blockmask,
                          to_torch)

GRAD_TOL = 1e-3

# tests/test_kernels.py's GRAD_SWEEP: (S, hd, block, causal, sw, G)
GRAD_SWEEP = [
    (128, 32, 32, False, None, 1),   # encoder
    (128, 32, 32, True, None, 1),    # causal LM
    (256, 64, 64, True, 96, 1),      # causal + sliding window
    (128, 16, 32, True, None, 4),    # GQA: 4 query heads per kv head
]


def _tables(rng, n, block, causal=False, empty_rows=(), empty_cols=()):
    """Forward tables (col_idx clamped, nvalid) of a random block mask,
    padded two entries past the widest row, and the mask itself."""
    mask = random_blockmask(rng, n, causal=causal, empty_rows=empty_rows)
    for c in empty_cols:
        mask[:, c] = False
    b = j_bcsr(mask, block, max_k=int(mask.sum(1).max()) + 2)
    col = np.maximum(np.asarray(b.col_idx), 0).astype(np.int32)
    return col, np.asarray(b.nvalid), mask


def _inputs(S, hd, block, causal, sw, G, dtype="float32", seed=0,
            empty_rows=(1,), empty_cols=(2,)):
    """q, k, v, dO (N=2), the tables, and lse and delta from the JAX
    forward: the same numpy arrays go to both sides."""
    rng = np.random.default_rng(seed)
    N, n = 2, S // block
    col, nvalid, mask = _tables(rng, n, block, causal, empty_rows,
                                empty_cols)
    q = normal(rng, (N, G, S, hd), dtype)
    k = normal(rng, (N, S, hd), dtype)
    v = normal(rng, (N, S, hd), dtype)
    do = normal(rng, (N, G, S, hd), dtype)
    o, lse = _fused_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(col), jnp.asarray(nvalid),
                            block=block, causal=causal, sliding_window=sw,
                            interpret=True)
    delta = jnp.sum(jnp.asarray(do, jnp.float32) * o.astype(jnp.float32), -1)
    return dict(q=q, k=k, v=v, do=do, col=col, nvalid=nvalid, mask=mask,
                lse=np.asarray(lse), delta=np.asarray(delta))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd,block,causal,sw,G", GRAD_SWEEP)
def test_plain_backward_matches_pallas_kernels(S, hd, block, causal, sw, G,
                                               dtype):
    """dq, dk, dv of the plain versions == the Pallas _dq_kernel and
    _dkv_kernel (interpret mode) on the same inputs, lse and delta, with
    an empty row and an empty column; the wrappers on CPU tensors run the
    plain versions."""
    x = _inputs(S, hd, block, causal, sw, G, dtype)
    jx = {k: jnp.asarray(v) for k, v in x.items() if k != "mask"}
    tx = {k: to_torch(v) for k, v in x.items() if k != "mask"}
    row_j, nvt_j = j_transpose(jx["col"], jx["nvalid"], ncb=S // block)
    kw = dict(block=block, causal=causal, sliding_window=sw)
    args_j = (jx["q"], jx["k"], jx["v"], jx["do"], jx["lse"], jx["delta"])
    want_dq = _fused_dq(*args_j, jx["col"], jx["nvalid"], interpret=True,
                        **kw)
    want_dk, want_dv = _fused_dkv(*args_j, row_j, nvt_j, interpret=True,
                                  **kw)
    args_t = (tx["q"], tx["k"], tx["v"], tx["do"], tx["lse"], tx["delta"])
    row_t, nvt_t = to_torch(row_j), to_torch(nvt_j)
    dq = fused_dq_reference(*args_t, tx["col"], tx["nvalid"], **kw)
    dk, dv = fused_dkv_reference(*args_t, row_t, nvt_t, **kw)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.dtype == torch.float32
        assert_close(got, want, FWD_TOL["float32"], f"{name} {dtype}")
    block_ = block
    assert not dq[:, :, block_:2 * block_].any()          # the empty row
    assert not dk[:, 2 * block_:3 * block_].any()         # the empty column
    assert not dv[:, 2 * block_:3 * block_].any()
    # on CPU tensors the wrappers are the plain versions
    assert torch.equal(block_sparse_dq(*args_t, tx["col"], tx["nvalid"],
                                       **kw), dq)
    wdk, wdv = block_sparse_dkv(*args_t, row_t, nvt_t, **kw)
    assert torch.equal(wdk, dk) and torch.equal(wdv, dv)


# every block above and below the GRAD_SWEEP's that the bf16 kernels tile
# across heads and warpgroups: (S, hd, block, causal, sw, G), S <= 256 and a
# multiple of the block, three or more row blocks where S allows
BLOCK_SWEEP = [
    (64, 16, 16, True, None, 4),
    (240, 32, 80, True, 48, 1),
    (192, 48, 96, False, None, 4),
    (256, 16, 128, False, None, 1),
]


@pytest.mark.parametrize("S,hd,block,causal,sw,G", BLOCK_SWEEP)
def test_plain_backward_matches_pallas_kernels_at_every_block(S, hd, block,
                                                             causal, sw, G):
    """dq, dk, dv of the plain versions == the Pallas _dq_kernel and
    _dkv_kernel (interpret mode) at blocks 16, 80, 96 and 128, fp32 at the
    forward's 3e-5, with an empty row block and an empty column block: the
    card holds the bf16 kernels, which tile these blocks across heads and
    warpgroups, against these plain versions only."""
    n = S // block
    x = _inputs(S, hd, block, causal, sw, G, empty_rows=(n - 1,),
                empty_cols=(0,))
    assert x["nvalid"][n - 1] == 0 and x["nvalid"].sum() > 0
    jx = {k: jnp.asarray(v) for k, v in x.items() if k != "mask"}
    tx = {k: to_torch(v) for k, v in x.items() if k != "mask"}
    row_j, nvt_j = j_transpose(jx["col"], jx["nvalid"], ncb=n)
    kw = dict(block=block, causal=causal, sliding_window=sw)
    args_j = (jx["q"], jx["k"], jx["v"], jx["do"], jx["lse"], jx["delta"])
    want_dq = _fused_dq(*args_j, jx["col"], jx["nvalid"], interpret=True,
                        **kw)
    want_dk, want_dv = _fused_dkv(*args_j, row_j, nvt_j, interpret=True,
                                  **kw)
    args_t = (tx["q"], tx["k"], tx["v"], tx["do"], tx["lse"], tx["delta"])
    dq = fused_dq_reference(*args_t, tx["col"], tx["nvalid"], **kw)
    dk, dv = fused_dkv_reference(*args_t, to_torch(row_j), to_torch(nvt_j),
                                 **kw)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert_close(got, want, FWD_TOL["float32"], f"{name} block {block}")
    assert not dq[:, :, (n - 1) * block:].any()           # the empty row
    assert not dk[:, :block].any() and not dv[:, :block].any()
    assert dq.abs().sum() > 0 and dk.abs().sum() > 0


def _grads_torch(x, block, causal, sw, plan=None):
    q, k, v = (to_torch(x[n]).requires_grad_() for n in "qkv")
    o = fused_block_sparse_attention(
        q, k, v, to_torch(x["col"]), to_torch(x["nvalid"]), block=block,
        causal=causal, sliding_window=sw,
        row_idx=None if plan is None else plan.tables["row_idx"][0],
        nvalid_t=None if plan is None else plan.tables["nvalid_t"][0])
    loss = (o.float() * to_torch(x["gout"]).float()).sum()
    return o, torch.autograd.grad(loss, (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd,block,causal,sw,G", GRAD_SWEEP)
def test_autograd_op_matches_jax_grad(S, hd, block, causal, sw, G, dtype):
    """The port's op on CPU tensors (plain forward, dQ and dK/dV) against
    jax.grad of the JAX op (Pallas kernels in interpret mode) and, in fp32,
    against jax.grad of the dense reference at 1e-3. bf16 gradients are
    rounded to bf16 on both sides: held at the forward's 6e-2."""
    x = _inputs(S, hd, block, causal, sw, G, dtype, empty_rows=(),
                empty_cols=())
    rng = np.random.default_rng(1)
    x["gout"] = normal(rng, x["q"].shape, "float32")
    gout = jnp.asarray(x["gout"])
    col, nvalid = jnp.asarray(x["col"]), jnp.asarray(x["nvalid"])
    b = j_bcsr(x["mask"], block)

    def loss_op(q, k, v):
        o = j_op(q, k, v, col, nvalid, block=block, causal=causal,
                 sliding_window=sw, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * gout)

    def loss_dense(q, k, v):
        o = jnp.stack([jref.fused_ref(q[:, g], k, v, b.col_idx, block=block,
                                      causal=causal, sliding_window=sw)
                       for g in range(G)], axis=1)
        return jnp.sum(o.astype(jnp.float32) * gout)

    args = tuple(jnp.asarray(x[n]) for n in "qkv")
    want = jax.jit(jax.grad(loss_op, argnums=(0, 1, 2)))(*args)
    o, got = _grads_torch(x, block, causal, sw)
    tol = 3e-5 if dtype == "float32" else 6e-2
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == getattr(torch, dtype)
        assert_close(a, w, tol, f"d{name} vs the JAX op")
    if dtype == "float32":
        dense = jax.jit(jax.grad(loss_dense, argnums=(0, 1, 2)))(*args)
        for name, a, w in zip("qkv", got, dense):
            assert_close(a, w, GRAD_TOL, f"d{name} vs the dense reference")


@pytest.mark.parametrize("causal", [True, False])
def test_plan_path_grads_equal_fallback_path(causal):
    """Gradients through a SparsityPlan's transposed tables (width KT* <
    nrb) equal those through bcsr_transpose's (width nrb) within 1e-6
    (tests/test_kernels.py's skewed sliding-window mask)."""
    S, hd, block = 128, 16, 16
    n = S // block
    mask = np.zeros((n, n), bool)
    for r in range(n):
        mask[r, max(r - 1, 0): r + 1] = True
    if not causal:
        mask[n // 2:, n - 1] = True  # a column half of the rows list
    b = j_bcsr(mask, block)
    plan = t_plan(np.asarray(b.col_idx), np.asarray(b.nvalid), block)
    assert plan.kt_star < n
    rng = np.random.default_rng(5)
    x = dict(q=normal(rng, (2, 1, S, hd)), k=normal(rng, (2, S, hd)),
             v=normal(rng, (2, S, hd)), gout=normal(rng, (2, 1, S, hd)),
             col=np.maximum(np.asarray(b.col_idx), 0).astype(np.int32),
             nvalid=np.asarray(b.nvalid))
    _, g_plan = _grads_torch(x, block, causal, None, plan=plan)
    _, g_base = _grads_torch(x, block, causal, None)
    for a, w in zip(g_plan, g_base):
        assert_close(a, w, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ncb_extra,max_k", [(0, None), (1, None), (0, 5)])
def test_bcsr_transpose_matches_reference(seed, ncb_extra, max_k):
    """The port's bcsr_transpose (the fallback's table rebuild) gives the
    reference's row_idx and nvalid_t bit for bit, padding included, and
    its valid prefix is the host plan's."""
    rng = np.random.default_rng(seed)
    n, block = 8, 16
    col, nvalid, mask = _tables(rng, n, block, empty_rows=(3,),
                                empty_cols=(5,))
    ncb = n + ncb_extra
    want_r, want_n = j_transpose(jnp.asarray(col), jnp.asarray(nvalid),
                                 ncb=ncb, max_k=max_k)
    got_r, got_n = bcsr_transpose(torch.from_numpy(col),
                                  torch.from_numpy(nvalid.copy()), ncb=ncb,
                                  max_k=max_k)
    assert got_r.dtype == torch.int32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    plan = j_plan(col, nvalid, block, ncb=ncb)
    pr, pn = (np.asarray(plan.tables[k][0]) for k in ("row_idx", "nvalid_t"))
    np.testing.assert_array_equal(got_n.numpy(), np.minimum(pn, got_r.shape[1]))
    for c in range(ncb):
        m = int(got_n[c])
        np.testing.assert_array_equal(got_r[c, :m].numpy(), pr[c, :m])


def test_backward_wrappers_check_their_inputs():
    x = _inputs(128, 32, 32, True, None, 1)
    tx = {k: to_torch(v) for k, v in x.items() if k != "mask"}
    args = (tx["q"], tx["k"], tx["v"], tx["do"], tx["lse"], tx["delta"])
    with pytest.raises(ValueError, match="lse"):
        block_sparse_dq(*args[:4], tx["lse"][..., :-1], tx["delta"],
                        tx["col"], tx["nvalid"], block=32)
    with pytest.raises(ValueError, match="do must be"):
        block_sparse_dq(tx["q"], tx["k"], tx["v"], tx["do"].double(),
                        tx["lse"], tx["delta"], tx["col"], tx["nvalid"],
                        block=32)
    with pytest.raises(TypeError, match="int32"):
        block_sparse_dkv(*args, tx["col"].long(), tx["nvalid"], block=32)
    with pytest.raises(ValueError, match="tables"):
        block_sparse_dkv(*args, tx["col"][:2], tx["nvalid"][:2], block=32)
    with pytest.raises(ValueError, match="block"):
        block_sparse_dq(*args, tx["col"], tx["nvalid"], block=48)
