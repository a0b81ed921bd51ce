"""Port parity, kernels: the plain version of the Hopper block-sparse
forward (`repro_torch.kernels.block_sparse_attn.fused_forward_reference`,
what the wrapper runs on CPU tensors) against the JAX package's Pallas
kernel in interpret mode, at every block the bf16 kernel takes, and against
its three-step oracle; the head-grouping wrapper against the JAX wrapper;
the wrapper's input checks and its choice of entry point; the card check's
bf16 sweep; and the rule that the port imports nothing of JAX."""
import ast
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.sparse_attention import bcsr_from_blockmask as j_bcsr
from repro.kernels import ref as jref
from repro.kernels.block_sparse_attn import _fused_forward
from repro.kernels.ops import spion_attention_kernel as j_kernel
from repro_torch import resolve_device
from repro_torch.configs import get_config as tget_config
from repro_torch.core.sparse_attention import BCSR
from repro_torch.kernels.block_sparse_attn import (_HEAD_DIMS, _aligned,
                                                   _aligned_backward,
                                                   block_sparse_fwd,
                                                   entry_point,
                                                   fused_forward_reference)
from repro_torch.kernels.ops import spion_attention_kernel as t_kernel
from torch_parity import (FWD_TOL, assert_close, normal, random_blockmask,
                          to_np, to_torch)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# the same cases as chip_smoke.py's sweep, at S <= 256:
# (dtype, causal, sliding_window, G, offsets (row0, col0) or None)
SWEEP = [
    ("float32", True, None, 1, None),
    ("float32", False, None, 4, None),
    ("float32", True, 48, 7, None),
    ("float32", True, None, 4, (2, 1)),
    ("float32", False, None, 1, (1, 0)),
    ("bfloat16", True, None, 7, None),
    ("bfloat16", False, None, 1, None),
    ("bfloat16", True, 48, 4, (2, 1)),
]


def _case(dtype, G, offsets, seed=0):
    """Inputs of one sweep case: N=2, S=128, hd=32, block=32, a random
    block mask with an empty row (nvalid 0) and tables padded two entries
    past the widest row, clamped (the kernels' convention)."""
    rng = np.random.default_rng(seed)
    N, S, hd, block = 2, 128, 32, 32
    extra = 0 if offsets is None else 32          # a halo block on the left
    nrb, ncb = S // block, (S + extra) // block
    mask = rng.random((nrb, ncb)) < 0.5
    mask[np.arange(nrb), np.arange(nrb) + extra // block] = True
    mask[1] = False
    b = j_bcsr(mask, block, max_k=int(mask.sum(1).max()) + 2)
    col = np.maximum(np.asarray(b.col_idx), 0).astype(np.int32)
    nvalid = np.asarray(b.nvalid)
    q = normal(rng, (N, G, S, hd), dtype)
    k = normal(rng, (N, S + extra, hd), dtype)
    v = normal(rng, (N, S + extra, hd), dtype)
    seq_len = None if offsets is None else 4 * S
    return q, k, v, col, nvalid, np.asarray(b.col_idx), block, seq_len


@pytest.mark.parametrize("dtype,causal,sw,G,offsets", SWEEP)
def test_plain_forward_matches_pallas_kernel(dtype, causal, sw, G, offsets):
    q, k, v, col, nvalid, _, block, seq_len = _case(dtype, G, offsets)
    want_o, want_lse = _fused_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(col),
        jnp.asarray(nvalid), block=block, causal=causal, sliding_window=sw,
        interpret=True, seq_len=seq_len,
        offsets=None if offsets is None else jnp.asarray(offsets, jnp.int32))
    got_o, got_lse = fused_forward_reference(
        to_torch(q), to_torch(k), to_torch(v), to_torch(col),
        to_torch(nvalid), block=block, causal=causal, sliding_window=sw,
        offsets=offsets, seq_len=seq_len)
    assert got_o.dtype == getattr(torch, dtype)
    assert_close(got_o, want_o, FWD_TOL[dtype], "o")
    want_lse = np.asarray(want_lse)
    inf = np.isinf(want_lse)
    assert inf[:, :, 32:64].all()                  # the empty row-block
    np.testing.assert_array_equal(np.isinf(to_np(got_lse)), inf)
    np.testing.assert_allclose(to_np(got_lse)[~inf], want_lse[~inf],
                               atol=1e-4, rtol=0)


# every block the bf16 (tensor-core) kernel takes, each with a head dim of
# its own: (block, hd, causal, sliding_window, G)
BLOCKS = [(16, 16, True, None, 4), (32, 48, False, None, 1),
          (64, 80, True, 48, 2), (80, 112, True, None, 1),
          (96, 96, False, None, 2), (128, 128, True, None, 1)]


@pytest.mark.parametrize("block,hd,causal,sw,G", BLOCKS)
def test_plain_forward_matches_pallas_kernel_at_every_block(block, hd, causal,
                                                           sw, G):
    """The plain version, which the card holds the bf16 kernel to, at each
    block from 16 to 128 (S = 480 for 80 and 96): an empty row block and
    clamped padding, fp32 at the reference's 3e-5."""
    rng = np.random.default_rng(block)
    S = 480 if block in (80, 96) else 256
    nrb = S // block
    mask = rng.random((nrb, nrb)) < 0.5
    mask[np.arange(nrb), np.arange(nrb)] = True
    if causal:
        mask &= np.tril(np.ones((nrb, nrb), bool))
    mask[1] = False
    b = j_bcsr(mask, block, max_k=int(mask.sum(1).max()) + 1)
    col = np.maximum(np.asarray(b.col_idx), 0).astype(np.int32)
    nvalid = np.asarray(b.nvalid)
    q = normal(rng, (1, G, S, hd), "float32")
    k = normal(rng, (1, S, hd), "float32")
    v = normal(rng, (1, S, hd), "float32")
    want_o, want_lse = _fused_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(col),
        jnp.asarray(nvalid), block=block, causal=causal, sliding_window=sw,
        interpret=True)
    got_o, got_lse = fused_forward_reference(
        to_torch(q), to_torch(k), to_torch(v), to_torch(col),
        to_torch(nvalid), block=block, causal=causal, sliding_window=sw)
    assert_close(got_o, want_o, FWD_TOL["float32"], "o")
    want_lse = np.asarray(want_lse)
    inf = np.isinf(want_lse)
    assert inf[:, :, block:2 * block].all()        # the empty row block
    np.testing.assert_array_equal(np.isinf(to_np(got_lse)), inf)
    np.testing.assert_allclose(to_np(got_lse)[~inf], want_lse[~inf],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,causal,sw,G,offsets",
                         [c for c in SWEEP if c[4] is None])
def test_plain_forward_matches_three_step_oracle(dtype, causal, sw, G,
                                                 offsets):
    """The JAX oracle marks padding with -1 (col_idx), the kernels with
    nvalid: both describe the same pattern."""
    q, k, v, col, nvalid, col_raw, block, _ = _case(dtype, G, offsets)
    got, _ = fused_forward_reference(
        to_torch(q), to_torch(k), to_torch(v), to_torch(col),
        to_torch(nvalid), block=block, causal=causal, sliding_window=sw)
    for g in range(G):
        want = jref.fused_ref(jnp.asarray(q[:, g]), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(col_raw),
                              block=block, causal=causal, sliding_window=sw)
        assert_close(got[:, g], want, FWD_TOL[dtype], f"g={g}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_wrapper_matches_reference_wrapper(dtype):
    """ops.spion_attention_kernel (head grouping h = kv*G + g, table
    clamping) on CPU tensors against the JAX wrapper, GQA G=2."""
    jc = jget_config("qwen2-7b").reduced()
    tc = tget_config("qwen2-7b").reduced()
    rng = np.random.default_rng(1)
    B, S, H, KV, hd, blk = 2, 128, 4, 2, 32, 32
    q = normal(rng, (B, S, H, hd), dtype)
    k = normal(rng, (B, S, KV, hd), dtype)
    v = normal(rng, (B, S, KV, hd), dtype)
    mask = random_blockmask(rng, S // blk, causal=True)
    jb = j_bcsr(mask, blk)
    want = j_kernel(jc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                    interpret=True)
    tb = BCSR(to_torch(jb.col_idx), to_torch(jb.nvalid), blk, S)
    got = t_kernel(tc, to_torch(q), to_torch(k), to_torch(v), tb)
    assert_close(got, want, FWD_TOL[dtype])


def test_wrapper_runs_plain_version_on_cpu_and_counts_only_launches():
    q, k, v, col, nvalid, _, block, _ = _case("float32", 2, None)
    before = block_sparse_fwd.launches
    qt = to_torch(q).requires_grad_()
    o, lse = block_sparse_fwd(qt, to_torch(k), to_torch(v), to_torch(col),
                              to_torch(nvalid), block=block, causal=True)
    want_o, want_lse = fused_forward_reference(
        to_torch(q), to_torch(k), to_torch(v), to_torch(col),
        to_torch(nvalid), block=block, causal=True)
    assert torch.equal(o.detach(), want_o) and torch.equal(lse, want_lse)
    assert block_sparse_fwd.launches == before
    o.sum().backward()                 # the plain version is differentiable
    assert torch.isfinite(qt.grad).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, col, nvalid, _, block, _ = _case("float32", 2, None)
    qt, kt, vt = to_torch(q), to_torch(k), to_torch(v)
    ct, nt = to_torch(col), to_torch(nvalid)
    with pytest.raises(TypeError, match="dtype"):
        block_sparse_fwd(qt, kt.double(), vt, ct, nt, block=block)
    with pytest.raises(ValueError, match="block"):
        block_sparse_fwd(qt, kt, vt, ct, nt, block=24)
    with pytest.raises(ValueError, match="contiguous"):
        block_sparse_fwd(qt.transpose(2, 3).contiguous().transpose(2, 3),
                         kt, vt, ct, nt, block=block)
    with pytest.raises(TypeError, match="int32"):
        block_sparse_fwd(qt, kt, vt, ct.long(), nt, block=block)
    with pytest.raises(ValueError, match="head_dim"):
        block_sparse_fwd(qt[..., :24].contiguous(), kt[..., :24].contiguous(),
                         vt[..., :24].contiguous(), ct, nt, block=block)


def test_entry_point_follows_the_dtype():
    """bf16 inputs reach the tensor-core kernels (wgmma fed by TMA), fp32
    inputs the scalar ones, for the forward, dQ and dK/dV alike."""
    assert entry_point("fwd", torch.bfloat16) == "spion_block_sparse_fwd_bf16"
    assert entry_point("fwd", torch.float32) == "spion_block_sparse_fwd_f32"
    assert entry_point("dq", torch.bfloat16) == "spion_block_sparse_dq_bf16"
    assert entry_point("dkv", torch.float32) == "spion_block_sparse_dkv_f32"
    with pytest.raises(KeyError):
        entry_point("fwd", torch.float16)
    bf16 = (CSRC / "block_sparse_fwd_bf16.cu").read_text()
    f32 = (CSRC / "block_sparse_fwd_f32.cu").read_text()
    sm90 = (CSRC / "block_sparse_fwd_sm90.cuh").read_text()
    parts = (CSRC / "block_sparse_sm90.cuh").read_text()
    assert "spion_block_sparse_fwd_bf16" in bf16
    assert '#include "block_sparse_fwd_sm90.cuh"' in bf16
    assert '#include "block_sparse_fwd.cuh"' in f32 and "sm90" not in f32
    assert "block_sparse_fwd_kernel_sm90" in sm90     # profiled by this name
    assert "wgmma.mma_async" in parts and "cp.async.bulk.tensor" in parts
    assert "mbarrier.try_wait" in parts
    for kind in ("dq", "dkv"):
        assert entry_point(kind, torch.bfloat16) == \
            f"spion_block_sparse_{kind}_bf16"
        assert entry_point(kind, torch.float32) == \
            f"spion_block_sparse_{kind}_f32"
        bf16 = (CSRC / f"block_sparse_{kind}_bf16.cu").read_text()
        f32 = (CSRC / f"block_sparse_{kind}_f32.cu").read_text()
        sm90 = (CSRC / f"block_sparse_{kind}_sm90.cuh").read_text()
        assert f"spion_block_sparse_{kind}_bf16" in bf16
        assert f'#include "block_sparse_{kind}_sm90.cuh"' in bf16
        assert f'#include "block_sparse_{kind}.cuh"' in f32
        assert "sm90" not in f32
        # profiled by this name; products by wgmma, tiles by TMA
        assert f"block_sparse_{kind}_kernel_sm90" in sm90
        assert '#include "block_sparse_sm90.cuh"' in sm90
        assert "wgmma_ss<" in sm90 and "wgmma_rs<" in sm90
        assert "tma_load_2d" in sm90 or "issue_tile<" in sm90
        assert "mbar_wait" in sm90


def test_bf16_kernel_refuses_unaligned_inputs():
    """TMA and 16-byte loads need q, k and v on 16-byte boundaries."""
    t = torch.zeros(256, dtype=torch.bfloat16)
    _aligned(q=t[:128], k=t[8:136])
    with pytest.raises(ValueError, match="k must start on a 16-byte"):
        _aligned(q=t[:128], k=t[1:129])


def test_bf16_backward_wrappers_refuse_an_unaligned_do():
    """The bf16 dQ and dK/dV kernels read q, k, v and do by TMA or 16-byte
    copies, and dK/dV reads lse and delta by bulk copies: each must start
    on a 16-byte boundary."""
    t = torch.zeros(512, dtype=torch.bfloat16)
    f = torch.zeros(64, dtype=torch.float32)
    ok = dict(q=t[:128], k=t[128:256], v=t[256:384], do=t[384:512],
              lse=f[:32], delta=f[32:64])
    for kind in ("dq", "dkv"):
        _aligned_backward(kind, **ok)
        with pytest.raises(ValueError, match="do must start on a 16-byte"):
            _aligned_backward(kind, **dict(ok, do=t[383:511]))
    # lse and delta reach dK/dV by 16-byte bulk copies, dQ by plain loads
    _aligned_backward("dq", **dict(ok, lse=f[1:33]))
    with pytest.raises(ValueError, match="lse must start on a 16-byte"):
        _aligned_backward("dkv", **dict(ok, lse=f[1:33]))


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_card_sweep_covers_every_shape_of_the_bf16_kernel():
    cases = _chip_smoke().bf16_shape_cases()
    assert {(c["hd"], c["block"]) for c in cases} == {
        (hd, b) for hd in _HEAD_DIMS for b in (16, 32, 64, 80, 96, 128)}
    assert {(c["causal"], c["sw"]) for c in cases} == {
        (True, None), (False, None), (True, 48)}
    assert {c["G"] for c in cases} == {1, 4, 7}
    assert any(c["offsets"] for c in cases)
    assert any(c["bad_ids"] for c in cases)
    assert not all(c["bad_ids"] for c in cases)
    assert all(c["empty_rows"] and c["S"] % c["block"] == 0 for c in cases)
    # K/V of fewer rows than one 64-key tile: the TMA box reads past the end
    assert any(c["N"] * c["S"] < 64 for c in cases)


def test_card_backward_sweep_covers_every_shape_of_the_bf16_kernels():
    cases = _chip_smoke().bf16_backward_shape_cases()
    assert {(c["hd"], c["block"]) for c in cases} == {
        (hd, b) for hd in _HEAD_DIMS for b in (16, 32, 64, 80, 96, 128)}
    assert all(c["dtype"] == "bfloat16" for c in cases)
    assert {(c["causal"], c["sw"]) for c in cases} == {
        (True, None), (False, None), (True, 48)}
    assert {c["G"] for c in cases} == {1, 4, 7}
    assert any(c["offsets"] for c in cases)
    assert any(c["bad_ids"] for c in cases)
    assert not all(c["bad_ids"] for c in cases)
    assert {c["tables"] for c in cases} == {"plan", "fallback"}
    assert all(c["empty_rows"] and c["empty_cols"] and
               c["S"] % c["block"] == 0 for c in cases)
    # Q/dO and K/V of fewer rows than one 64-row TMA box
    assert any(c["N"] * c["G"] * c["S"] < 64 and c["N"] * c["S"] < 64
               for c in cases)


def test_bad_id_tables_list_the_same_tiles():
    """The card check's tables with out-of-range column ids list the same
    in-range tiles, in order, as the tables the plain version gets."""
    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    nrb, ncb = 12, 13
    col, nvalid = cs.random_tables(rng, nrb, ncb, causal=True,
                                   empty_rows=(1,), diag_offset=1)
    bad, bad_nv = cs.with_bad_ids(rng, col, nvalid, ncb)
    assert bad.dtype == np.int32 and bad_nv.dtype == np.int32
    listed = [bad[r, :bad_nv[r]] for r in range(nrb)]
    assert any(((x < 0) | (x >= ncb)).any() for x in listed)
    assert any(((bad[r, bad_nv[r]:] < 0) | (bad[r, bad_nv[r]:] >= ncb)).any()
               for r in range(nrb))
    for r in range(nrb):
        kept = [c for c in listed[r] if 0 <= c < ncb]
        assert kept == list(col[r, :nvalid[r]])


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a card, every entry point that picks a device raises unless
    the caller asks for the CPU; the train step takes its device from its
    tensors, and on a CUDA tensor it never takes the gather."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import Trainer, masters_of
    from repro_torch.models.registry import build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = tget_config("spion-lra").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, seq_len=64, batch=2)
    tree = {"w": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree, cfg)
    tr = Trainer(cfg, seq_len=64, batch=2, device="cpu")
    assert tr.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in tr.params.parameters())
    # a sparse train step whose tensors claim to be on the card: "jnp" (the
    # gather) raises there instead of running on the CPU
    params = masters_of(build(cfg).init(torch.Generator().manual_seed(0),
                                        device="cpu"))
    step = make_train_step(cfg, spion=True, sparse_kernel="jnp")
    assert cfg.spion.block_size == 64         # one block of 64 tokens
    tables = {"col_idx": np.zeros((cfg.num_layers, 1, 1), np.int32),
              "nvalid": np.ones((cfg.num_layers, 1), np.int32), "block": 64}
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
             "labels": torch.zeros((2, 64), dtype=torch.long)}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match="CPU tensors only"):
        step(params, None, batch, 0, tables)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_repro.py",
              ROOT / "examples" / "train_listops_spion_torch.py",
              ROOT / "examples" / "serve_batch_torch.py"]
    names = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files
             if "repro_torch" in str(f)}
    # the training slice's and the fault-tolerance slice's modules are
    # among the files checked
    assert {"launch/train.py", "launch/steps.py", "optim/adamw.py",
            "optim/grad.py", "optim/schedule.py", "core/pattern.py",
            "core/spion.py", "data/listops.py", "data/synthetic.py",
            "configs/spion_lra.py", "checkpoint/__init__.py",
            "checkpoint/manager.py", "checkpoint/msgpack_lite.py",
            "distributed/__init__.py", "distributed/fault.py",
            "distributed/chaos.py", "distributed/supervisor.py",
            "launch/supervise.py", "distributed/runtime.py",
            "distributed/sharding.py", "kernels/sharded.py",
            "launch/mesh.py", "data/pipeline.py"} <= names
    assert len(files) > 35
    # nor the packages the JAX package's checkpoints are written with
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                  "flax", "orbax")]
    assert not bad, bad
