"""Block-sparse flash attention: the Hopper kernels, their wrappers, their
plain PyTorch versions and the differentiable op that joins them.

Three kernels replace the three TPU kernels of the JAX package
(`src/repro/kernels/block_sparse_attn.py`), CUDA C++ for `sm_90a` in
`csrc/`, built with nvcc into one plain-C shared library at first use and
called through ctypes:
  - `block_sparse_fwd` (`_fwd_kernel`): for each (batch*kv-head n, query
    head g, row-block r) the K/V tiles listed in `col_idx[r, :nvalid[r]]`
    with an online softmax in fp32 and the paper's Alg. 6 zero-correction
    in the final denominator; returns the context and the per-row
    log-sum-exp. bf16 inputs run the tensor-core kernel
    (`block_sparse_fwd_sm90.cuh`: wgmma fed by TMA through a ring of K/V
    tiles, the G heads of a kv head over the same tiles); fp32 inputs, which
    exist for parity checks, the scalar one (`block_sparse_fwd.cuh`);
  - `block_sparse_dq` (`_dq_kernel`): dq over the same listed tiles; bf16
    inputs run the tensor-core kernel (`block_sparse_dq_sm90.cuh`: the
    forward's K/V ring, dS in three bf16 terms), fp32 inputs the scalar
    one (`block_sparse_dq.cuh`);
  - `block_sparse_dkv` (`_dkv_kernel`): dk and dv over the transposed
    tables `row_idx[c, :nvalid_t[c]]`, the G query heads of a kv head
    summed inside the program; bf16 inputs run the tensor-core kernel
    (`block_sparse_dkv_sm90.cuh`: K/V of a column block once, Q/dO tiles,
    lse and delta through a TMA ring), fp32 inputs the scalar one
    (`block_sparse_dkv.cuh`).
Each kernel's design and bound on the H100 are described at the top of its
`.cuh` file.

`fused_block_sparse_attention` is the differentiable op (the JAX package's
custom-VJP `_fused_op`): its forward is `block_sparse_fwd` and keeps o and
lse; its backward computes delta = rowsum(dO * O) in fp32 with plain torch
ops, then runs dQ and dK/dV. The transposed tables come from a SparsityPlan
(width KT*) or, without one, from `bcsr_transpose` in every backward (width
KT = nrb). The Alg. 6 correction enters the backward only through lse: the
pruned positions have score 0 and value 0, so they carry no gradient.

On CPU tensors each wrapper runs its plain version (`fused_forward_reference`,
`fused_dq_reference`, `fused_dkv_reference`); on CUDA tensors it launches
its kernel, counted in `<wrapper>.launches`, or raises.
"""
from __future__ import annotations

import functools
import hashlib
import math
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch.core.sparse_attention import bcsr_transpose

NEG = -1e30

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# build products go under the repository's (git-ignored) build/ directory
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


class KernelError(RuntimeError):
    """The kernels could not be built, loaded or launched. Never retried
    (distributed/fault.StepSupervisor): no replay in the same process
    heals it."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the block-sparse attention kernels "
                      "are built from src/repro_torch/kernels/csrc at first "
                      "use and need the CUDA toolkit")


def library_path() -> pathlib.Path:
    """Build (once per source digest) and return the kernels' shared
    library. Each .cu file compiles in its own nvcc process, all started
    together; ptxas' register and shared-memory report goes to build.log
    beside the library."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    out = _BUILD_ROOT / digest.hexdigest()[:16]
    lib = out / "libspion_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [out / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    (out / "build.log").write_text("\n".join(logs))
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode:
            raise KernelError(f"nvcc failed on {src.name}:\n{log[-4000:]}")
    tmp = out / f"libspion_kernels.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise KernelError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    for obj in objs:
        obj.unlink()
    return lib


@functools.lru_cache(maxsize=1)
def load_library():
    """The loaded kernel library with its ctypes signatures declared."""
    import ctypes
    try:   # an OSError here (nvcc not executable, a bad .so) is no I/O hiccup
        lib = ctypes.CDLL(str(library_path()))
    except OSError as e:
        raise KernelError(f"cannot build or load the kernel library: "
                          f"{e}") from e
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for tag in _DTYPES.values():
        fn = getattr(lib, f"spion_block_sparse_fwd_{tag}")
        fn.argtypes = [ptr] * 7 + [cint] * 13 + [ctypes.c_float, ptr]
        fn.restype = cint
        for kind in ("dq", "dkv"):
            fn = getattr(lib, f"spion_block_sparse_{kind}_{tag}")
            fn.argtypes = [ptr] * 10 + [cint] * 13 + [ctypes.c_float, ptr]
            fn.restype = cint
    lib.spion_cuda_error_string.argtypes = [cint]
    lib.spion_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _offsets(offsets):
    if offsets is None:
        return 0, 0
    row0, col0 = (int(x) for x in offsets)
    return row0, col0


def _tile_masks(qblk, kblk, live, block, causal, sliding_window):
    """(..., block, block) validity of the tiles at global row-block ids
    `qblk` and column-block ids `kblk` (broadcastable long tensors), for
    table entries that are `live`."""
    ar = torch.arange(block, device=live.device)
    qpos = (qblk * block)[..., None, None] + ar[:, None]
    kpos = (kblk * block)[..., None, None] + ar[None, :]
    ok = live[..., None, None].expand(*live.shape, block, block)
    if causal:
        ok = ok & (qpos >= kpos)
    if sliding_window is not None:
        ok = ok & (qpos - kpos < sliding_window)
    return ok


def _listed_masks(col_idx, nvalid, block, causal, sliding_window, offsets):
    """(nrb, K, block, block) validity of the tiles a row-block lists."""
    nrb, K = col_idx.shape
    row0, col0 = _offsets(offsets)
    dev = col_idx.device
    live = torch.arange(K, device=dev)[None, :] < nvalid.long()[:, None]
    rows = (torch.arange(nrb, device=dev) + row0)[:, None]
    return _tile_masks(rows, col_idx.long() + col0, live, block, causal,
                       sliding_window)


def fused_forward_reference(q, k, v, col_idx, nvalid, *, block, causal=False,
                            sliding_window=None, offsets=None, seq_len=None):
    """Plain PyTorch version of the forward kernel: the same (o, lse) in one
    softmax over all listed tiles instead of an online one.

    q (N, G, S, hd); k, v (N, Sk, hd); col_idx (nrb, K) clamped to >= 0;
    nvalid (nrb,). Returns o (N, G, S, hd) in q's dtype and lse (N, G, S)
    fp32. `offsets` = (row0, col0) rebases local block indices to global
    ones and `seq_len` (default S) is the global row total of the
    non-causal zero-correction."""
    N, G, S, hd = q.shape
    nrb, K = col_idx.shape
    row0, _ = _offsets(offsets)
    seq_len = S if seq_len is None else int(seq_len)
    dev = q.device
    col = col_idx.long()
    qf = q.float().reshape(N, G, nrb, block, hd)
    kg = k.float().reshape(N, -1, block, hd)[:, col]    # (N, nrb, K, blk, hd)
    vg = v.float().reshape(N, -1, block, hd)[:, col]
    s = torch.einsum("ngrph,nrcqh->ngrpcq", qf, kg) * (1.0 / math.sqrt(hd))
    ok = _listed_masks(col_idx, nvalid, block, causal, sliding_window,
                       offsets).permute(0, 2, 1, 3)        # (nrb, blk, K, blk)
    s = torch.where(ok, s, NEG)
    m = s.amax(dim=(-2, -1)).clamp(min=NEG)                # (N, G, nrb, blk)
    p = torch.where(ok, torch.exp(s - m[..., None, None]), 0.0)
    l = p.sum(dim=(-2, -1))
    acc = torch.einsum("ngrpcq,nrcqh->ngrph", p, vg)
    stored = ok.sum(dim=(-2, -1)).float()                  # (nrb, blk)
    if causal:
        rows = ((torch.arange(nrb, device=dev) + row0) * block)[:, None] + \
            torch.arange(block, device=dev)
        rt = (rows + 1).float()
        if sliding_window is not None:
            rt = rt.clamp(max=float(sliding_window))
    else:
        rt = torch.full((nrb, block), float(seq_len), device=dev)
    denom = l + (rt - stored).clamp(min=0.0) * torch.exp(-m)
    safe = torch.where(denom == 0.0, 1.0, denom)
    o = (acc / safe[..., None]).to(q.dtype).reshape(N, G, S, hd)
    lse = torch.where(denom > 0.0, m + torch.log(safe), math.inf)
    return o, lse.reshape(N, G, S)


def fused_dq_reference(q, k, v, do, lse, delta, col_idx, nvalid, *, block,
                       causal=False, sliding_window=None, offsets=None):
    """Plain PyTorch version of the dQ kernel, with the reference's formulas:
    over the listed tiles, p = exp(s - lse) (0 where masked), dp = dO v^T,
    ds = p (dp - delta), dq = scale * sum ds k. Shapes as the forward's, with
    do (N, G, S, hd) and lse, delta (N, G, S) fp32; returns dq fp32."""
    N, G, S, hd = q.shape
    nrb, K = col_idx.shape
    scale = 1.0 / math.sqrt(hd)
    col = col_idx.long()
    qf = q.float().reshape(N, G, nrb, block, hd)
    dof = do.float().reshape(N, G, nrb, block, hd)
    kg = k.float().reshape(N, -1, block, hd)[:, col]    # (N, nrb, K, blk, hd)
    vg = v.float().reshape(N, -1, block, hd)[:, col]
    ok = _listed_masks(col_idx, nvalid, block, causal, sliding_window,
                       offsets)                            # (nrb, K, blk, blk)
    s = torch.einsum("ngrph,nrcqh->ngrcpq", qf, kg) * scale
    lse_ = lse.reshape(N, G, nrb, 1, block, 1)
    p = torch.where(ok, torch.exp(s - lse_), 0.0)
    dp = torch.einsum("ngrph,nrcqh->ngrcpq", dof, vg)
    ds = p * (dp - delta.reshape(N, G, nrb, 1, block, 1))
    dq = torch.einsum("ngrcpq,nrcqh->ngrph", ds, kg) * scale
    return dq.reshape(N, G, S, hd)


def fused_dkv_reference(q, k, v, do, lse, delta, row_idx, nvalid_t, *, block,
                        causal=False, sliding_window=None, offsets=None):
    """Plain PyTorch version of the dK/dV kernel, with the reference's
    formulas: for column block c over the row blocks row_idx[c, :nvalid_t[c]]
    and every query head g, dv = sum p^T dO and dk = scale * sum ds^T q, each
    head's sum over the listed row blocks added in turn. row_idx (ncb, KT)
    holds in-range row ids (clamped here); returns (dk, dv) (N, Sk, hd) fp32."""
    N, G, S, hd = q.shape
    Sk = k.shape[1]
    ncb, KT = row_idx.shape
    nrb = S // block
    row0, col0 = _offsets(offsets)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    rows = row_idx.long().clamp(0, max(nrb - 1, 0))
    qg = q.float().reshape(N, G, nrb, block, hd)[:, :, rows]  # (N,G,ncb,KT,p,h)
    dog = do.float().reshape(N, G, nrb, block, hd)[:, :, rows]
    lseg = lse.reshape(N, G, nrb, block)[:, :, rows]         # (N,G,ncb,KT,p)
    deltag = delta.reshape(N, G, nrb, block)[:, :, rows]
    kc = k.float().reshape(N, ncb, block, hd)
    vc = v.float().reshape(N, ncb, block, hd)
    live = torch.arange(KT, device=dev)[None, :] < nvalid_t.long()[:, None]
    cols = (torch.arange(ncb, device=dev) + col0)[:, None]
    ok = _tile_masks(rows + row0, cols, live, block, causal,
                     sliding_window)                       # (ncb, KT, p, q)
    s = torch.einsum("ngctph,ncqh->ngctpq", qg, kc) * scale
    p = torch.where(ok, torch.exp(s - lseg[..., None]), 0.0)
    dp = torch.einsum("ngctph,ncqh->ngctpq", dog, vc)
    ds = p * (dp - deltag[..., None])
    dv = torch.einsum("ngctpq,ngctph->ngcqh", p, dog)
    dk = torch.einsum("ngctpq,ngctph->ngcqh", ds, qg) * scale
    # per head, then the heads in turn (the kernel's order)
    dk_sum, dv_sum = dk[:, 0], dv[:, 0]
    for g in range(1, G):
        dk_sum = dk_sum + dk[:, g]
        dv_sum = dv_sum + dv[:, g]
    return dk_sum.reshape(N, Sk, hd), dv_sum.reshape(N, Sk, hd)


def _check(q, k, v, block):
    N, G, S, hd = q.shape
    if k.shape != v.shape or k.dim() != 3 or k.shape[0] != N or \
            k.shape[2] != hd:
        raise ValueError(f"k/v must be (N={N}, Sk, hd={hd}); got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if block % 16 or not 16 <= block <= 128:
        raise ValueError(f"block {block} must be a multiple of 16 in "
                         f"[16, 128]")
    if S % block or k.shape[1] % block:
        raise ValueError(f"S={S} and Sk={k.shape[1]} must be multiples of "
                         f"block {block}")
    _same_device_contiguous(q, k=k, v=v)


def _check_tables(idx, nidx, blocks, what):
    """Tables (blocks, width) / (blocks,) int32 of one kernel."""
    if idx.dim() != 2 or idx.shape[0] != blocks or \
            tuple(nidx.shape) != (blocks,):
        raise ValueError(f"tables {what} {tuple(idx.shape)} / "
                         f"{tuple(nidx.shape)} must be ({blocks}, width) / "
                         f"({blocks},)")
    if idx.dtype != torch.int32 or nidx.dtype != torch.int32:
        raise TypeError(f"{what} must be int32")


def _check_grads(q, do, lse, delta):
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {tuple(q.shape[:3])} fp32; got "
                             f"{tuple(t.shape)} {t.dtype}")


def _same_device_contiguous(q, **tensors):
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")


def _aligned(**tensors):
    """The bf16 kernels read their tiles by TMA and 16-byte copies: each
    tensor so read must start on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the bf16 kernel (data_ptr {t.data_ptr()})")


def _aligned_backward(kind, q, k, v, do, lse, delta):
    """The bf16 backward kernels read q, k, v and do by TMA or 16-byte
    copies, and dK/dV reads lse and delta by bulk copies too."""
    _aligned(q=q, k=k, v=v, do=do)
    if kind == "dkv":
        _aligned(lse=lse, delta=delta)


def entry_point(kind, dtype):
    """Name of the C entry point of kernel `kind` ("fwd", "dq", "dkv") for
    inputs of `dtype`: spion_block_sparse_fwd_bf16 is the tensor-core
    forward, spion_block_sparse_fwd_f32 the scalar one."""
    return f"spion_block_sparse_{kind}_{_DTYPES[dtype]}"


def _launch(kind, q, *args):
    """Call the C entry point `kind` for q's dtype on the current stream of
    q's device; raise KernelError with CUDA's message if the launch
    fails."""
    if q.device.type != "cuda":
        raise ValueError(f"the block-sparse kernels run on cuda or cpu "
                         f"tensors, not {q.device}")
    lib = load_library()
    fn = getattr(lib, entry_point(kind, q.dtype))
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.spion_cuda_error_string(rc).decode()
        raise KernelError(f"block_sparse_{kind} launch failed: {msg} ({rc})")


def block_sparse_fwd(q, k, v, col_idx, nvalid, *, block, causal=False,
                     sliding_window=None, offsets=None, seq_len=None):
    """(o, lse) of block-sparse attention; see `fused_forward_reference` for
    the arguments. CPU tensors take the plain version; CUDA tensors launch
    the Hopper kernel (counted in `block_sparse_fwd.launches`): in bf16 the
    tensor-core one, which needs q, k and v on 16-byte boundaries. Not
    differentiable itself: `fused_block_sparse_attention` is."""
    _check(q, k, v, block)
    N, G, S, hd = q.shape
    _check_tables(col_idx, nvalid, S // block, "col_idx / nvalid")
    _same_device_contiguous(q, col_idx=col_idx, nvalid=nvalid)
    if q.device.type == "cpu":
        return fused_forward_reference(
            q, k, v, col_idx, nvalid, block=block, causal=causal,
            sliding_window=sliding_window, offsets=offsets, seq_len=seq_len)
    if q.dtype == torch.bfloat16:
        _aligned(q=q, k=k, v=v)
    nrb, K = col_idx.shape
    row0, col0 = _offsets(offsets)
    o = torch.empty_like(q)
    lse = torch.empty((N, G, S), dtype=torch.float32, device=q.device)
    _launch("fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            col_idx.data_ptr(), nvalid.data_ptr(), o.data_ptr(),
            lse.data_ptr(), N, G, S, k.shape[1], hd, nrb, K, block,
            int(bool(causal)),
            -1 if sliding_window is None else int(sliding_window),
            S if seq_len is None else int(seq_len), row0, col0,
            1.0 / math.sqrt(hd))
    block_sparse_fwd.launches += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, idx, nidx, out0, out1, *, block,
              causal, sliding_window, offsets):
    N, G, S, hd = q.shape
    row0, col0 = _offsets(offsets)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), idx.data_ptr(),
            nidx.data_ptr(), out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), N, G, S, k.shape[1],
            hd, S // block, k.shape[1] // block, idx.shape[1], block,
            int(bool(causal)),
            -1 if sliding_window is None else int(sliding_window), row0,
            col0, 1.0 / math.sqrt(hd))


def block_sparse_dq(q, k, v, do, lse, delta, col_idx, nvalid, *, block,
                    causal=False, sliding_window=None, offsets=None):
    """dq (N, G, S, hd) fp32 of block-sparse attention; see
    `fused_dq_reference`. CPU tensors take the plain version; CUDA tensors
    launch the Hopper kernel (counted in `block_sparse_dq.launches`): in
    bf16 the tensor-core one, which needs q, k, v and do on 16-byte
    boundaries."""
    _check(q, k, v, block)
    _check_grads(q, do, lse, delta)
    _check_tables(col_idx, nvalid, q.shape[2] // block, "col_idx / nvalid")
    _same_device_contiguous(q, do=do, lse=lse, delta=delta, col_idx=col_idx,
                            nvalid=nvalid)
    kw = dict(block=block, causal=causal, sliding_window=sliding_window,
              offsets=offsets)
    if q.device.type == "cpu":
        return fused_dq_reference(q, k, v, do, lse, delta, col_idx, nvalid,
                                  **kw)
    if q.dtype == torch.bfloat16:
        _aligned_backward("dq", q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("dq", q, *_bwd_args(q, k, v, do, lse, delta, col_idx, nvalid,
                                dq, None, **kw))
    block_sparse_dq.launches += 1
    return dq


def block_sparse_dkv(q, k, v, do, lse, delta, row_idx, nvalid_t, *, block,
                     causal=False, sliding_window=None, offsets=None):
    """(dk, dv) (N, Sk, hd) fp32 of block-sparse attention over the
    transposed tables row_idx (ncb, KT) / nvalid_t (ncb,); see
    `fused_dkv_reference`. CPU tensors take the plain version; CUDA tensors
    launch the Hopper kernel (counted in `block_sparse_dkv.launches`): in
    bf16 the tensor-core one, which needs q, k, v, do, lse and delta on
    16-byte boundaries."""
    _check(q, k, v, block)
    _check_grads(q, do, lse, delta)
    _check_tables(row_idx, nvalid_t, k.shape[1] // block,
                  "row_idx / nvalid_t")
    _same_device_contiguous(q, do=do, lse=lse, delta=delta, row_idx=row_idx,
                            nvalid_t=nvalid_t)
    kw = dict(block=block, causal=causal, sliding_window=sliding_window,
              offsets=offsets)
    if q.device.type == "cpu":
        return fused_dkv_reference(q, k, v, do, lse, delta, row_idx,
                                   nvalid_t, **kw)
    if q.dtype == torch.bfloat16:
        _aligned_backward("dkv", q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _launch("dkv", q, *_bwd_args(q, k, v, do, lse, delta, row_idx, nvalid_t,
                                 dk, dv, **kw))
    block_sparse_dkv.launches += 1
    return dk, dv


block_sparse_fwd.launches = 0
block_sparse_dq.launches = 0
block_sparse_dkv.launches = 0


class _FusedAttention(torch.autograd.Function):
    """The differentiable op: forward kernel, then dQ and dK/dV kernels in
    the backward. row_idx / nvalid_t None is the fallback that rebuilds the
    transposed tables (width nrb) in every backward."""

    @staticmethod
    def forward(ctx, q, k, v, col_idx, nvalid, row_idx, nvalid_t, kw):
        o, lse = block_sparse_fwd(q, k, v, col_idx, nvalid, **kw)
        ctx.save_for_backward(q, k, v, o, lse, col_idx, nvalid, row_idx,
                              nvalid_t)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, col_idx, nvalid, row_idx, nvalid_t = \
            ctx.saved_tensors
        kw = dict(ctx.kw)
        kw.pop("seq_len")       # the correction reaches the backward via lse
        block = kw["block"]
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        if row_idx is None:
            row_idx, nvalid_t = bcsr_transpose(col_idx, nvalid,
                                               ncb=k.shape[1] // block)
        dq = block_sparse_dq(q, k, v, do, lse, delta, col_idx, nvalid, **kw)
        dk, dv = block_sparse_dkv(q, k, v, do, lse, delta, row_idx,
                                  nvalid_t, **kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def fused_block_sparse_attention(q, k, v, col_idx, nvalid, *, block,
                                 causal=False, sliding_window=None,
                                 row_idx=None, nvalid_t=None, offsets=None,
                                 seq_len=None):
    """q (N, G, S, hd) — G query heads share each kv head; k, v (N, Sk, hd);
    col_idx (nrb, K) clamped, nvalid (nrb,), int32. Returns o (N, G, S, hd).

    Differentiable in q, k and v through the dQ and dK/dV kernels (dK/dV sum
    over the G query heads of each kv head). A SparsityPlan's transposed
    tables `row_idx (ncb, KT*)` / `nvalid_t (ncb,)` set the dK/dV width to
    the true column population; without them every backward builds them
    with `bcsr_transpose` at width KT = ncb. `offsets` / `seq_len` as in
    `fused_forward_reference`."""
    kw = dict(block=int(block), causal=bool(causal),
              sliding_window=None if sliding_window is None
              else int(sliding_window), offsets=offsets,
              seq_len=None if seq_len is None else int(seq_len))
    if row_idx is not None:
        row_idx = row_idx.to(torch.int32).contiguous()
        nvalid_t = nvalid_t.to(torch.int32).contiguous()
    return _FusedAttention.apply(q, k, v, col_idx, nvalid, row_idx, nvalid_t,
                                 kw)
