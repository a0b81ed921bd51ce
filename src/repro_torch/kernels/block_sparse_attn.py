"""Block-sparse flash-attention forward: the Hopper kernel, its wrapper and
its plain PyTorch version.

`block_sparse_fwd` replaces the TPU kernel `_fwd_kernel` of the JAX package
(`src/repro/kernels/block_sparse_attn.py`, host function `_fused_forward`).
For each (batch*kv-head n, query head g, row-block r) it streams the K/V
tiles listed in `col_idx[r, :nvalid[r]]` with an online softmax in fp32 and
applies the paper's Alg. 6 zero-correction to the final denominator; it
returns the context and the per-row log-sum-exp. The kernel is CUDA C++ for
`sm_90a` (`csrc/`), built with nvcc into a plain-C shared library at first
use and called through ctypes. Its design and its bound on the H100 are
described at the top of `csrc/block_sparse_fwd.cuh`.

On CPU tensors the wrapper runs `fused_forward_reference`, the plain version
of the same function; on CUDA tensors it launches the kernel or raises.
Gradients are not supported yet: the backward kernels (`_dq_kernel`,
`_dkv_kernel`) come with the training path.
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

NEG = -1e30

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# build products go under the repository's (git-ignored) build/ directory
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_ENTRY = {torch.float32: "spion_block_sparse_fwd_f32",
          torch.bfloat16: "spion_block_sparse_fwd_bf16"}
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the block-sparse attention kernel is "
                       "built from src/repro_torch/kernels/csrc at first use "
                       "and needs the CUDA toolkit")


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
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log[-4000:]}")
    tmp = out / f"libspion_kernels.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or nothing
    for obj in objs:
        obj.unlink()
    return lib


@functools.lru_cache(maxsize=1)
def load_library():
    """The loaded kernel library with its ctypes signatures declared."""
    import ctypes
    lib = ctypes.CDLL(str(library_path()))
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [cint] * 13 + [ctypes.c_float, ptr]
        fn.restype = cint
    lib.spion_cuda_error_string.argtypes = [cint]
    lib.spion_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _offsets(offsets):
    if offsets is None:
        return 0, 0
    row0, col0 = (int(x) for x in offsets)
    return row0, col0


def fused_forward_reference(q, k, v, col_idx, nvalid, *, block, causal=False,
                            sliding_window=None, offsets=None, seq_len=None):
    """Plain PyTorch version of the kernel: the same (o, lse) in one
    softmax over all listed tiles instead of an online one.

    q (N, G, S, hd); k, v (N, Sk, hd); col_idx (nrb, K) clamped to >= 0;
    nvalid (nrb,). Returns o (N, G, S, hd) in q's dtype and lse (N, G, S)
    fp32. `offsets` = (row0, col0) rebases local block indices to global
    ones and `seq_len` (default S) is the global row total of the
    non-causal zero-correction."""
    N, G, S, hd = q.shape
    nrb, K = col_idx.shape
    row0, col0 = _offsets(offsets)
    seq_len = S if seq_len is None else int(seq_len)
    dev = q.device
    col = col_idx.long()
    qf = q.float().reshape(N, G, nrb, block, hd)
    kg = k.float().reshape(N, -1, block, hd)[:, col]    # (N, nrb, K, blk, hd)
    vg = v.float().reshape(N, -1, block, hd)[:, col]
    s = torch.einsum("ngrph,nrcqh->ngrpcq", qf, kg) * (1.0 / math.sqrt(hd))
    ar = torch.arange(block, device=dev)
    rows = ((torch.arange(nrb, device=dev) + row0) * block)[:, None] + ar
    qpos = rows[:, :, None, None]                          # (nrb, blk, 1, 1)
    kpos = (((col + col0) * block)[:, None, :, None]
            + ar[None, None, None, :])                     # (nrb, 1, K, blk)
    live = torch.arange(K, device=dev)[None, :] < nvalid.long()[:, None]
    ok = live[:, None, :, None].expand(nrb, block, K, block)
    if causal:
        ok = ok & (qpos >= kpos)
    if sliding_window is not None:
        ok = ok & (qpos - kpos < sliding_window)
    s = torch.where(ok, s, NEG)
    m = s.amax(dim=(-2, -1)).clamp(min=NEG)                # (N, G, nrb, blk)
    p = torch.where(ok, torch.exp(s - m[..., None, None]), 0.0)
    l = p.sum(dim=(-2, -1))
    acc = torch.einsum("ngrpcq,nrcqh->ngrph", p, vg)
    stored = ok.sum(dim=(-2, -1)).float()                  # (nrb, blk)
    if causal:
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


def _check(q, k, v, col_idx, nvalid, block):
    N, G, S, hd = q.shape
    if k.shape != v.shape or k.dim() != 3 or k.shape[0] != N or \
            k.shape[2] != hd:
        raise ValueError(f"k/v must be (N={N}, Sk, hd={hd}); got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_ENTRY)}; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if block % 16 or not 16 <= block <= 128:
        raise ValueError(f"block {block} must be a multiple of 16 in "
                         f"[16, 128]")
    nrb = col_idx.shape[0]
    if col_idx.dim() != 2 or nrb * block != S or k.shape[1] % block or \
            tuple(nvalid.shape) != (nrb,):
        raise ValueError(f"tables col_idx {tuple(col_idx.shape)} / nvalid "
                         f"{tuple(nvalid.shape)} do not tile S={S}, "
                         f"Sk={k.shape[1]} at block {block}")
    if col_idx.dtype != torch.int32 or nvalid.dtype != torch.int32:
        raise TypeError("col_idx and nvalid must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("col_idx", col_idx),
                    ("nvalid", nvalid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def block_sparse_fwd(q, k, v, col_idx, nvalid, *, block, causal=False,
                     sliding_window=None, offsets=None, seq_len=None):
    """(o, lse) of block-sparse attention; see `fused_forward_reference` for
    the arguments. CPU tensors take the plain version; CUDA tensors launch
    the Hopper kernel (counted in `block_sparse_fwd.launches`)."""
    _check(q, k, v, col_idx, nvalid, block)
    if q.device.type == "cpu":
        return fused_forward_reference(
            q, k, v, col_idx, nvalid, block=block, causal=causal,
            sliding_window=sliding_window, offsets=offsets, seq_len=seq_len)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_fwd runs on cuda or cpu tensors, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "block_sparse_fwd has no gradient yet: the backward kernels "
            "arrive with the training slice")
    N, G, S, hd = q.shape
    nrb, K = col_idx.shape
    row0, col0 = _offsets(offsets)
    lib = load_library()
    o = torch.empty_like(q)
    lse = torch.empty((N, G, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), col_idx.data_ptr(),
            nvalid.data_ptr(), o.data_ptr(), lse.data_ptr(), N, G, S,
            k.shape[1], hd, nrb, K, block, int(bool(causal)),
            -1 if sliding_window is None else int(sliding_window),
            S if seq_len is None else int(seq_len), row0, col0,
            1.0 / math.sqrt(hd), stream)
    if rc:
        msg = lib.spion_cuda_error_string(rc).decode()
        raise RuntimeError(f"block_sparse_fwd launch failed: {msg} ({rc})")
    block_sparse_fwd.launches += 1
    return o, lse


block_sparse_fwd.launches = 0
