"""Public wrapper around the block-sparse attention kernels.

`spion_attention_kernel(...)` is the kernel counterpart of
core.sparse_attention.bcsr_attention: it clamps the BCSR tables, groups the
query heads of each KV head (head order h = kv * G + g) and calls
`fused_block_sparse_attention`, the differentiable op whose forward and
backward launch the Hopper kernels on CUDA tensors and run their plain
versions on CPU tensors. Under an active mesh of more than one rank
(distributed.sharding.mesh_context) it goes through
kernels/sharded.sharded_fused_attention on the rank's shard.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import active_mesh, heads_split
from repro_torch.kernels.block_sparse_attn import fused_block_sparse_attention
from repro_torch.kernels.sharded import sharded_fused_attention


def _prep_tables(bcsr):
    col = bcsr.col_idx.clamp(min=0).to(torch.int32).contiguous()
    nvalid = bcsr.nvalid.to(torch.int32).contiguous()
    return col, nvalid


def _split_heads(q, k, v):
    """(B,S,H,hd)x(B,S,KV,hd) -> q (B, KV, G, S, hd), k/v (B, KV, S, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    return qh, kh, vh, (B, S, H, hd, KV, G)


def _flatten_bk(qh, kh, vh, dims):
    """The kernel's flat B*KV leading axis, contiguous."""
    B, S, H, hd, KV, G = dims
    return (qh.reshape(B * KV, G, S, hd).contiguous(),
            kh.reshape(B * KV, S, hd).contiguous(),
            vh.reshape(B * KV, S, hd).contiguous())


def _merge_heads(o, dims):
    """(B, KV, G, S, hd) -> (B, S, H, hd)."""
    B, S, H, hd, KV, G = dims
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def spion_attention_kernel(cfg, q, k, v, bcsr, *, row_idx=None,
                           nvalid_t=None, halo=None, config=None):
    """Block-sparse attention of q (B,S,H,hd) over k, v (B,S,KV,hd) with the
    layer's BCSR tables; returns (B,S,H,hd), differentiable in q, k, v.
    `row_idx`/`nvalid_t` are a SparsityPlan's transposed tables (width
    KT*) for the dK/dV backward; without them the backward builds them at
    width nrb. `halo` is the plan's (left, right) column extent in blocks,
    which lets a mesh with a 'seq' axis shard the sequence. `config` is the
    autotuned dispatch.KernelConfig for this pattern (kernels/autotune.py):
    it never changes results."""
    col, nvalid = _prep_tables(bcsr)
    qh, kh, vh, dims = _split_heads(q, k, v)
    B, S, H, hd, KV, G = dims
    mesh = active_mesh()
    if mesh is not None:
        o = sharded_fused_attention(
            mesh, qh, kh, vh, col, nvalid, block=bcsr.block,
            causal=cfg.causal, sliding_window=cfg.sliding_window,
            row_idx=row_idx, nvalid_t=nvalid_t, halo=halo, config=config,
            heads_split=heads_split(cfg))
        return _merge_heads(o, dims)
    qf, kf, vf = _flatten_bk(qh, kh, vh, dims)
    o = fused_block_sparse_attention(qf, kf, vf, col, nvalid,
                                     block=bcsr.block, causal=cfg.causal,
                                     sliding_window=cfg.sliding_window,
                                     row_idx=row_idx, nvalid_t=nvalid_t,
                                     config=config)
    return _merge_heads(o.reshape(B, KV, G, S, hd), dims)
