"""Comparison models from the paper's §5 evaluation:

  - Original dense Transformer: the default (spion disabled).
  - BigBird / sliding-window:    fixed block patterns fed through the SAME
                                 BCSR machinery (pattern.bigbird_pattern).
  - Reformer:                    LSH-bucketed chunk attention (this module).
  - SPION-C / SPION-F / SPION-CF: SpionConfig.variant.

`fixed_pattern_tables(...)` lets any arch train with a static pattern from
step 0 — the BigBird/Longformer regime — so the baseline shares every
kernel and optimizer code path with SPION.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.pattern import bigbird_pattern, window_pattern
from repro_torch.core.sparse_attention import (bcsr_from_blockmask,
                                               build_sparsity_plan)


def fixed_pattern_tables(kind: str, seq_len: int, block: int, num_layers: int,
                         *, causal: bool = False, seed: int = 0, **kw):
    """Full SparsityPlan tables for a fixed pattern applied to every layer:
    the BigBird/Longformer baselines get the same plan-built transposed
    tables (true width KT*) as SPION. The plan is built once and copied to
    every layer; each stacked table is contiguous, as the kernel wrappers
    require (a broadcast view has stride 0)."""
    n = seq_len // block
    if kind == "bigbird":
        mask = bigbird_pattern(n, causal=causal, seed=seed, **kw)
    elif kind == "window":
        mask = window_pattern(n, causal=causal, **kw)
    else:
        raise ValueError(kind)
    K = int(mask.sum(axis=1).max())
    t = bcsr_from_blockmask(mask, block, max_k=K)
    plan = build_sparsity_plan(t.col_idx.numpy(), t.nvalid.numpy(), block)
    tables = {k: v[0].expand(num_layers, *v.shape[1:]).contiguous()
              for k, v in plan.tables.items() if torch.is_tensor(v)}
    tables["block"] = block
    return tables


# ---------------------------------------------------------------------------
# Reformer-style LSH attention (baseline)
# ---------------------------------------------------------------------------

def lsh_attention(q, k, v, *, num_hashes: int = 2, bucket_size: int = 32,
                  generator=None, rotations=None, causal: bool = False):
    """Angular-LSH chunked attention (Reformer, simplified): shared-QK
    hashing via random rotations; sort by bucket; attend within a chunk and
    its predecessor; average over hash rounds. q, k, v: (B, S, H, hd) ->
    (B, S, H, hd).

    The rotations are one (hd, n_buckets // 2) fp32 tensor per hash round:
    `rotations` when given, else drawn from `generator` (a
    torch.Generator on q's device); one of the two is required. The JAX
    package draws them with jax.random, whose numbers torch cannot
    reproduce."""
    B, S, H, hd = q.shape
    n_buckets = max(2, S // bucket_size)
    n_buckets = n_buckets + (n_buckets % 2)
    if rotations is None:
        if generator is None:
            raise ValueError("lsh_attention needs rotations= or generator=")
        rotations = [torch.randn((hd, n_buckets // 2), generator=generator,
                                 device=q.device) for _ in range(num_hashes)]
    if len(rotations) != num_hashes:
        raise ValueError(f"{len(rotations)} rotations for {num_hashes} hash "
                         f"rounds")

    def gather(x, idx):
        return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (
            x.dim() - 3)).expand(*idx.shape, *x.shape[3:]))

    nc = S // bucket_size
    pos = torch.arange(S, device=q.device)[None, :, None].expand(B, S, H)
    outs = []
    for R in rotations:
        R = torch.as_tensor(R, device=q.device)
        dt = torch.promote_types(q.dtype, R.dtype)
        proj = torch.einsum("bshd,df->bshf", q.to(dt), R.to(dt))
        buckets = torch.argmax(torch.cat([proj, -proj], -1), -1)  # (B,S,H)
        # stable sort by bucket, keep the inverse permutation
        order = torch.argsort(buckets * S + pos, dim=1, stable=True)
        inv = torch.argsort(order, dim=1, stable=True)
        qs, ks, vs = (gather(x, order) for x in (q, k, v))
        pc = gather(pos, order).reshape(B, nc, bucket_size, H)
        qc = qs.reshape(B, nc, bucket_size, H, hd)
        kc = ks.reshape(B, nc, bucket_size, H, hd)
        vc = vs.reshape(B, nc, bucket_size, H, hd)
        # attend to the own chunk and the previous one (Reformer)
        k2 = torch.cat([torch.roll(kc, 1, dims=1), kc], dim=2)
        v2 = torch.cat([torch.roll(vc, 1, dims=1), vc], dim=2)
        p2 = torch.cat([torch.roll(pc, 1, dims=1), pc], dim=2)
        s = torch.einsum("bcqhd,bckhd->bchqk", qc, k2)
        s = s.to(dt) / math.sqrt(hd)
        if causal:
            qpos = pc.permute(0, 1, 3, 2)      # (B,nc,H,bucket)
            kpos = p2.permute(0, 1, 3, 2)      # (B,nc,H,2*bucket)
            ok = qpos[..., :, None] >= kpos[..., None, :]
            s = torch.where(ok, s, -math.inf)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bchqk,bckhd->bcqhd", p, v2.to(p.dtype))
        outs.append(gather(o.reshape(B, S, H, hd), inv))
    return torch.stack(outs).mean(dim=0)
