"""SparseAttentionExec — the single owner of one resolved sparse-attention
execution.

  - `tables` — the SparsityPlan tensors (col_idx / nvalid and, when
    plan-built, row_idx / nvalid_t), stacked over layers;
  - `block` and `phase` — the static metadata.

`phase` is "train" | "prefill" | "decode". Train and prefill share
`attend()` (full-sequence block-sparse attention: the Hopper kernels or
the plain gather per `resolve_kernel`, both differentiable); decode uses
`decode()` / `decode_paged()` — the pattern-bounded KV-cache gather, which
reads only the cache blocks the query position's row-block lists.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_attention import (BCSR, PLAN_TABLE_KEYS,
                                               bcsr_attention,
                                               paged_sparse_decode_attention,
                                               sparse_decode_attention)

_PHASES = ("train", "prefill", "decode")


def resolve_kernel(cfg, q) -> str:
    """What the sparse forward of `q` dispatches to ("fused" / "jnp").

    The tensor's device picks the path. On CUDA tensors it is always the
    Hopper kernel ("fused"), and cfg.spion.kernel="jnp" raises. On CPU
    tensors "auto" takes the plain gather ("jnp", the JAX package's name for
    it) and "fused" the kernel's plain version. The JAX package resolves
    meshless "auto" to its gather everywhere but on a TPU, because its GPU
    lowering was never ported; here the kernel exists."""
    impl = cfg.spion.kernel
    if impl not in ("auto", "fused", "jnp"):
        raise ValueError(f"cfg.spion.kernel must be auto/fused/jnp, got "
                         f"{impl!r}")
    if q.is_cuda:
        if impl == "jnp":
            raise ValueError(
                'cfg.spion.kernel="jnp" asks for the gather, which runs on '
                "CPU tensors only; on the card the sparse forward is the "
                'Hopper kernel (use "auto" or "fused")')
        return "fused"
    return "jnp" if impl == "auto" else impl


class SparseAttentionExec:
    """One phase's resolved sparse-attention execution. See module docstring.

    Construct via `coerce` (an existing exec, a tables dict payload with an
    int 'block', or None), `from_plan` (a SparsityPlan), or directly with
    stacked tables (tensors or numpy arrays). `attend`/`decode` consume
    the PER-LAYER slices of `scan_tables()`."""

    def __init__(self, tables, *, block, phase="train"):
        if phase not in _PHASES:
            raise ValueError(f"phase must be one of {_PHASES}, got {phase!r}")
        self.tables = {k: torch.as_tensor(tables[k]) for k in PLAN_TABLE_KEYS
                       if tables is not None and tables.get(k) is not None}
        self.block = int(block)
        self.phase = phase

    def __repr__(self):
        shapes = {k: tuple(v.shape) for k, v in self.tables.items()}
        return (f"SparseAttentionExec(phase={self.phase!r}, "
                f"block={self.block}, tables={shapes})")

    # -- constructors ---------------------------------------------------------

    @classmethod
    def coerce(cls, spion, *, phase=None):
        """None | exec | tables-dict payload -> exec (or None)."""
        if spion is None:
            return None
        if isinstance(spion, cls):
            if phase is not None and spion.phase != phase:
                return cls(spion.tables, block=spion.block, phase=phase)
            return spion
        return cls(spion, block=spion["block"], phase=phase or "train")

    @classmethod
    def from_plan(cls, plan, *, phase="train"):
        """From a core.sparse_attention.SparsityPlan."""
        return cls(plan.tables, block=plan.tables["block"], phase=phase)

    def to(self, device):
        """The same exec with its tables on `device`."""
        return SparseAttentionExec(
            {k: v.to(device) for k, v in self.tables.items()},
            block=self.block, phase=self.phase)

    # -- table views ----------------------------------------------------------

    def scan_tables(self):
        """Stacked per-layer tables for the loop over layers. Decode needs
        only the forward BCSR (the query row selects its column blocks)."""
        keys = ("col_idx", "nvalid") if self.phase == "decode" \
            else PLAN_TABLE_KEYS
        return {k: self.tables[k] for k in keys if k in self.tables}

    # -- execution ------------------------------------------------------------

    def attend(self, cfg, q, k, v, layer_tables):
        """Sparse train/prefill attention for ONE layer; layer_tables holds
        this layer's col_idx (nrb, K) and nvalid (nrb,) and, from a
        SparsityPlan, the transposed row_idx (ncb, KT*) and nvalid_t (ncb,)
        that the kernel's dK/dV backward streams. Both paths are
        differentiable."""
        tabs = {k_: t.to(q.device) for k_, t in layer_tables.items()}
        bcsr = BCSR(tabs["col_idx"], tabs["nvalid"], self.block, q.shape[1])
        if resolve_kernel(cfg, q) == "fused":
            from repro_torch.kernels.ops import spion_attention_kernel
            return spion_attention_kernel(cfg, q, k, v, bcsr,
                                          row_idx=tabs.get("row_idx"),
                                          nvalid_t=tabs.get("nvalid_t"))
        return bcsr_attention(cfg, q, k, v, bcsr)

    def decode(self, cfg, q, k_cache, v_cache, pos, layer_tables):
        """Sparse one-token decode for ONE layer over a contiguous cache:
        gather and attend over only the cache blocks this query position's
        pattern row lists (same Alg. 6 zero-corrected softmax as the sparse
        prefill). `pos` may be per-batch-row (B,)."""
        return sparse_decode_attention(
            cfg, q, k_cache, v_cache, pos,
            layer_tables["col_idx"].to(q.device),
            layer_tables["nvalid"].to(q.device), block=self.block)

    def decode_paged(self, cfg, q, kp, vp, layer, pos, page_table,
                     layer_tables):
        """`decode` over a paged KV pool (core.kv_pool.PagedKVCache). The
        pool's page size must equal the plan block, so pattern block ids and
        page-table coordinates are the same thing."""
        if kp.shape[2] != self.block:
            raise ValueError(
                f"paged decode: pool page size {kp.shape[2]} != plan block "
                f"{self.block}; build the pool with page == block")
        return paged_sparse_decode_attention(
            cfg, q, kp, vp, layer, pos, page_table,
            layer_tables["col_idx"].to(q.device),
            layer_tables["nvalid"].to(q.device), page=self.block)

    # -- introspection --------------------------------------------------------

    @property
    def coverage(self) -> int:
        """Sequence positions the pattern tables cover (nrb * block)."""
        return int(self.tables["col_idx"].shape[-2]) * self.block
