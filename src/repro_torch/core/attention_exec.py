"""SparseAttentionExec — the single owner of one resolved sparse-attention
execution.

  - `tables` — the SparsityPlan tensors (col_idx / nvalid and, when
    plan-built, row_idx / nvalid_t), stacked over layers;
  - `block`, `halo` and `phase` — the static metadata (`halo` is the
    plan's (left, right) column extent in blocks, stats["halo"]: it lets
    the kernels shard the sequence under a mesh with a 'seq' axis);
  - `kernel_config` — the autotuner's pick for this pattern
    (kernels/autotune.py), looked up in the on-disk cache once, when the
    exec is constructed (never a sweep), under the `dtype` the kernels
    will run in; None is the default config. Training and serving reach
    their tuned configs by building their exec.

`phase` is "train" | "prefill" | "decode". Train and prefill share
`attend()` (full-sequence block-sparse attention: the Hopper kernels or
the plain gather per `resolve_kernel`, both differentiable; under an
active mesh of more than one rank the kernels run through
kernels/sharded.py on the rank's shard); decode uses
`decode()` / `decode_paged()` — the pattern-bounded KV-cache gather, which
reads only the cache blocks the query position's row-block lists. The
`*_app` forms index the stacked tables by the hybrid family's shared-block
application instead of taking a layer's slice.
"""
from __future__ import annotations

import copy

import torch

from repro_torch.core.sparse_attention import (BCSR, PLAN_TABLE_KEYS,
                                               bcsr_attention,
                                               paged_sparse_decode_attention,
                                               sparse_decode_attention)
from repro_torch.distributed.sharding import (active_mesh, gather_kv,
                                              seq_start)

_PHASES = ("train", "prefill", "decode")


def resolve_kernel(cfg, q) -> str:
    """What the sparse forward of `q` dispatches to ("fused" / "jnp").

    The tensor's device picks the path. On CUDA tensors it is always the
    Hopper kernel ("fused"), and cfg.spion.kernel="jnp" raises; so on the
    dry run's meta tensors (launch/dryrun.py), whose kernels' ops give
    shapes only. On CPU
    tensors "auto" takes the plain gather ("jnp", the JAX package's name for
    it) and "fused" the kernel's plain version. The JAX package resolves
    meshless "auto" to its gather everywhere but on a TPU, because its GPU
    lowering was never ported; here the kernel exists.

    Under an active mesh of more than one rank "auto" is "fused" (the
    sharded kernels, as in the reference); "jnp" stays the gather, which on
    a 'seq' shard gathers the sequence's K/V (`SparseAttentionExec.
    attend`)."""
    impl = cfg.spion.kernel
    if impl not in ("auto", "fused", "jnp"):
        raise ValueError(f"cfg.spion.kernel must be auto/fused/jnp, got "
                         f"{impl!r}")
    if impl == "auto" and active_mesh() is not None:
        return "fused"
    # the card, or the dry run's meta tensors
    if q.is_cuda or getattr(q, "is_meta", False):
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

    def __init__(self, tables, *, block, halo=None, phase="train",
                 kernel_config=None, dtype=None):
        if phase not in _PHASES:
            raise ValueError(f"phase must be one of {_PHASES}, got {phase!r}")
        from repro_torch.kernels.autotune import dtype_name, lookup
        self.tables = {k: torch.as_tensor(tables[k]) for k in PLAN_TABLE_KEYS
                       if tables is not None and tables.get(k) is not None}
        self.block = int(block)
        self.halo = None if halo is None else (int(halo[0]), int(halo[1]))
        self.phase = phase
        # the kernels' dtype keys the lookup (the reference always looks up
        # float32, its default): fp32 runs the scalar kernels, which have no
        # knob, so a bf16 run must find its bf16 entry
        self.dtype = dtype_name(torch.float32 if dtype is None else dtype)
        if kernel_config is None and self.tables:
            kernel_config = lookup(self.tables, self.block, dtype=self.dtype)
        self.kernel_config = kernel_config

    def __repr__(self):
        shapes = {k: tuple(v.shape) for k, v in self.tables.items()}
        return (f"SparseAttentionExec(phase={self.phase!r}, "
                f"block={self.block}, halo={self.halo}, "
                f"kernel_config={self.kernel_config!r}, "
                f"dtype={self.dtype!r}, tables={shapes})")

    # -- constructors ---------------------------------------------------------

    @classmethod
    def coerce(cls, spion, *, phase=None, kernel_config=None, dtype=None):
        """None | exec | tables-dict payload -> exec (or None). An exec
        keeps its config and dtype; a dict payload (an int 'block' and
        optionally the 'halo' pair) looks its config up under `dtype`
        unless `kernel_config` is given."""
        if spion is None:
            return None
        if isinstance(spion, cls):
            if phase is not None and spion.phase != phase:
                ex = copy.copy(spion)
                ex.phase = phase
                return ex
            return spion
        return cls(spion, block=spion["block"], halo=spion.get("halo"),
                   phase=phase or "train", kernel_config=kernel_config,
                   dtype=dtype)

    @classmethod
    def from_plan(cls, plan, *, phase="train", kernel_config=None,
                  dtype=None):
        """From a core.sparse_attention.SparsityPlan (halo from its
        stats)."""
        return cls(plan.tables, block=plan.tables["block"],
                   halo=plan.stats.get("halo"), phase=phase,
                   kernel_config=kernel_config, dtype=dtype)

    def to(self, device):
        """The same exec (config and dtype kept) with its tables on
        `device`."""
        ex = copy.copy(self)
        ex.tables = {k: v.to(device) for k, v in self.tables.items()}
        return ex

    # -- table views ----------------------------------------------------------

    def scan_tables(self):
        """Stacked per-layer tables for the loop over layers. Decode needs
        only the forward BCSR (the query row selects its column blocks)."""
        keys = ("col_idx", "nvalid") if self.phase == "decode" \
            else PLAN_TABLE_KEYS
        return {k: self.tables[k] for k in keys if k in self.tables}

    def layer(self, idx):
        """Per-layer (or per-application) slice of the stacked tables, for
        callers that index by a layer id instead of looping over layers
        (the hybrid family's shared attention block)."""
        return {k: v[idx] for k, v in self.scan_tables().items()}

    # -- execution ------------------------------------------------------------

    def attend(self, cfg, q, k, v, layer_tables):
        """Sparse train/prefill attention for ONE layer; layer_tables holds
        this layer's col_idx (nrb, K) and nvalid (nrb,) and, from a
        SparsityPlan, the transposed row_idx (ncb, KT*) and nvalid_t (ncb,)
        that the kernel's dK/dV backward streams. Both paths are
        differentiable. On a 'seq' shard the kernels shard themselves
        (kernels/sharded.py); the gather gathers the whole sequence's K/V
        and runs this shard's rows against the global tables. On a
        'model' axis q, k and v hold the rank's H/|model| and KV/|model|
        heads (models/attention.qkv): the kernels run on its B_loc *
        KV/|model| rows, one launch a layer as in one process, over the
        replicated tables."""
        from repro_torch.kernels.work import table_device
        tabs = {k_: t.to(table_device(q)) for k_, t in layer_tables.items()}
        bcsr = BCSR(tabs["col_idx"], tabs["nvalid"], self.block, q.shape[1])
        if resolve_kernel(cfg, q) == "fused":
            from repro_torch.kernels.ops import spion_attention_kernel
            return spion_attention_kernel(cfg, q, k, v, bcsr,
                                          row_idx=tabs.get("row_idx"),
                                          nvalid_t=tabs.get("nvalid_t"),
                                          halo=self.halo,
                                          config=self.kernel_config)
        kg, vg = gather_kv(k, v)
        return bcsr_attention(cfg, q, kg, vg, bcsr,
                              row_offset=seq_start(q.shape[1]) // self.block)

    def attend_app(self, cfg, q, k, v, app_idx):
        """`attend` for the hybrid family's shared attention block: the
        stacked tables are indexed by the application, not by the layer."""
        return self.attend(cfg, q, k, v, self.layer(app_idx))

    def decode(self, cfg, q, k_cache, v_cache, pos, layer_tables, *,
               ring=False):
        """Sparse one-token decode for ONE layer over a contiguous cache:
        gather and attend over only the cache blocks this query position's
        pattern row lists (same Alg. 6 zero-corrected softmax as the sparse
        prefill). `pos` may be per-batch-row (B,). ring=True for
        sliding-window ring-buffer caches."""
        return sparse_decode_attention(
            cfg, q, k_cache, v_cache, pos,
            layer_tables["col_idx"].to(q.device),
            layer_tables["nvalid"].to(q.device), block=self.block, ring=ring)

    def decode_app(self, cfg, q, k_cache, v_cache, pos, app_idx, *,
                   ring=False):
        return self.decode(cfg, q, k_cache, v_cache, pos, self.layer(app_idx),
                           ring=ring)

    def decode_paged(self, cfg, q, kp, vp, layer, pos, page_table,
                     layer_tables, *, ring=False):
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
            layer_tables["nvalid"].to(q.device), page=self.block, ring=ring)

    def decode_paged_app(self, cfg, q, kp, vp, app_idx, pos, page_table, *,
                         ring=False):
        """`decode_paged` for the hybrid shared block: the pool's layer axis
        and the tables are both indexed by the application."""
        return self.decode_paged(cfg, q, kp, vp, app_idx, pos, page_table,
                                 self.layer(app_idx), ring=ring)

    # -- introspection --------------------------------------------------------

    @property
    def coverage(self) -> int:
        """Sequence positions the pattern tables cover (nrb * block)."""
        return int(self.tables["col_idx"].shape[-2]) * self.block
