"""SPION three-phase training controller (paper Alg. 2 / Fig. 2).

Phases:  dense  --(Frobenius criterion)-->  pattern generation  -->  sparse.

The controller is host-side state; a train step only sees (a) a `capture`
kwarg during the dense phase and (b) the SparsityPlan tables during the
sparse phase. Pattern generation runs once, between epochs, on the host
(numpy); the plan (forward BCSR plus the transposed tables padded to the
true column-population width KT*, all small int32 tensors) becomes the
sparse step's input.

Single-process: the JAX package's multi-process plan broadcast and digest
check wait in ROADMAP.md item A12; `generate` here is its `_generate_local`.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import SpionConfig
from repro_torch.core.pattern import diagonal_filter, generate_pattern
from repro_torch.core.sparse_attention import (PLAN_TABLE_KEYS,
                                               bcsr_from_blockmask,
                                               build_sparsity_plan)


def _int32_tables(arrays, block):
    tables = {k: torch.as_tensor(np.array(arrays[k], np.int32))
              for k in PLAN_TABLE_KEYS if k in arrays}
    tables["block"] = int(block)
    return tables


@dataclass
class SpionState:
    phase: str = "dense"                     # "dense" | "sparse"
    epoch: int = 0
    frob_hist: List[np.ndarray] = field(default_factory=list)   # per-epoch (Ly,)
    dist_hist: List[float] = field(default_factory=list)
    tables: Optional[dict] = None            # SparsityPlan payload for the step
    density: Optional[float] = None
    plan_stats: Optional[dict] = None        # host-only occupancy stats

    def to_py(self, include_tables: bool = True):
        """JSON-safe dict. With include_tables=False the plan arrays are left
        out — store `table_arrays()` in a binary file and hand them back to
        `from_py`."""
        d = {
            "phase": self.phase,
            "epoch": self.epoch,
            "frob_hist": [h.tolist() for h in self.frob_hist],
            "dist_hist": list(self.dist_hist),
            "density": self.density,
            "plan_stats": self.plan_stats,
        }
        if self.tables is None:
            d["tables"] = None
        elif include_tables:
            d["tables"] = {k: v.tolist()
                           for k, v in self.table_arrays().items()}
            d["tables"]["block"] = int(self.tables["block"])
        else:
            d["tables_meta"] = {"block": int(self.tables["block"])}
        return d

    def table_arrays(self):
        """Plan arrays as numpy (None in the dense phase)."""
        if self.tables is None:
            return None
        return {k: np.asarray(torch.as_tensor(self.tables[k]).cpu())
                for k in PLAN_TABLE_KEYS if k in self.tables}

    @staticmethod
    def from_py(d, arrays: Optional[dict] = None):
        st = SpionState(phase=d["phase"], epoch=d["epoch"],
                        dist_hist=list(d["dist_hist"]), density=d.get("density"),
                        plan_stats=d.get("plan_stats"))
        st.frob_hist = [np.asarray(h) for h in d["frob_hist"]]
        tab = d.get("tables")
        meta = d.get("tables_meta")
        if arrays and not (tab or meta):
            raise ValueError(
                "SpionState.from_py: plan arrays were supplied but the "
                "state dict has neither 'tables' nor 'tables_meta' — the "
                "state and the arrays do not belong together. Pass the "
                "matching pair, or arrays=None to resume dense.")
        if arrays and (tab or meta):
            st.tables = _int32_tables(arrays, (tab or meta)["block"])
        elif meta and not tab:
            raise ValueError(
                "SpionState.from_py: state has tables_meta but no plan "
                "arrays were supplied")
        elif tab:
            st.tables = _int32_tables(tab, tab["block"])
        if st.tables is not None and "row_idx" not in st.tables:
            # a plan without transposed tables: rebuild them host-side once
            plan = build_sparsity_plan(st.tables["col_idx"],
                                       st.tables["nvalid"],
                                       st.tables["block"])
            st.tables = plan.tables
            st.plan_stats = plan.stats
        return st


def plan_digest(arrays: Optional[dict], block) -> str:
    """Digest of a plan's table arrays + block size: name, dtype, shape and
    bytes of every array take part (the JAX package's payload_digest), so
    one flipped int32 changes it."""
    h = hashlib.sha256()
    for k in sorted(arrays or {}):
        a = np.ascontiguousarray(np.asarray(arrays[k]))
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(json.dumps({"block": int(block)}, sort_keys=True).encode())
    return h.hexdigest()[:32]


class SpionController:
    def __init__(self, spion_cfg: SpionConfig, *, causal: bool, seq_len: int):
        self.cfg = spion_cfg
        self.causal = causal
        self.seq_len = seq_len
        self.filt = torch.as_tensor(
            diagonal_filter(spion_cfg.conv_filter_size), dtype=torch.float32)

    # -- step kwargs ------------------------------------------------------------

    def capture_kwargs(self, state: SpionState):
        """`capture=` kwarg for forward() during the dense phase (else None)."""
        if not self.cfg.enabled or state.phase != "dense":
            return None
        return {"filt": self.filt, "block": self.cfg.block_size}

    def spion_kwargs(self, state: SpionState):
        """The plan tables during the sparse phase (else None). Gated on
        cfg.enabled too: a sparse-phase state under a SPION-disabled config
        must not keep the step sparse."""
        if (self.cfg.enabled and state.phase == "sparse"
                and state.tables is not None):
            return state.tables
        return None

    def attention_exec(self, state: SpionState, phase: str = "train"):
        """The sparse phase's SparseAttentionExec (None in the dense phase
        or when SPION is disabled). `phase="decode"` gives the serving
        engine's sparse-decode exec from the same training plan."""
        tables = self.spion_kwargs(state)
        if tables is None:
            return None
        from repro_torch.core.attention_exec import SparseAttentionExec
        return SparseAttentionExec(tables, block=tables["block"], phase=phase)

    def verify_plan_sync(self, state: SpionState,
                         tag: str = "spion_plan_restore"):
        """Multi-process: assert every process holds the SAME plan after a
        restore (the JAX package compares plan digests across processes).
        A no-op in a single process, which is all the port runs until
        ROADMAP.md item A12, and in the dense phase."""
        from repro_torch.distributed import process_count
        if process_count() <= 1 or state.tables is None:
            return
        raise NotImplementedError(
            f"{tag}: checking the plan across processes waits in ROADMAP.md "
            "item A12")

    # -- per-epoch update (paper Alg. 2 lines 7-12) ----------------------------

    def observe_epoch(self, state: SpionState, pooled: np.ndarray,
                      frob_sq: np.ndarray) -> SpionState:
        """pooled: (Ly, nb, nb) streamed conv+pool capture; frob_sq: (Ly,).
        Returns the updated state; generates patterns on transition."""
        if not self.cfg.enabled or state.phase == "sparse":
            state.epoch += 1
            return state
        frob = np.sqrt(np.maximum(np.asarray(frob_sq, np.float64), 0.0))
        state.frob_hist.append(frob)
        if len(state.frob_hist) >= 2:
            # Eq. 2: distance_i = | ||A_{i-1}||_F - ||A_i||_F |, layer-averaged
            d = float(np.mean(np.abs(state.frob_hist[-2] - state.frob_hist[-1])))
            state.dist_hist.append(d)
        transition = False
        if len(state.dist_hist) >= 2 and state.epoch + 1 >= self.cfg.min_dense_epochs:
            # Alg. 2 line 10: sqrt((d_{i-1} - d_i)^2) < alpha
            transition = abs(state.dist_hist[-2] - state.dist_hist[-1]) < self.cfg.transition_tol
        if state.epoch + 1 >= self.cfg.max_dense_epochs:
            transition = True
        if transition:
            state = self.generate(state, pooled)
        state.epoch += 1
        return state

    def generate(self, state: SpionState, pooled: np.ndarray) -> SpionState:
        """Pattern generation for every layer; builds the full SparsityPlan:
        stacked padded BCSR plus the transposed tables at the true max
        column population KT*, host-side and once, so the dK/dV backward
        streams KT* entries per column block with no per-step transpose."""
        pooled = np.asarray(pooled, np.float64)
        Ly = pooled.shape[0]
        masks = [
            generate_pattern(None, pooled=pooled[l], variant=self.cfg.variant,
                             block_size=self.cfg.block_size,
                             alpha_quantile=self.cfg.alpha_quantile,
                             causal=self.causal)
            for l in range(Ly)
        ]
        K = self.cfg.max_blocks_per_row or max(int(m.sum(axis=1).max()) for m in masks)
        tabs = [bcsr_from_blockmask(m, self.cfg.block_size, max_k=K) for m in masks]
        plan = build_sparsity_plan(
            np.stack([np.asarray(t.col_idx) for t in tabs]),
            np.stack([np.asarray(t.nvalid) for t in tabs]),
            self.cfg.block_size)
        state.tables = plan.tables
        state.plan_stats = plan.stats
        state.density = float(np.mean([m.mean() for m in masks]))
        state.phase = "sparse"
        return state
