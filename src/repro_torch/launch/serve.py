"""Continuous-batching serving engine over a paged (or contiguous) KV cache.

Each engine tick admits waiting requests — fused prefill
(make_prefill_step(with_cache=True): one full-sequence forward whose
per-layer RoPE'd K/V are inserted straight into the request's pages/slot) —
then decodes ONE token for every active slot in a single batched decode_step
with PER-SLOT positions: requests of different lengths decode at their own
offsets, finish independently, and their slots are reclaimed and refilled
mid-decode.

Paged serving (the default): K/V live in a shared core.kv_pool.PagePool of
cross-layer pages and each slot owns a page-table row. A request enters a
slot when its WORST-CASE page budget (ceil((prompt + max_new)/page)) fits the
pool, so it can never run out of pages mid-decode; otherwise it queues
(FIFO). Reclamation decrefs its pages back to the free list.

Sparse serving: pass the training run's SparsityPlan (or its tables payload,
or an exec) as `spion=` and both phases use it — the prefill runs the
block-sparse attention kernel on the card, and decode gathers only the cache
blocks the query position's pattern row lists. With paging the page size
equals the plan block, so that gather is pure page indirection. The plan
must cover the positions the engine will ever decode.

Not ported yet: copy-on-write prefix sharing, sliding-window ring caches and
the stepwise prefill of the recurrent families (ROADMAP.md A9).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.kv_pool import PagePool
from repro_torch.core.sparse_attention import SparsityPlan
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.registry import build


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int32
    max_new: int = 16
    out: Optional[list] = None
    done: bool = False
    slot: Optional[int] = None
    t_submit: float = 0.0
    t_first: float = 0.0         # stamped when THIS request's first token lands
    t_done: float = 0.0


class ServeEngine:
    """Continuous batching with per-slot positions and fused prefill.

    params: the model's ParamTree, on `device` (None: the first CUDA card).
    spion: None | SparsityPlan | tables payload | SparseAttentionExec —
    enables sparse prefill AND pattern-bounded sparse decode from the same
    layer-wise plan. paged: page the KV cache through a shared PagePool
    (default True); the page size is the plan block (sparse) or
    min(32, max_len) (dense); num_pages defaults to
    slots * (max_len/page) + 1 scratch — the contiguous footprint.
    prefill_bucket: prompts pad up to a multiple of this before the fused
    prefill; causality makes the padding free and the junk K/V it writes is
    never read. Sparse plans prefill at the same bucketed length — the
    stacked row tables slice to the prompt's row-blocks
    (_sparse_prefill_exec), so admission stays O(prompt), not O(coverage).
    share_prefix=True (copy-on-write prompt sharing) is not ported yet and
    raises.
    """

    def __init__(self, cfg, params, *, slots=4, max_len=512, spion=None,
                 prefill_bucket=32, paged=True, num_pages=None,
                 share_prefix=False, device=None):
        if share_prefix:
            raise NotImplementedError(
                "ServeEngine(share_prefix=True): copy-on-write prefix sharing "
                "is not ported yet (ROADMAP.md A9)")
        if cfg.sliding_window:
            raise NotImplementedError(
                f"ServeEngine: {cfg.name!r} has a sliding window; ring caches "
                f"are not ported yet (ROADMAP.md A9)")
        if not cfg.causal:
            raise ValueError("ServeEngine serves causal models only")
        self.device = resolve_device(device)
        param_dev = next(iter(params.parameters())).device
        if param_dev != self.device:
            raise ValueError(f"params are on {param_dev}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.bundle = build(cfg)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket

        self.exec: Optional[SparseAttentionExec] = None
        self._prefill_exec = None
        if spion is not None:
            if isinstance(spion, SparsityPlan):
                ex = SparseAttentionExec.from_plan(spion, phase="decode")
            else:
                ex = SparseAttentionExec.coerce(spion, phase="decode")
            self.exec = ex.to(self.device)
            self._prefill_exec = SparseAttentionExec.coerce(self.exec,
                                                            phase="prefill")

        self.paged = bool(paged)
        if self.paged:
            # sparse: page == plan block, so pattern column blocks and
            # page-table coordinates coincide
            self.page = self.exec.block if self.exec else min(32, max_len)
            if max_len % self.page:
                raise ValueError(f"max_len ({max_len}) must be a multiple "
                                 f"of the page size ({self.page})")
            self.nblocks = max_len // self.page
            npages = int(num_pages) if num_pages else slots * self.nblocks + 1
            self.pool = PagePool(
                layers=cfg.num_layers, num_pages=npages, page=self.page,
                kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                dtype=getattr(torch, cfg.cache_dtype or cfg.dtype),
                device=self.device)
            self.page_tables = np.full((slots, self.nblocks), -1, np.int32)
            self._pt_dev = self._to_device(self.page_tables)
            # finished slots keep their pages mapped until the next
            # admission needs them (post-run inspection)
            self._held = [False] * slots
            self.cache = None
        else:
            self.cache = self.bundle.init_cache(slots, max_len,
                                                device=self.device)

        # per-slot NEXT decode position. Freeness is `active[s] is None`; a
        # reclaimed slot's pos stays parked at its final value — the batched
        # decode still writes an (unread) K/V row for idle slots each tick,
        # and parking it at the one position the finished request never
        # wrote (P + max_new - 1: the last generated token is never fed
        # back) keeps the request's written cache region byte-stable. (Paged
        # idle slots whose page rows were reclaimed write to the scratch
        # page instead.)
        self.pos = np.full((slots,), -1, np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.waiting: Deque[Request] = collections.deque()
        self.prefill_fused = 0

        self._decode = make_serve_step(cfg, spion=True)
        self._prefill = make_prefill_step(cfg, spion=True, with_cache=True)

    def _to_device(self, a):
        return torch.as_tensor(np.asarray(a)).to(self.device)

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request):
        """Queue a request; it is admitted (prefilled) at the next engine
        tick with a free slot AND — paged — a sufficient free-page budget.
        Requests that could NEVER be admitted are rejected here: prompt +
        max_new is validated against the cache length, the sparsity plan's
        coverage, and the pool's total page capacity."""
        req.t_submit = time.time()
        req.out = []
        P = len(req.prompt)
        if P < 1:
            raise ValueError("prompt must have at least one token (the first "
                             "generated token is the argmax at its last "
                             "position)")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if P + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({P}) + max_new ({req.max_new}) "
                f"exceeds the cache length ({self.max_len})")
        if self.exec is not None and P + req.max_new > self.exec.coverage:
            raise ValueError(
                f"request {req.rid}: prompt ({P}) + max_new ({req.max_new}) "
                f"exceeds the sparsity plan's coverage "
                f"({self.exec.coverage} positions = nrb * block); build the "
                f"plan at the serving sequence length")
        if self.paged:
            worst = self._page_budget(P, req.max_new)
            if worst > self.pool.capacity:
                raise ValueError(
                    f"request {req.rid}: worst-case page budget {worst} "
                    f"pages (prompt {P} + max_new {req.max_new} at page "
                    f"size {self.page}) exceeds the pool capacity "
                    f"({self.pool.capacity} pages) — it could never be "
                    f"admitted; raise num_pages or lower max_new")
        self.waiting.append(req)

    @torch.inference_mode()
    def step(self):
        """One engine tick: admit waiting requests into free slots (each one
        prefilled into its slot), then decode one token for every active
        slot at its own position."""
        self._admit()
        if any(r is not None for r in self.active):
            self._decode_tick()

    def run(self, requests: List[Request]):
        """Drive `requests` (any count vs slot count) to completion."""
        for r in requests:
            self.submit(r)
        while self.waiting or any(r is not None for r in self.active):
            self.step()
        return requests

    # -- inspection -----------------------------------------------------------

    def slot_kv(self, s: int, length: int):
        """Host (L, length, KV, hd) K/V of slot `s`'s cache — contiguous
        slice or gathered through the slot's page-table row. Tests and
        inspection, not the serving path."""
        if not self.paged:
            return (self.cache["k"][:, s, :length].cpu(),
                    self.cache["v"][:, s, :length].cpu())
        return self.pool.gather_slot(self.page_tables[s], length)

    # -- internals ------------------------------------------------------------

    def _page_budget(self, P: int, max_new: int) -> int:
        return (P + max_new + self.page - 1) // self.page

    def _admit(self):
        for s in range(self.slots):
            if not self.waiting or self.active[s] is not None:
                continue
            r = self.waiting[0]
            if self.paged:
                self._release_done_slots()
                first = self._admit_paged(r, s)
                if first is None:
                    break   # FIFO: the head of the line waits for pages
            else:
                first = self._prefill_into(r, s)
            self.waiting.popleft()
            r.slot = s
            r.out.append(first)
            r.t_first = time.time()
            self.active[s] = r
            self.pos[s] = len(r.prompt)
            if len(r.out) >= r.max_new:
                self._finish(r, s)

    def _finish(self, r: Request, s: int):
        r.done = True
        r.t_done = time.time()
        self.active[s] = None
        # paged: the slot's pages stay mapped (self._held) until the next
        # admission wants them, and are released by _release_done_slots

    def _release_done_slots(self):
        """Return every finished slot's pages to the pool."""
        dirty = False
        for s in range(self.slots):
            if self.active[s] is None and self._held[s]:
                row = self.page_tables[s]
                for p in np.unique(row[row >= 0]):
                    self.pool.decref(int(p))
                row[:] = -1
                self._held[s] = False
                dirty = True
        if dirty:
            self._pt_dev = self._to_device(self.page_tables)

    def _decode_tick(self):
        tok = np.zeros((self.slots, 1), np.int64)
        posv = np.zeros((self.slots,), np.int32)
        for s, r in enumerate(self.active):
            posv[s] = max(self.pos[s], 0)   # idle slots park (see __init__)
            if r is not None:
                tok[s, 0] = r.out[-1]
        # the step updates the cache (contiguous or pool) in place
        logits, _ = self._decode(
            self.params, self._engine_cache(), self._to_device(tok),
            self._to_device(posv), self.exec)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s, r in enumerate(self.active):
            if r is None:
                continue
            r.out.append(int(nxt[s]))
            self.pos[s] += 1
            if len(r.out) >= r.max_new:
                self._finish(r, s)

    def _engine_cache(self):
        if not self.paged:
            return self.cache
        return self.pool.cache(self._pt_dev)

    # -- paged admission ------------------------------------------------------

    def _admit_paged(self, r: Request, s: int) -> Optional[int]:
        """Map pages for request `r` into slot `s`'s page-table row and
        prefill it; returns its first generated token, or None when the
        pool cannot cover its worst-case budget yet (the request stays
        queued). All pages are mapped up front, so decode can never run
        out mid-request."""
        total = self._page_budget(len(r.prompt), r.max_new)
        if self.pool.available() < total:
            return None
        row = self.page_tables[s]
        row[:] = -1
        row[:total] = self.pool.alloc(total)
        self._held[s] = True
        self._pt_dev = self._to_device(self.page_tables)
        return self._fused_prefill_paged(r, s)

    def _prefill_tokens(self, r: Request):
        """Run the fused prefill over `r`'s prompt padded to its bucket;
        returns (first token, ks, vs)."""
        P = len(r.prompt)
        Sp = self._prefill_len(P)
        toks = np.zeros((1, Sp), np.int64)
        toks[0, :P] = r.prompt
        pex = None if self._prefill_exec is None \
            else self._sparse_prefill_exec(Sp)
        logits, ks, vs = self._prefill(
            self.params, {"tokens": self._to_device(toks)}, pex)
        self.prefill_fused += 1
        return int(torch.argmax(logits[0, P - 1])), ks, vs

    def _fused_prefill_paged(self, r: Request, s: int) -> int:
        """Fused full-sequence prefill; page-sized blocks [0, ceil(P/page))
        of the resulting K/V stacks are written into the slot's
        freshly-allocated pages."""
        first, ks, vs = self._prefill_tokens(r)
        nb_prompt = (len(r.prompt) + self.page - 1) // self.page
        self.pool.insert_blocks(ks, vs, self.page_tables[s][:nb_prompt], 0)
        return first

    # -- contiguous prefill (paged=False) -------------------------------------

    def _prefill_len(self, P: int) -> int:
        if self.exec is not None:
            # sparse plans prefill at a bucketed length too: the row tables
            # slice to the first Sp/block row-blocks (_sparse_prefill_exec)
            blk = self.exec.block
            b = ((max(self.prefill_bucket, blk) + blk - 1) // blk) * blk
            return min(max(((P + b - 1) // b) * b, b), self.exec.coverage)
        b = self.prefill_bucket
        if self.paged:
            # paged inserts scatter whole pages: bucket to page multiples
            b = ((b + self.page - 1) // self.page) * self.page
        return max(((P + b - 1) // b) * b, b)

    def _sparse_prefill_exec(self, Sp: int):
        """The prefill-phase exec for a padded prompt of length Sp: slice
        the stacked forward tables to the first Sp/block row-blocks —
        every listed column of a causal row r is <= r, so the sliced
        tables are self-contained. The transposed row_idx/nvalid_t are
        dropped: they only feed the training backward."""
        ex = self._prefill_exec
        if Sp >= ex.coverage:
            return ex
        nrb = Sp // ex.block
        tabs = {"col_idx": ex.tables["col_idx"][:, :nrb],
                "nvalid": ex.tables["nvalid"][:, :nrb]}
        return SparseAttentionExec(tabs, block=ex.block, phase="prefill")

    def _prefill_into(self, r: Request, s: int) -> int:
        """Contiguous-cache prefill of request `r` into slot `s`; returns
        its first generated token (argmax of the last prompt position's
        logits — which is when t_first is stamped, per request)."""
        first, ks, vs = self._prefill_tokens(r)
        self._insert_fn(self.cache, ks, vs, s)
        return first

    def _insert_fn(self, cache, ks, vs, slot):
        """Write a prefilled request's K/V stack (L, 1, Sp, KV, hd) into
        cache slot `slot`, positions [0, min(Sp, S)), in place."""
        take = min(ks.shape[2], cache["k"].shape[2])
        cache["k"][:, slot, :take] = ks[:, 0, :take].to(cache["k"].dtype)
        cache["v"][:, slot, :take] = vs[:, 0, :take].to(cache["v"].dtype)
        return cache
