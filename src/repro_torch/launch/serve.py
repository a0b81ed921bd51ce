"""Continuous-batching serving engine over a paged (or contiguous) KV cache.

Each engine tick admits waiting requests — fused prefill
(make_prefill_step(with_cache=True): one full-sequence forward whose
per-layer RoPE'd K/V are inserted straight into the request's pages/slot) —
then decodes ONE token for every active slot in a single batched decode_step
with PER-SLOT positions: requests of different lengths decode at their own
offsets, finish independently, and their slots are reclaimed and refilled
mid-decode.

Paged serving (the default for attention families, from the registry's
supports_paged_cache): K/V live in a shared core.kv_pool.PagePool of
cross-layer pages and each slot owns a page-table row. A request enters a
slot when its WORST-CASE page budget (ceil((prompt + max_new)/page), clipped
to the ring length for sliding-window archs) fits the pool, so it can never
run out of pages mid-decode; otherwise it queues (FIFO). Reclamation decrefs
its pages back to the free list (shared prefix pages survive in an eviction
LRU).

Prefix sharing (copy-on-write, `share_prefix`): full prompt pages are
content-addressed by chained digests; a request whose prompt prefix matches
maps the same physical pages (prefilled ONCE — the shared system prompt
case), a partially-matching tail page is forked so the first divergent
token lands in a private copy, and a full-prompt hit reuses the recorded
first token with zero prefill compute. The uncovered suffix goes through
the fused prefill, which leaves the shared pages untouched; a suffix of at
most `stepwise_suffix_max` tokens can instead be prefilled stepwise through
the shared pages (off by default: on the card a stepwise token costs about
what a whole fused prefill does). Sharing is off for sliding-window rings
(pages are overwritten in place) and for stepwise families (recurrent state
depends on the full prefix).

Sliding-window archs (mixtral-8x7b) keep each slot's cache as a ring of
max_len positions: position p lives in slot p % max_len (paged: table slot
(p // page) % NB), a prompt longer than the ring is inserted in ring layout,
and decode masks what rotated out.

Sparse serving: pass the training run's SparsityPlan (or its tables payload,
or an exec) as `spion=` and both phases use it — the prefill runs the
block-sparse attention kernel on the card, and decode gathers only the cache
blocks the query position's pattern row lists. With paging the page size
equals the plan block, so that gather is pure page indirection. The plan
must cover the positions the engine will ever decode.

Families without a fused prefill (bundle.prefill_kv is None: hybrid, ssm
and audio / encdec) and the vlm family (patch tokens) prefill stepwise
from position 0: a FRESH B=1 recurrent state (and, contiguous, a fresh B=1
cache) is teacher-forced through the prompt one token at a time and then
written into the slot, so no stale state of an earlier request leaks in.
The per-slot state a family keeps beside its K/V lives beside the page
pool (`_extra_cache`): the hybrid family's conv/ssm states (its pool's
layer axis is the shared attention block's application) and the encdec
family's cross K/V at max_len. As in the JAX package, the engine never
fills the cross K/V (they stay zero: the engine serves the decoder without
audio) and serves the vlm family's text only. The ssm family (rwkv) has no
KV cache: the engine refuses `spion=` and `paged=True` for it before
allocating anything.

The JAX package hands the pool back from each donated step (`_absorb`);
here steps write the pool and caches in place.
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
from repro_torch.core.kv_pool import ROOT_DIGEST, PagePool, ring_positions
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
    layer-wise plan; refused for families the registry marks
    supports_sparse_decode=False (ssm). paged: None (default: the
    registry's supports_paged_cache flag) | bool — page the KV cache
    through a shared PagePool; page_size defaults to the plan block (sparse) or
    min(32, max_len) (dense); num_pages defaults to
    slots * (max_len/page) + 1 scratch — the contiguous footprint.
    share_prefix: copy-on-write prompt sharing (default: on whenever paged,
    fused-prefill and not a sliding-window ring; True otherwise raises).
    stepwise_suffix_max: a shared-prefix request whose uncovered suffix is
    at most this many tokens prefills the suffix stepwise THROUGH the shared
    pages (one B=1 decode step a token) instead of running the fused
    prefill; default 0, so every suffix takes the fused prefill (the
    reference's default is 2 pages, but a B=1 step costs the host about
    what a whole fused prefill does).
    prefill_bucket: prompts pad up to a multiple of this before the fused
    prefill; causality makes the padding free and the junk K/V it writes is
    never read. Sparse plans prefill at the same bucketed length — the
    stacked row tables slice to the prompt's row-blocks
    (_sparse_prefill_exec), so admission stays O(prompt), not O(coverage).
    Families without a fused prefill (hybrid, ssm, encdec) and the vlm
    family prefill stepwise, one request at a time from a fresh state
    (module docstring).
    """

    def __init__(self, cfg, params, *, slots=4, max_len=512, spion=None,
                 prefill_bucket=32, paged=None, page_size=None,
                 num_pages=None, share_prefix=None, stepwise_suffix_max=None,
                 device=None):
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

        if spion is not None and not self.bundle.supports_sparse_decode:
            raise NotImplementedError(
                f"ServeEngine(spion=...): family {cfg.family!r} (arch "
                f"{cfg.name!r}) keeps recurrent state, not an attention KV "
                f"cache — registry supports_sparse_decode is False for it; "
                f"serve it densely (spion=None)")
        self.paged = (self.bundle.supports_paged_cache if paged is None
                      else bool(paged))
        if self.paged and not self.bundle.supports_paged_cache:
            raise NotImplementedError(
                f"ServeEngine(paged=True): family {cfg.family!r} keeps "
                f"recurrent state, not a KV cache — paging does not apply "
                f"(registry supports_paged_cache is False)")
        self._can_fuse = (self.bundle.prefill_kv is not None and cfg.causal
                          and not cfg.num_patch_tokens)
        self._spion_step = self.bundle.supports_sparse_decode

        self.exec: Optional[SparseAttentionExec] = None
        self._prefill_exec = None
        if spion is not None:
            if isinstance(spion, SparsityPlan):
                ex = SparseAttentionExec.from_plan(spion, phase="decode",
                                                   dtype=cfg.dtype)
            else:
                ex = SparseAttentionExec.coerce(spion, phase="decode",
                                                dtype=cfg.dtype)
            self.exec = ex.to(self.device)
            self._prefill_exec = SparseAttentionExec.coerce(self.exec,
                                                            phase="prefill")

        if self.paged:
            self.page = int(page_size or (self.exec.block if self.exec
                                          else min(32, max_len)))
            if self.exec is not None and self.page != self.exec.block:
                raise ValueError(
                    f"page_size ({self.page}) must equal the sparsity plan "
                    f"block ({self.exec.block}) so pattern column blocks "
                    f"and page-table coordinates coincide")
            if max_len % self.page:
                raise ValueError(f"max_len ({max_len}) must be a multiple "
                                 f"of the page size ({self.page})")
            self.nblocks = max_len // self.page
            npages = int(num_pages) if num_pages else slots * self.nblocks + 1
            # the cache's K/V layer axis: layers, or the hybrid family's
            # applications of its shared attention block
            pool_layers = self.bundle.init_cache(
                1, 0, device=self.device)["k"].shape[0]
            self.pool = PagePool(
                layers=pool_layers, num_pages=npages, page=self.page,
                kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                dtype=getattr(torch, cfg.cache_dtype or cfg.dtype),
                device=self.device)
            self.page_tables = np.full((slots, self.nblocks), -1, np.int32)
            self._pt_dev = self._to_device(self.page_tables)
            # finished slots keep their pages mapped until the next
            # admission needs them (post-run inspection)
            self._held = [False] * slots
            # the per-slot recurrent states of families that keep them
            # beside the KV cache (hybrid: conv, ssm); {} for pure-KV ones
            self._extra_cache = self._recurrent_state(slots)
            default_share = self._can_fuse and not cfg.sliding_window
            self.share_prefix = (default_share if share_prefix is None
                                 else bool(share_prefix))
            if self.share_prefix and not default_share:
                raise ValueError(
                    "share_prefix=True needs a fused-prefill causal family "
                    "without a sliding-window ring (ring pages are "
                    "overwritten in place; recurrent prefill state depends "
                    "on the full prefix)")
            self.stepwise_suffix_max = int(stepwise_suffix_max or 0)
            self.cache = None
        else:
            self.share_prefix = False
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
        self.prefill_stepwise_tokens = 0

        self._decode = make_serve_step(cfg, spion=self._spion_step)
        self._decode1 = None
        self._prefill = (make_prefill_step(cfg, spion=True, with_cache=True)
                         if self._can_fuse else None)

    def _to_device(self, a):
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _recurrent_state(self, batch):
        """The zero per-slot state of `batch` rows that a family keeps
        beside its K/V: the family's cache without "k" and "v" (hybrid:
        conv, ssm; encdec: the cross K/V "ck", "cv" at max_len, as in the
        JAX package; {} for pure-KV families). The K/V are built at length
        0, so no contiguous slots x max_len cache is allocated beside the
        page pool."""
        kw = ({"enc_len": self.max_len}
              if self.cfg.family in ("audio", "encdec") else {})
        base = self.bundle.init_cache(batch, 0, device=self.device, **kw)
        return {k: v for k, v in base.items() if k not in ("k", "v")}

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
        if not self.cfg.sliding_window and P + req.max_new > self.max_len:
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

    @property
    def prefix_stats(self) -> dict:
        """Pool + prefill counters (prefix-hit-rate telemetry)."""
        st = dict(self.pool.stats) if self.paged else {}
        st["prefill_fused"] = self.prefill_fused
        st["prefill_stepwise_tokens"] = self.prefill_stepwise_tokens
        lk = st.get("lookups", 0)
        st["prefix_hit_rate"] = (st.get("hits", 0) / lk) if lk else 0.0
        return st

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
        worst = (P + max_new + self.page - 1) // self.page
        if self.cfg.sliding_window:
            worst = min(worst, self.nblocks)
        return worst

    def _ex_args(self):
        return (self.exec,) if self._spion_step else ()

    def _decode1_step(self):
        """The B=1 decode step of the stepwise prefill (a step of its own,
        so timing the batched decode does not count it)."""
        if self._decode1 is None:
            self._decode1 = make_serve_step(self.cfg, spion=self._spion_step)
        return self._decode1

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
            self._to_device(posv), *self._ex_args())
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
        pkv = self.pool.cache(self._pt_dev)
        return dict(self._extra_cache, kv=pkv) if self._extra_cache else pkv

    # -- paged admission (free-page admission + COW prefix sharing) -----------

    def _admit_paged(self, r: Request, s: int) -> Optional[int]:
        """Map pages for request `r` into slot `s`'s page-table row and
        prefill it; returns its first generated token, or None when the
        pool cannot cover its worst-case budget yet (the request stays
        queued). All pages are mapped up front, so decode can never run
        out mid-request."""
        P = len(r.prompt)
        pg = self.page
        total = self._page_budget(P, r.max_new)
        prompt = np.asarray(r.prompt, np.int32)
        m = self.pool.match_prefix(prompt) if self.share_prefix else None
        nfull = P // pg
        tail_len = P - nfull * pg
        nshared = len(m.shared) if m else 0
        # full-prompt hit: every page resident (tail via COW fork) AND the
        # first token recorded — zero prefill compute
        cached_first = (m is not None and nshared == nfull
                        and m.first_tok is not None
                        and (tail_len == 0 or m.tail_src is not None))
        if not cached_first and tail_len == 0 and nshared == nfull:
            # the would-be refeed case: the last prompt position lives in a
            # SHARED page we must not write — recompute that page privately
            nshared = max(nfull - 1, 0)

        need = total - nshared
        if m:
            for p in m.shared[:nshared]:
                self.pool.incref(p)
        if self.pool.available() < need:
            if m:
                for p in m.shared[:nshared]:
                    self.pool.decref(p)
            return None
        fresh = self.pool.alloc(need)
        row = self.page_tables[s]
        row[:] = -1
        if nshared:
            row[:nshared] = m.shared[:nshared]
        row[nshared:total] = fresh
        self._held[s] = True
        if cached_first and tail_len:
            self.pool.copy_page(m.tail_src, int(row[nfull]))
        self._pt_dev = self._to_device(self.page_tables)

        covered = P if cached_first else nshared * pg
        if cached_first:
            first = int(m.first_tok)
            self.pool.stats["prefill_reused"] += 1
            self.pool.stats["prefix_tokens_reused"] += P
        elif (self._can_fuse
              and (covered == 0 or P - covered > self.stepwise_suffix_max)):
            first = self._fused_prefill_paged(r, s, nshared)
            if m:
                self.pool.stats["prefix_tokens_reused"] += covered
        else:
            first = self._stepwise_prefill_paged(r, s, covered)
            if m:
                self.pool.stats["prefix_tokens_reused"] += covered
        if m is not None and not cached_first:
            self._register_prompt(prompt, m, row, nshared, first)
        return first

    def _register_prompt(self, prompt, m, row, nshared, first):
        pg = self.page
        nfull = len(m.digests)
        for i in range(nshared, nfull):
            parent = m.digests[i - 1] if i else ROOT_DIGEST
            self.pool.register_full(int(row[i]), m.digests[i], parent,
                                    tuple(int(t) for t in
                                          prompt[i * pg:(i + 1) * pg]))
        tail = tuple(int(t) for t in prompt[nfull * pg:])
        if tail:
            parent = m.digests[-1] if nfull else ROOT_DIGEST
            self.pool.register_tail(int(row[nfull]), parent, tail)
        self.pool.remember_first_token(m.full_digest, first)

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

    def _fused_prefill_paged(self, r: Request, s: int, nshared: int) -> int:
        """Fused full-sequence prefill; page-sized blocks [nshared,
        ceil(P/page)) of the resulting K/V stacks are written into the
        slot's freshly-allocated pages (shared prefix pages are left
        untouched). Ring prompts that wrap insert in ring layout."""
        first, ks, vs = self._prefill_tokens(r)
        P = len(r.prompt)
        pg = self.page
        row = self.page_tables[s]
        if self.cfg.sliding_window and P >= self.nblocks * pg:
            self.pool.insert_ring(ks, vs, row[:self.nblocks], P)
        else:
            nb_prompt = (P + pg - 1) // pg
            if nb_prompt > nshared:
                self.pool.insert_blocks(ks, vs, row[nshared:nb_prompt],
                                        nshared)
        return first

    def _stepwise_prefill_paged(self, r: Request, s: int, start: int) -> int:
        """Teacher-force prompt positions [start, P) one at a time through
        the slot's page-table row with a B=1 decode step — attending the
        SHARED prefix pages below `start` without recomputing them (this is
        what makes 'prefill once' literal for shared-prefix suffixes), or
        from 0 for families without a fused prefill, whose fresh
        per-request conv/ssm states are written into the slot afterwards."""
        pkv = self.pool.cache(self._to_device(self.page_tables[s:s + 1]))
        sub = self._recurrent_state(1) if self._extra_cache else {}
        cache1 = dict(sub, kv=pkv) if sub else pkv
        return self._teacher_force(r, start, cache1, sub, self._extra_cache,
                                   s)

    def _teacher_force(self, r: Request, start: int, cache1, state, into,
                       s: int) -> int:
        """Feed prompt positions [start, P) of `r` one at a time through
        the B=1 decode step over `cache1` (updated in place), then write
        each B=1 tensor of `state` into row `s` of the same key of `into`;
        returns the first generated token."""
        P = len(r.prompt)
        step1 = self._decode1_step()
        logits = None
        for t in range(start, P):
            tok = self._to_device(np.asarray([[r.prompt[t]]], np.int64))
            logits, _ = step1(self.params, cache1, tok, t, *self._ex_args())
        for k, v in state.items():
            into[k][:, s] = v[:, 0]
        self.prefill_stepwise_tokens += P - start
        return int(torch.argmax(logits[0]))

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
        dropped: they only feed the training backward. As in the JAX
        package, the sliced exec is built without the full one's kernel
        config: it looks its own up, under the sliced tables' digest."""
        ex = self._prefill_exec
        if Sp >= ex.coverage:
            return ex
        nrb = Sp // ex.block
        tabs = {"col_idx": ex.tables["col_idx"][:, :nrb],
                "nvalid": ex.tables["nvalid"][:, :nrb]}
        return SparseAttentionExec(tabs, block=ex.block, phase="prefill",
                                   dtype=ex.dtype)

    def _prefill_into(self, r: Request, s: int) -> int:
        """Contiguous-cache prefill of request `r` into slot `s`; returns
        its first generated token (argmax of the last prompt position's
        logits — which is when t_first is stamped, per request)."""
        if self._can_fuse:
            first, ks, vs = self._prefill_tokens(r)
            self._insert_fn(self.cache, ks, vs, s, len(r.prompt))
            return first
        # stepwise fallback (recurrent states, cross K/V, patch tokens):
        # teacher-force the prompt through a FRESH B=1 cache — per request,
        # so no other slot is touched and no stale state leaks in — then
        # write the slot
        sub = self.bundle.init_cache(1, self.max_len, device=self.device)
        return self._teacher_force(r, 0, sub, sub, self.cache, s)

    def _insert_fn(self, cache, ks, vs, slot, plen):
        """Write a prefilled request's K/V stack (L, 1, Sp, KV, hd) into
        cache slot `slot`, in place. Append caches take positions
        [0, min(Sp, S)); sliding-window ring caches take, for each ring slot
        s, the LATEST prompt position congruent to s (mod S) — the same
        layout the decode-time ring writer produces."""
        S = cache["k"].shape[2]
        Sp = ks.shape[2]
        if self.cfg.sliding_window:
            p = ring_positions(S, plen, ks.device)
            valid = ((p >= 0) & (p < Sp))[None, :, None, None]
            p = p.clamp(0, Sp - 1)
        for c, new in ((cache["k"], ks), (cache["v"], vs)):
            if self.cfg.sliding_window:
                sel = new[:, 0].index_select(1, p).to(c.dtype)
                c[:, slot] = torch.where(valid, sel, c[:, slot])
            else:
                take = min(Sp, S)
                c[:, slot, :take] = new[:, 0, :take].to(c.dtype)
        return cache
