"""Paged KV cache: a shared page pool + per-request page tables.

  - `PagePool` owns ONE pool of K/V pages shaped
    (layers, num_pages, page, kv_heads, head_dim) — a page is a cross-layer
    group, so a single (B, num_blocks) page table serves every layer — plus
    the host-side bookkeeping: a free list and per-page refcounts.
  - `PagedKVCache` is the view a decode step consumes: the pool's k/v
    tensors and a page table.
  - decode writes are an O(B) scatter into the active page
    (`scatter_token`), done in place.

Page size equals the BCSR block when serving sparsely, so the sparse decode
gather (core.sparse_attention.paged_sparse_decode_attention) is pure page
indirection: pattern column block -> page table -> physical page.

Page 0 is reserved scratch: it is never allocated, unmapped page-table
entries (-1) clamp to it, and idle serve slots park their per-tick writes
there. Reads through unmapped entries are position-masked, so scratch junk
never reaches a logit.

Prefix sharing (copy-on-write): full prompt pages are content-addressed by a
chained digest (digest_i = H(digest_{i-1} || tokens of page i) — causal K/V
at position p depends only on tokens <= p, so equal chains mean equal
pages). A later request whose chain prefix matches maps the same physical
pages (incref; never written — decode writes start past the prompt). A
partial tail page is FORKED: the registry keeps (parent digest, token tuple)
per registered page, a prefix match copies the page, and the request's first
divergent token lands in its private copy. Refcounts hitting zero move
registered pages to an evictable LRU (future prefix hits revive them) and
return unregistered ones to the free list.

Sliding-window rings reuse a slot's own pages: position p lives in table
slot (p // page) % NB (`write_target(ring=True)`, `PagePool.insert_ring`).

Where the JAX package donates the pool to a jitted update, the port writes
the pool tensors in place (`index_put_`, `index_copy_`).

Under a mesh (launch/steps.make_serve_step) the pool and the page table
are replicated, as the reference's cache_pspecs leave them: a rank
decodes its batch rows (`rows_and_targets`) and attends with its KV heads
or head_dim columns of the pool (`distributed.sharding.pool_shard`), and
the new token's K/V is gathered for every row and KV head before every
rank writes it (`write_token`), so the pools stay bitwise equal.
"""
from __future__ import annotations

import collections
import hashlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import gather_rows, own_rows, whole_token

SCRATCH_PAGE = 0
_ROOT = b"spion-kv-pool-root"
ROOT_DIGEST = _ROOT   # chain parent of a prompt's first page (engine-visible)


class PagedKVCache:
    """The decode-step view of a paged pool: k/v page tensors
    (L, num_pages, page, KV, hd) + a page table (B, num_blocks) of physical
    page ids (-1 = unmapped)."""

    def __init__(self, kp, vp, pt, *, page: int):
        self.kp = kp
        self.vp = vp
        self.pt = pt
        self.page = int(page)

    def __repr__(self):
        return (f"PagedKVCache(page={self.page}, pool={tuple(self.kp.shape)}, "
                f"pt={tuple(self.pt.shape)})")


def write_target(pt, posb, page: int, *, ring: bool):
    """Physical page + in-page offset each batch row writes its new token to.

    pt (B, NB) page table; posb (B,) absolute positions. Append caches use
    block pos // page; sliding-window rings reuse table slot
    (pos // page) % NB — the page divides the ring length NB * page, so the
    ring storage slot pos % S lands in table slot (pos // page) % NB at
    offset pos % page, and rotated-out positions recycle the same physical
    pages in place. Unmapped entries (idle slots, reclaimed rows) clamp to
    the scratch page."""
    NB = pt.shape[1]
    lb = (posb // page) % NB if ring else (posb // page).clamp(0, NB - 1)
    lb = lb.long()
    praw = torch.gather(pt, 1, lb[:, None])[:, 0]
    return praw.clamp(min=SCRATCH_PAGE).long(), (posb % page).long()


def ring_positions(ring_len: int, plen: int, device=None):
    """The prompt position each ring slot s holds after a prompt of `plen`
    tokens: the LATEST position p < plen with p = s (mod ring_len); negative
    where the prompt never reached slot s. The layout
    `write_target(ring=True)` produces at decode time."""
    s = torch.arange(ring_len, device=device)
    return s + torch.div(plen - 1 - s, ring_len, rounding_mode="floor") * \
        ring_len


def scatter_token(kp, vp, layer, k_new, v_new, phys, off):
    """In-place write of one decoded token's K/V into layer `layer`'s active
    pages: kp/vp (L, NP, page, KV, hd), k_new/v_new (B, 1, KV, hd),
    phys/off (B,). O(B) rows touched."""
    kp[layer].index_put_((phys, off), k_new[:, 0].to(kp.dtype))
    vp[layer].index_put_((phys, off), v_new[:, 0].to(vp.dtype))
    return kp, vp


def rows_and_targets(cache: PagedKVCache, posb, *, ring: bool):
    """(this rank's rows of the page table, the physical page and in-page
    offset every row of the table writes its new token to) for a decode
    at `posb`, this rank's rows' positions: under a decode layout that
    splits the rows (distributed.sharding.CacheLayout) the positions are
    gathered over the rows' line for the targets; in one process the
    whole table and `write_target`."""
    phys, off = write_target(cache.pt, gather_rows(posb), cache.page,
                             ring=ring)
    return own_rows(cache.pt), phys, off


def write_token(kp, vp, layer, k_new, v_new, phys, off):
    """`scatter_token` of one decode token's K/V, k_new / v_new this rank's
    rows and KV heads (B_loc, 1, KV_loc, hd), for every row and KV head
    (`whole_token`: gathered over the model line and the rows' line), so
    that every rank's replicated pool takes the same write; phys / off
    (B,) from `rows_and_targets`. `scatter_token` in one process."""
    KV = kp.shape[3]
    return scatter_token(kp, vp, layer, whole_token(k_new, KV),
                         whole_token(v_new, KV), phys, off)


# ---------------------------------------------------------------------------
# prefix hashing
# ---------------------------------------------------------------------------

def _digest(parent: bytes, toks) -> bytes:
    body = np.ascontiguousarray(np.asarray(toks, np.int32)).tobytes()
    return hashlib.blake2b(parent + body, digest_size=16).digest()


def chain_digests(prompt: np.ndarray, page: int) -> Tuple[List[bytes], bytes]:
    """(per-full-page chain digests, full-prompt digest). The chain makes a
    page digest cover every token before it, which is exactly what causal
    K/V content depends on."""
    prompt = np.asarray(prompt, np.int32)
    nfull = len(prompt) // page
    digests, parent = [], _ROOT
    for i in range(nfull):
        parent = _digest(parent, prompt[i * page:(i + 1) * page])
        digests.append(parent)
    tail = prompt[nfull * page:]
    full = _digest(parent, tail) if len(tail) else parent
    return digests, full


class PrefixMatch(NamedTuple):
    shared: List[int]            # physical page per prompt block 0..n-1
    digests: List[bytes]         # chain digest per FULL prompt page
    full_digest: bytes           # digest over the entire prompt
    tail_src: Optional[int]      # fork source for a partial tail page
    first_tok: Optional[int]     # cached first generated token (full hit)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class PagePool:
    """Page tensors + host allocator. Pages are refcounted; registered
    (content-addressed) pages at refcount 0 sit in an eviction LRU instead of
    the free list, so a hot system prompt survives its requests. Page 0 is
    reserved scratch and never allocated."""

    def __init__(self, *, layers: int, num_pages: int, page: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device="cpu"):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scratch)")
        if page < 1:
            raise ValueError("page size must be >= 1")
        self.layers = int(layers)
        self.num_pages = int(num_pages)
        self.page = int(page)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        shape = (self.layers, self.num_pages, self.page, self.kv_heads,
                 self.head_dim)
        self.kp = torch.zeros(shape, dtype=dtype, device=device)
        self.vp = torch.zeros(shape, dtype=dtype, device=device)

        self.rc = np.zeros(self.num_pages, np.int64)
        self.free: collections.deque = collections.deque(
            range(1, self.num_pages))
        self.lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.by_hash = {}     # chain digest -> physical page (full pages)
        self.meta = {}        # page -> (digest, parent, token tuple, is_full)
        self.by_parent = {}   # parent digest -> [pages] (fork candidates)
        self.first_tok = {}   # full-prompt digest -> first generated token
        self.stats = {"lookups": 0, "hits": 0, "forks": 0, "evictions": 0,
                      "allocs": 0, "prefix_tokens_reused": 0,
                      "prefill_reused": 0}

    # -- accounting -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (everything but scratch)."""
        return self.num_pages - 1

    @property
    def nbytes(self) -> int:
        return 2 * self.kp.numel() * self.kp.element_size()

    def available(self) -> int:
        """Pages an alloc() can produce right now: free + evictable LRU."""
        return len(self.free) + len(self.lru)

    def live_pages(self) -> int:
        return int(np.sum(self.rc > 0))

    # -- alloc / refcount -----------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take n pages (refcount 1 each), evicting LRU-cached registered
        pages as needed. Raises RuntimeError when the pool cannot satisfy
        the request — callers gate on available()."""
        if n > self.available():
            raise RuntimeError(
                f"page pool exhausted: want {n}, available {self.available()} "
                f"(capacity {self.capacity}, live {self.live_pages()})")
        out = []
        for _ in range(n):
            if self.free:
                pgid = self.free.popleft()
            else:
                pgid, _ = self.lru.popitem(last=False)
                self._unregister(pgid)
                self.stats["evictions"] += 1
            if self.rc[pgid] != 0:
                raise RuntimeError(f"free list held live page {pgid}")
            self.rc[pgid] = 1
            out.append(pgid)
        self.stats["allocs"] += n
        return out

    def incref(self, pgid: int):
        if self.rc[pgid] == 0:
            # revived from the LRU (registered page between users)
            self.lru.pop(pgid, None)
        self.rc[pgid] += 1

    def decref(self, pgid: int):
        if self.rc[pgid] <= 0:
            raise RuntimeError(f"decref of dead page {pgid}")
        self.rc[pgid] -= 1
        if self.rc[pgid] == 0:
            if pgid in self.meta:
                self.lru[pgid] = None        # evictable, revivable
            else:
                self.free.append(pgid)

    # -- prefix registry ------------------------------------------------------

    def match_prefix(self, prompt: np.ndarray) -> PrefixMatch:
        """Pure query (no refcount changes): which leading full pages of
        `prompt` are already resident, the fork source for its partial tail
        (a registered page whose token tuple extends the tail), and the
        cached first token on a full-prompt hit."""
        pg = self.page
        prompt = np.asarray(prompt, np.int32)
        digests, full = chain_digests(prompt, pg)
        shared: List[int] = []
        for d in digests:
            pgid = self.by_hash.get(d)
            if pgid is None:
                break
            shared.append(pgid)
        self.stats["lookups"] += len(digests)
        self.stats["hits"] += len(shared)
        tail_src = None
        first = None
        if len(shared) == len(digests):
            parent = digests[-1] if digests else _ROOT
            tail = tuple(int(t) for t in prompt[len(digests) * pg:])
            if tail:
                for cand in self.by_parent.get(parent, []):
                    ctoks = self.meta[cand][2]
                    if len(ctoks) >= len(tail) and ctoks[:len(tail)] == tail:
                        tail_src = cand
                        break
            first = self.first_tok.get(full)
        return PrefixMatch(shared, digests, full, tail_src, first)

    def register_full(self, pgid: int, digest: bytes, parent: bytes,
                      tokens: Tuple[int, ...]):
        """Content-address a full prompt page for future sharing."""
        if digest in self.by_hash or pgid in self.meta:
            return
        self.meta[pgid] = (digest, parent, tuple(tokens), True)
        self.by_hash[digest] = pgid
        self.by_parent.setdefault(parent, []).append(pgid)

    def register_tail(self, pgid: int, parent: bytes,
                      tokens: Tuple[int, ...]):
        """Register a PARTIAL tail page as a fork source only (never mapped
        directly — positions past the prompt inside it belong to its owner's
        generation and are read-masked in any fork)."""
        if pgid in self.meta or not tokens:
            return
        digest = _digest(parent, np.asarray(tokens, np.int32))
        self.meta[pgid] = (digest, parent, tuple(tokens), False)
        self.by_parent.setdefault(parent, []).append(pgid)

    def remember_first_token(self, full_digest: bytes, tok: int):
        self.first_tok[full_digest] = int(tok)

    def _unregister(self, pgid: int):
        digest, parent, _toks, is_full = self.meta.pop(pgid)
        if is_full:
            self.by_hash.pop(digest, None)
        sibs = self.by_parent.get(parent)
        if sibs is not None:
            if pgid in sibs:
                sibs.remove(pgid)
            if not sibs:
                del self.by_parent[parent]

    # -- device-side ops ------------------------------------------------------

    def copy_page(self, src: int, dst: int):
        """COW fork: duplicate page `src` into already-allocated `dst`."""
        self.kp[:, dst] = self.kp[:, src]
        self.vp[:, dst] = self.vp[:, src]
        self.stats["forks"] += 1

    def insert_blocks(self, ks, vs, phys, first_block: int):
        """Write prefill K/V stacks (L, 1, Sp, KV, hd) into pages: page-sized
        block j of the prompt (j in [first_block, first_block + len(phys)))
        goes to physical page phys[j - first_block]. Sp must be a multiple
        of the page size."""
        L, _, pg, KV, hd = self.kp.shape
        Sp = ks.shape[2]
        nb = len(phys)
        idx = torch.as_tensor(np.asarray(phys, np.int64), device=self.kp.device)
        for pool, new in ((self.kp, ks), (self.vp, vs)):
            blocks = new[:, 0].reshape(L, Sp // pg, pg, KV, hd)
            sel = blocks[:, first_block:first_block + nb].to(pool.dtype)
            pool.index_copy_(1, idx, sel)

    def insert_ring(self, ks, vs, phys, plen: int):
        """Ring-layout insert for a prompt that wraps (plen >= len(phys) *
        page): ring table slot s holds, for each position in its page, the
        LATEST prompt position congruent to it mod the ring length — the
        same layout `write_target(ring=True)` produces at decode time."""
        L, _, pg, KV, hd = self.kp.shape
        NB = len(phys)
        dev = self.kp.device
        pc = ring_positions(NB * pg, plen, dev).clamp(0, ks.shape[2] - 1)
        idx = torch.as_tensor(np.asarray(phys, np.int64), device=dev)
        for pool, new in ((self.kp, ks), (self.vp, vs)):
            sel = new[:, 0].index_select(1, pc).reshape(L, NB, pg, KV, hd)
            pool.index_copy_(1, idx, sel.to(pool.dtype))

    def cache(self, pt) -> PagedKVCache:
        """The view for one decode step over page table `pt`."""
        return PagedKVCache(self.kp, self.vp, pt, page=self.page)

    def gather_slot(self, row: np.ndarray, length: int) -> tuple:
        """Host-side contiguous (L, length, KV, hd) K/V view of one page
        table row — for tests/inspection, not the serving path."""
        pg = self.page
        nb = (length + pg - 1) // pg
        phys = np.asarray(row[:nb], np.int64)
        if np.any(phys < 0):
            raise ValueError("gather_slot: unmapped page in requested range")
        idx = torch.as_tensor(phys, device=self.kp.device)
        k = self.kp[:, idx].reshape(self.layers, nb * pg, self.kv_heads,
                                    self.head_dim)
        v = self.vp[:, idx].reshape(self.layers, nb * pg, self.kv_heads,
                                    self.head_dim)
        return k[:, :length].cpu(), v[:, :length].cpu()
