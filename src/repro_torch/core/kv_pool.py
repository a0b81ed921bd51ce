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

Where the JAX package donates the pool to a jitted update, the port writes
the pool tensors in place (`index_put_`, `index_copy_`). Copy-on-write
prefix sharing is not ported yet.
"""
from __future__ import annotations

import collections
from typing import List

import numpy as np
import torch

SCRATCH_PAGE = 0


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


def write_target(pt, posb, page: int):
    """Physical page + in-page offset each batch row writes its new token to.

    pt (B, NB) page table; posb (B,) absolute positions; block pos // page.
    Unmapped entries (idle slots, reclaimed rows) clamp to the scratch
    page."""
    NB = pt.shape[1]
    lb = (posb // page).clamp(0, NB - 1).long()
    praw = torch.gather(pt, 1, lb[:, None])[:, 0]
    return praw.clamp(min=SCRATCH_PAGE).long(), (posb % page).long()


def scatter_token(kp, vp, layer, k_new, v_new, phys, off):
    """In-place write of one decoded token's K/V into layer `layer`'s active
    pages: kp/vp (L, NP, page, KV, hd), k_new/v_new (B, 1, KV, hd),
    phys/off (B,). O(B) rows touched."""
    kp[layer].index_put_((phys, off), k_new[:, 0].to(kp.dtype))
    vp[layer].index_put_((phys, off), v_new[:, 0].to(vp.dtype))
    return kp, vp


class PagePool:
    """Page tensors + host allocator. Pages are refcounted; page 0 is
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

    # -- accounting -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (everything but scratch)."""
        return self.num_pages - 1

    @property
    def nbytes(self) -> int:
        return 2 * self.kp.numel() * self.kp.element_size()

    def available(self) -> int:
        """Pages an alloc() can produce right now."""
        return len(self.free)

    def live_pages(self) -> int:
        return int(np.sum(self.rc > 0))

    # -- alloc / refcount -----------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take n pages (refcount 1 each). Raises RuntimeError when the pool
        cannot satisfy the request — callers gate on available()."""
        if n > self.available():
            raise RuntimeError(
                f"page pool exhausted: want {n}, available {self.available()} "
                f"(capacity {self.capacity}, live {self.live_pages()})")
        out = []
        for _ in range(n):
            pgid = self.free.popleft()
            if self.rc[pgid] != 0:
                raise RuntimeError(f"free list held live page {pgid}")
            self.rc[pgid] = 1
            out.append(pgid)
        return out

    def incref(self, pgid: int):
        self.rc[pgid] += 1

    def decref(self, pgid: int):
        if self.rc[pgid] <= 0:
            raise RuntimeError(f"decref of dead page {pgid}")
        self.rc[pgid] -= 1
        if self.rc[pgid] == 0:
            self.free.append(pgid)

    # -- device-side ops ------------------------------------------------------

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
