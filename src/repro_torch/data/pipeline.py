"""Sharded host -> device data pipeline: a background prefetch thread and
each rank's slice of the global batch (the JAX package's
`data/pipeline.py`).

Every rank reads the same global host batch; `local_batch` keeps this
rank's shard of it (the batch axis over the mesh's 'pod' x 'data' axes,
the sequence over 'seq' when the mesh has one: distributed/sharding.
batch_spec) and moves it to the rank's device, through pinned memory with
a non-blocking copy when that device is a card. A vlm batch's sequence is
[patches, text] (`patch_embeds` then `tokens`), so its 'seq' shard is a
contiguous cut of that concatenation (`vlm_seq_cut`), not of each array.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import (batch_spec, local_slices,
                                              seq_size)


def vlm_seq_cut(mesh, patches: int, text: int):
    """(patch slice, text slice) of this rank's 'seq' shard of a vlm
    sequence of `patches` patch positions followed by `text` tokens: the
    rank's contiguous cut of the concatenation. The labels and the loss
    mask follow the text slice (empty on a shard of patches only)."""
    n = seq_size(mesh)
    L = patches + text
    if L % n:
        raise ValueError(f"a vlm sequence of {patches} patches + {text} "
                         f"tokens does not split over |seq| = {n}")
    lo = mesh.axis_index("seq") * (L // n)
    hi = lo + L // n
    return (slice(min(lo, patches), min(hi, patches)),
            slice(max(lo - patches, 0), max(hi - patches, 0)))


def host_shard(mesh, batch, *, pin=False):
    """{name: array} global host batch -> this rank's shard of each array
    (`batch_spec`) as a CPU tensor (pinned when `pin`); without a mesh the
    whole batch."""
    sharded = mesh is not None and mesh.size > 1
    cut = None
    if sharded and seq_size(mesh) > 1 and "patch_embeds" in batch:
        cut = vlm_seq_cut(mesh, np.shape(batch["patch_embeds"])[1],
                          np.shape(batch["tokens"])[1])
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if cut is not None and a.ndim >= 2:
            # the batch axis as usual, the sequence by the vlm cut
            rows = local_slices(mesh, batch_spec(mesh, 1), a.shape)[0]
            a = a[rows, cut[0] if k == "patch_embeds" else cut[1]]
        elif sharded:
            a = a[local_slices(mesh, batch_spec(mesh, a.ndim), a.shape)]
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = t.pin_memory() if pin else t
    return out


def to_device(shard, device):
    """Host shard -> `device` (non-blocking from pinned memory)."""
    return {k: t.to(device, non_blocking=t.is_pinned())
            for k, t in shard.items()}


def local_batch(mesh, batch, device):
    """This rank's shard of the global host `batch` on `device`."""
    device = torch.device(device)
    return to_device(host_shard(mesh, batch, pin=device.type == "cuda"),
                     device)


class ShardedBatcher:
    """Wraps a host iterator of numpy batches (the global batch, the same on
    every rank); a thread prefetches `depth` of them and cuts this rank's
    shard into pinned memory, and `next()` copies it to `device` (the card
    unless the caller asks for the CPU: `resolve_device`). An error of the
    iterator or of the slicing surfaces at the `next()` that would have
    returned its batch."""

    def __init__(self, it: Iterator, mesh=None, depth: int = 2,
                 device=None):
        self.it = it
        self.mesh = mesh
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for b in self.it:
                if self._stop.is_set():
                    return
                self.q.put(host_shard(self.mesh, b,
                                      pin=self.device.type == "cuda"))
            self.q.put(StopIteration)
        except Exception as e:  # noqa: BLE001 - surfaced on next()
            self.err = e
            self.q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is StopIteration:
            if self.err:
                raise self.err
            raise StopIteration
        return to_device(item, self.device)

    def close(self):
        self._stop.set()
