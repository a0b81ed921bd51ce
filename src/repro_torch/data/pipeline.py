"""Sharded host -> device data pipeline: a background prefetch thread and
each rank's slice of the global batch (the JAX package's
`data/pipeline.py`).

Every rank reads the same global host batch; `local_batch` keeps this
rank's shard of it (the batch axis over the mesh's 'pod' x 'data' axes,
the sequence over 'seq' when the mesh has one: distributed/sharding.
batch_spec) and moves it to the rank's device, through pinned memory with
a non-blocking copy when that device is a card.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import batch_spec, local_slices


def host_shard(mesh, batch, *, pin=False):
    """{name: array} global host batch -> this rank's shard of each array
    (`batch_spec`) as a CPU tensor (pinned when `pin`); without a mesh the
    whole batch."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if mesh is not None and mesh.size > 1:
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
