"""Meshes of ranks: the JAX package's `launch/mesh.py` for processes.

A JAX mesh is a grid of devices that one SPMD program spans; in PyTorch
every rank is a process with one device, so a `Mesh` here is a grid of
*ranks* with the reference's axis names ('pod', 'seq', 'data', 'model') and
one process group per line of each axis, which the collectives of that
axis run over. Each rank holds its own shard of every sharded tensor;
`coords()` says which.

Ranks fill the grid in C order (`np.arange(n).reshape(shape)`): the leading
axis is the slowest, so `make_distributed_mesh`'s 'pod' axis is the
process-major axis of the reference (`src/repro/launch/mesh.py:60-100`)
and the ranks of one line of the last axis are adjacent (a model line,
on a mesh with 'model').

A 'model' axis larger than 1 holds tensor, expert and vocabulary
parallelism for every family (distributed/sharding.py states the
layout), alone or with 'seq' and the data axes: the reference's
long-context mesh (seq, data, model). Head counts and scan widths that
|model| does not divide take the reference's fallback (every head on every
rank of a model line, from the rank's columns gathered over it).

`make_production_mesh` gives the reference's production meshes, (data 16,
model 16) = 256 ranks and (pod 2, data 16, model 16) = 512, which the dry
run (launch/dryrun.py) traces one rank of in a fake world of that size.
The card's constants below replace the reference's TPU ones in the dry
run's roofline. A (16, 16) mesh of H100s spans 32 NVLink domains of 8
cards: each model line of 16 adjacent ranks crosses InfiniBand between two
of them, so the NVLink figure makes the collective term a lower bound.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Mesh:
    """A grid of ranks with named axes. `devices` is the rank grid (its
    shape is the mesh's); `shape` maps each axis name to its size, as a JAX
    mesh's does. Process groups exist after `build_groups()`, a collective
    that every process of the job calls (`make_*` do so when a process
    group is up); a Mesh without them serves the sharding decisions
    (distributed/sharding.py), which need only its shape."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"rank grid of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names,
                              (int(n) for n in self.devices.shape)))
        self.size = int(self.devices.size)
        self._groups = None

    def __repr__(self):
        return f"Mesh({self.shape})"

    # -- this rank's place ---------------------------------------------------

    def coords(self, rank: Optional[int] = None) -> dict:
        """{axis: index} of `rank` (default: this process) in the grid."""
        if rank is None:
            from repro_torch.distributed import runtime
            rank = runtime.process_index()
        where = np.argwhere(self.devices == int(rank))
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        return self.coords(rank)[axis] if axis in self.shape else 0

    def axis_size(self, axes) -> int:
        """Product of the sizes of `axes` (a name, a tuple of names or
        None); names the mesh lacks count 1."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def flat_index(self, axes, rank: Optional[int] = None) -> int:
        """This rank's index along the flattened `axes` (first axis
        slowest): its shard of a dimension split over them."""
        if isinstance(axes, str):
            axes = (axes,)
        c = self.coords(rank)
        i = 0
        for a in axes or ():
            i = i * self.shape.get(a, 1) + c.get(a, 0)
        return i

    def line(self, axes, rank: Optional[int] = None) -> list:
        """Ranks of the line through `rank` along `axes` (the other axes
        fixed), in the order of `flat_index`."""
        if isinstance(axes, str):
            axes = (axes,)
        c = self.coords(rank)
        idx = tuple(slice(None) if a in axes else c[a]
                    for a in self.axis_names)
        sub = self.devices[idx]
        # the kept axes in mesh order; reorder to `axes` order
        kept = [a for a in self.axis_names if a in axes]
        order = [kept.index(a) for a in axes if a in kept]
        return [int(r) for r in np.transpose(sub, order).reshape(-1)]

    def sub(self, axes, rank: Optional[int] = None) -> "Mesh":
        """The mesh of the ranks that share `rank`'s (default: this
        process's) coordinates on every axis but `axes`, which it keeps in
        this mesh's order, with this mesh's process groups: a view for
        code that must not see the other axes (a decode step replicated
        over 'seq' and the data axes sees the model line alone)."""
        c = self.coords(rank)
        keep = tuple(a for a in self.axis_names if a in axes)
        idx = tuple(slice(None) if a in keep else c[a]
                    for a in self.axis_names)
        view = Mesh(self.devices[idx], keep)
        view._groups = self._groups
        return view

    # -- process groups --------------------------------------------------------

    def _group_keys(self):
        """Every axis combination that collectives run over: each axis, the
        data axes together, every axis but 'model' together (the plane the
        loss terms and gradients are summed over: launch/steps.
        reduce_axes), and the whole mesh."""
        keys = [(a,) for a in self.axis_names]
        daxes = tuple(a for a in ("pod", "data") if a in self.shape)
        plane = tuple(a for a in self.axis_names if a != "model")
        for key in (daxes, plane, self.axis_names):
            if len(key) > 1 and key not in keys:
                keys.append(key)
        return keys

    def build_groups(self):
        """Create one process group per line of every axis combination of
        `_group_keys` (a collective: every process of the job calls it, in
        the same order, members or not). The groups take the default
        backend: the device group's."""
        import torch.distributed as dist
        world = dist.get_world_size()
        groups = {}
        for key in self._group_keys():
            for rank in self.devices.reshape(-1):
                ranks = self.line(key, int(rank))
                gk = (key, tuple(ranks))
                if gk in groups or len(ranks) == 1:
                    continue   # a line of one rank has nothing to reduce
                if len(ranks) == world:
                    groups[gk] = dist.group.WORLD
                else:
                    groups[gk] = dist.new_group(ranks=ranks)
        self._groups = groups
        return self

    def group(self, axes, rank: Optional[int] = None):
        """The process group of the line through this rank along `axes`."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in self.axis_names if a in axes)
        if self._groups is None:
            raise RuntimeError(f"{self} has no process groups; build them "
                               "with build_groups() on every process")
        line = tuple(self.line(axes, rank))
        if len(line) == 1:
            raise ValueError(f"{self}: the line along {axes} holds one rank "
                             "and has no process group")
        return self._groups[(axes, line)]


def _with_groups(mesh: Mesh) -> Mesh:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        mesh.build_groups()
    return mesh


def make_mesh(shape, axes, ranks=None) -> Mesh:
    """A mesh of `shape` over `ranks` (default 0..n-1) with named axes; its
    process groups are built when a process group is up (every process of
    the job must call this together then)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    ranks = np.arange(n) if ranks is None else np.asarray(ranks)
    if ranks.size != n:
        raise ValueError(f"{ranks.size} ranks for a mesh of shape {shape}")
    return _with_groups(Mesh(ranks.reshape(shape), axes))


def make_production_mesh(*, multi_pod: bool = False, seq: int = 1) -> Mesh:
    """The reference's production meshes: (data 16, model 16), with
    `multi_pod` (pod 2, data 16, model 16); `seq` > 1 carves a 'seq' axis
    out of the data axis ((seq, 16 / seq, 16), the rank count unchanged)
    and must divide 16 (ValueError). Process groups are built when a
    process group is up (the dry run's fake world)."""
    if seq > 1:
        if 16 % seq:
            raise ValueError(f"seq={seq} must divide the data axis (16)")
        shape = (2, seq, 16 // seq, 16) if multi_pod else (seq, 16 // seq, 16)
        axes = (("pod", "seq", "data", "model") if multi_pod
                else ("seq", "data", "model"))
        return make_mesh(shape, axes)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_seq_mesh(seq: int, data: int = 1, model: int = 1) -> Mesh:
    """Explicit (seq, data) mesh over ranks 0..seq*data-1, for tests and
    sequence-parallel runs; seq ranks adjacent. With `model` > 1 the
    reference's (seq, data, model) mesh over seq*data*model ranks (model
    ranks adjacent)."""
    if model > 1:
        return make_mesh((seq, data, model), ("seq", "data", "model"))
    return make_mesh((seq, data), ("seq", "data"))


def make_host_mesh() -> Mesh:
    """Every rank of the job as a (data, model) mesh (one process: 1 x 1)."""
    from repro_torch.distributed import runtime
    return make_mesh((runtime.process_count(), 1), ("data", "model"))


def make_distributed_mesh(*, model: int = 1, seq: int = 1,
                          data: Optional[int] = None) -> Mesh:
    """Mesh over every rank of the job: the 'pod' axis leads (process-major,
    as in the reference, where it is exactly the process axis), then 'seq'
    when seq > 1, 'data' and 'model'. With the defaults every rank is its
    own 'pod' entry (data parallelism over the processes: the reference's
    multi-host trainer mesh). `data` defaults to 1; pod = ranks / (seq *
    data * model) must be whole. One process gives the same axis names at
    size 1."""
    from repro_torch.distributed import runtime
    nproc = runtime.process_count()
    data = 1 if data is None else int(data)
    per = seq * data * model
    if nproc % per:
        raise ValueError(f"seq*data*model = {seq}*{data}*{model} does not "
                         f"divide the {nproc} ranks")
    if seq > 1:
        return make_mesh((nproc // per, seq, data, model),
                         ("pod", "seq", "data", "model"))
    return make_mesh((nproc // per, data, model), ("pod", "data", "model"))


# The card's constants for the dry run's roofline: NVIDIA H100 SXM5 80GB
# data-sheet figures, at its 700 W power limit
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
NVLINK_BW_PER_GPU = 450e9     # B/s, NVLink 4, one direction, per GPU
