"""GPipe pipeline parallelism over one mesh axis: the JAX package's
`distributed/pipeline.py` for ranks that each hold their stage.

`pipeline_apply(mesh, axis, stage_fn, stage_params, x, n_micro)` runs
`stage_fn(params, act) -> act` as an S-stage pipeline, S = |axis|: the
rank at index s of its line along `axis` is stage s and passes the
parameters of that stage alone (the reference stacks every stage's on a
leading dimension split over the axis). Every rank passes the whole batch
x and stage 0 reads it; every rank gets the whole output. As in the
reference, the activation keeps its shape and dtype from stage to stage,
and no config field or trainer path calls it.

  - **Schedule.** x is cut into n_micro microbatches; stage s runs
    microbatch m once stage s - 1 has sent it (tick m + s of the
    reference's scan) and sends its output to stage s + 1. The reference
    also computes on zeros in the bubble ticks and throws those results
    away; here they are skipped (the result is the same).
  - **Gradients.** One autograd Function a call. Its forward runs the
    wave without autograd and keeps each microbatch's stage input; its
    backward runs the reverse wave, last microbatch first: stage S - 1
    takes its own cotangent of the output, each stage recomputes
    `stage_fn` on the kept input (`stage_backward`), keeps its
    parameters' gradients and sends the input's gradient to stage s - 1.
    Every message's order is fixed on every rank, so neighbours cannot
    deadlock. The output's broadcast from the last stage is the
    reference's sum over the axis, whose backward is the identity: the
    cotangent counts once, not once a stage. x's gradient (stage 0's) is
    summed over the line, so every rank holds the whole of it, as the
    reference's replicated x does; every rank must then pass an x that
    requires grad, or none.
  - **Transport.** The hops are point-to-point messages on the axis line
    (`runtime.send_recv`: through pinned host buffers where gloo
    carries CUDA tensors), the output a broadcast, dx an all_reduce.
  - `stage_fn` runs with no mesh in force (a one-device block); the
    Function keeps the line's group from the forward, since the backward
    of CUDA tensors runs on autograd's device thread.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed.runtime import send_recv, transport
from repro_torch.distributed.sharding import mesh_context

hop_seconds = 0.0   # host seconds in the pipeline's messages, waits included


class _Line:
    """This rank's line along the pipeline axis: its stage index, the
    line's global ranks and group, and whether messages are host-staged."""

    def __init__(self, mesh, axis, like):
        self.ranks = mesh.line(axis)
        self.stage = mesh.axis_index(axis)
        self.n = len(self.ranks)
        self.group = mesh.group(axis) if self.n > 1 else None
        self.staged = self.group is not None and \
            transport(self.group, like) == "host-p2p"

    @property
    def first(self):
        return self.stage == 0

    @property
    def last(self):
        return self.stage == self.n - 1

    def send(self, t, step):
        """Send `t` to the stage `step` (+1 or -1) away."""
        self._timed(lambda: send_recv(
            self.group, [(t.contiguous(), self.ranks[self.stage + step])],
            [], self.staged))

    def recv(self, like, step):
        """Receive a tensor shaped like `like` from the stage `step` away."""
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        self._timed(lambda: send_recv(
            self.group, [], [(buf, self.ranks[self.stage + step])],
            self.staged))
        return buf

    def broadcast_last(self, t):
        self._timed(lambda: dist.broadcast(t, src=self.ranks[-1],
                                           group=self.group))

    def sum(self, t):
        self._timed(lambda: dist.all_reduce(t, group=self.group))

    @staticmethod
    def _timed(fn):
        global hop_seconds
        t0 = time.perf_counter()
        fn()
        hop_seconds += time.perf_counter() - t0


def stage_backward(stage_fn, leaves, spec, needs, a, dy, need_da):
    """One microbatch's backward on one stage: `stage_fn` run again on its
    input `a` with autograd, and the gradients of `dy` with respect to a
    (when `need_da`; else None) and to each leaf whose `needs` is set
    (else None; zeros where the stage does not read it)."""
    with torch.enable_grad(), mesh_context(None):
        ls = [leaf.detach().requires_grad_(n) for leaf, n in
              zip(leaves, needs)]
        a = a.detach().requires_grad_(need_da)
        y = stage_fn(tree_unflatten(ls, spec), a)
        wrt = ([a] if need_da else []) + [leaf for leaf in ls
                                          if leaf.requires_grad]
        got = list(torch.autograd.grad(y, wrt, dy, allow_unused=True))
    da = got.pop(0) if need_da else None
    if need_da and da is None:
        da = torch.zeros_like(a)
    grads = []
    for leaf in ls:
        g = None
        if leaf.requires_grad:
            g = got.pop(0)
            g = torch.zeros_like(leaf) if g is None else g
        grads.append(g)
    return da, grads


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, line, stage_fn, spec, n_micro, x, *leaves):
        xs = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        params = tree_unflatten(list(leaves), spec)
        out = torch.empty_like(xs)
        inputs = []
        with mesh_context(None):
            for m in range(n_micro):
                a = xs[m] if line.first else line.recv(xs[m], -1)
                inputs.append(a)
                y = stage_fn(params, a)
                if y.shape != a.shape or y.dtype != a.dtype:
                    raise ValueError(
                        f"pipeline stage {line.stage} maps {tuple(a.shape)} "
                        f"{a.dtype} to {tuple(y.shape)} {y.dtype}; a stage "
                        "keeps the activation's shape and dtype")
                if line.last:
                    out[m] = y
                else:
                    line.send(y, +1)
        if line.n > 1:
            line.broadcast_last(out)
        ctx.line, ctx.stage_fn, ctx.spec = line, stage_fn, spec
        ctx.inputs, ctx.leaves = inputs, leaves
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        line, inputs = ctx.line, ctx.inputs
        n_micro = len(inputs)
        need_dx = ctx.needs_input_grad[4]
        needs = ctx.needs_input_grad[5:]
        gs = g.reshape(n_micro, g.shape[0] // n_micro, *g.shape[1:])
        dx = torch.zeros_like(gs) if need_dx else None
        acc = [None] * len(needs)
        for m in reversed(range(n_micro)):
            dy = gs[m] if line.last else line.recv(inputs[m], +1)
            da, grads = stage_backward(ctx.stage_fn, ctx.leaves, ctx.spec,
                                       needs, inputs[m], dy,
                                       need_da=need_dx or not line.first)
            for i, gi in enumerate(grads):
                if gi is not None:
                    acc[i] = gi if acc[i] is None else acc[i] + gi
            if not line.first:
                line.send(da, -1)
            elif need_dx:
                dx[m] = da
        if need_dx:
            if line.n > 1:
                line.sum(dx)
            dx = dx.reshape(g.shape)
        del ctx.inputs, ctx.leaves
        return (None, None, None, None, dx, *acc)


def pipeline_apply(mesh, axis, stage_fn, stage_params, x, n_micro: int):
    """Run `stage_fn(stage_params, act) -> act` as a GPipe pipeline over
    `axis` of `mesh` (a mesh whose process groups are built). This rank is
    the stage at its index along `axis` and `stage_params` (a tree of
    tensors) are that stage's; x (B, ...) is the whole batch on every
    rank, B a multiple of `n_micro` (else ValueError). Returns the whole
    (B, ...) output on every rank, differentiable in x and in the stage's
    parameters."""
    if axis not in mesh.shape:
        raise ValueError(f"{mesh} has no axis {axis!r}")
    B = x.shape[0]
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"a batch of {B} does not split into {n_micro} "
                         "microbatches")
    leaves, spec = tree_flatten(stage_params)
    line = _Line(mesh, axis, x)
    return _Pipeline.apply(line, stage_fn, spec, n_micro, x, *leaves)
