"""Training loop on one device or as a data-parallel job of N processes:
the SPION three phases, with checkpoints, resume, divergence rollback and
fault injection.

  data -> train step (dense phase) -> SPION capture at each epoch boundary
  -> Frobenius transition -> pattern generation (host flood fill) -> sparse
  phase, whose attention forward and backward run the block-sparse Hopper
  kernels on the card -> checkpoints (atomic, async, keep-K, the plan
  tables beside the state).

    python -m repro_torch.launch.train --arch spion-lra            # the card
    python -m repro_torch.launch.train --arch spion-lra --reduced \\
        --steps 30 --steps-per-epoch 5 --seq-len 128 --batch 2 \\
        --sparse-kernel fused --device cpu                        # the CPU

Self-healing, as in the JAX package's trainer: with `ckpt_dir` every save
keeps the SPION plan (`spion_*` extra arrays) and the data offset, so
`maybe_resume()` continues step-exactly, plan and all; a DivergenceSentinel
checks every step's loss for NaN/inf and EWMA spikes and rolls back to the
last *good* (pinned) checkpoint, skipping the offending data window; a
SIGTERM saves at the current step and exits cleanly; and the heartbeat file
(`hb_0`, JSON {ts, step, phase, ...}) lets `python -m
repro_torch.launch.supervise` respawn a worker that died or hung. A step is
retried only after an I/O error (distributed/fault.StepSupervisor), and
only from the last checkpoint, on the batch of the step restored; without a
checkpoint the error re-raises. A failure of the card or of a kernel ends
the process, and the supervisor restarts it from the last checkpoint.

Multi-process (the JAX package's multi-host trainer): launch one process
per rank with the SPION_* environment (or --coordinator / --num-processes /
--process-id), as `python -m repro_torch.launch.supervise --nproc N` does.
`distributed/runtime.initialize` joins the process group, the mesh is
`make_distributed_mesh()` (the 'pod' axis over the processes: data
parallelism), and each rank trains on its slice of the global batch on
its own card (`cuda:{local_rank % device_count}`; ranks share cards when
there are fewer): the loss is the global batch's mean and the gradients
are all-reduced, so the replicated parameters stay equal. The capture's
statistics are averaged over the ranks, the flood fill runs on process 0
and its plan is broadcast and digest-checked, process 0 writes the
checkpoints that every process reads (commit barrier), and the per-step
flags (preemption, divergence) are OR-reduced, so a SIGTERM on one rank
saves the whole fleet at the same step. `_emit` prints on process 0; every
process has its heartbeat file hb_{process_index}.

A 'seq' job passes `mesh=make_seq_mesh(seq, data)` or
`make_distributed_mesh(seq=, data=)`: each rank holds its data shard's
sequences cut into |seq| contiguous shards of the sequence (whisper: of
the frames and of the decoder tokens), the dense and sparse steps and the
capture run on the shards (every rank ends the capture with the whole
pooled map), and the rest is as above. Every family trains so: the
recurrent ones (hybrid, ssm) carry their scan state across the shards,
which must then hold whole chunks of the scan.

A 'model' job passes `mesh=make_distributed_mesh(model=, data=)` (or
`--model N` on the command line), for every family: every rank starts
from the same masters (process 0's, broadcast) and keeps its shard of each
leaf (distributed/sharding.param_pspecs; Mamba2's packed in_proj by
segment and head where the scan splits by heads, `sharding.local_index`),
its AdamW moments under the same spec; the steps run tensor, expert and vocabulary parallelism
(launch/steps.py), the capture averages its heads over the model line, and
the checkpoint stays mesh-agnostic: process 0's model line gathers every
sharded leaf and its moments before process 0 writes, and a restore cuts
the whole leaves by the current mesh, so a checkpoint moves between one
process and a 'model' job both ways. Head counts |model| does not divide
take the reference's fallback (every head on every rank of a model line,
the leaves still the reference's spec shards). 'seq' composes with
'model' (`make_distributed_mesh(seq=, model=)`: the reference's
long-context mesh); every rank of a model line holds the same shard of
the batch. A scan width |model| does not divide (the hybrid's SSM heads
or 2N, the ssm family's heads) takes the reference's fallback too (every
head of the scan on every rank, in_proj cut contiguously: models/mamba.py,
models/rwkv.py).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.spion import SpionController, SpionState
from repro_torch.data.pipeline import local_batch
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.distributed import process_count as env_process_count
from repro_torch.distributed import runtime
from repro_torch.distributed.chaos import ChaosMonkey
from repro_torch.distributed.fault import (DivergenceSentinel, Heartbeat,
                                           StepSupervisor, StragglerMonitor)
from repro_torch.distributed.sharding import (data_axes, gather_params,
                                              local_index, mesh_context,
                                              model_size, param_pspecs,
                                              seq_size, shard_params)
from repro_torch.launch.mesh import make_distributed_mesh
from repro_torch.launch.steps import compute_params, make_train_step
from repro_torch.models.layers import ParamTree, tree_map
from repro_torch.models.registry import build
from repro_torch.optim import adamw_init


def masters_of(params):
    """fp32 master weights that require grad: tensors with ndim >= 2 in
    fp32, the others in their own dtype, all copied."""
    return ParamTree(tree_map(
        lambda x: x.detach().to(torch.float32 if x.ndim >= 2 else x.dtype,
                                copy=True), params), trainable=True)


def nest(named):
    """{dotted name: value} -> nested dicts by the name's parts (the
    ParamTree's tree paths), the layout of the JAX package's trees."""
    out = {}
    for name, v in named.items():
        *head, last = name.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class Trainer:
    def __init__(self, cfg, *, seq_len, batch, lr=3e-4, total_steps=1000,
                 ckpt_dir=None, mesh=None, seed=0, steps_per_epoch=50,
                 data_iter=None, data_fn=None, sparse_kernel=None,
                 chaos=None, heartbeat_interval=5.0, sentinel=None,
                 max_rollbacks=3, step_callback=None, params=None,
                 device=None):
        if env_process_count() > 1 and not runtime.is_initialized():
            raise RuntimeError(
                f"SPION_NUM_PROCESSES={env_process_count()} but this process "
                "has not joined the job: call repro_torch.distributed."
                "runtime.initialize() first (launch/train.main does)")
        if mesh is None and runtime.process_count() > 1:
            mesh = make_distributed_mesh()
        if mesh is not None:
            ndata = mesh.axis_size(data_axes(mesh))
            if batch % ndata:
                raise ValueError(f"global batch {batch} does not split over "
                                 f"the {ndata} data-parallel ranks")
            nseq, blk = seq_size(mesh), cfg.spion.block_size
            if nseq > 1 and seq_len % (nseq * blk):
                raise ValueError(f"seq_len {seq_len} does not split over "
                                 f"|seq| = {nseq} shards of whole blocks of "
                                 f"{blk}")
            chunk = min(cfg.ssm.chunk, seq_len) if cfg.ssm else 1
            if nseq > 1 and seq_len % (nseq * chunk):
                raise ValueError(f"seq_len {seq_len} does not split over "
                                 f"|seq| = {nseq} shards of whole chunks of "
                                 f"{chunk} (the scan's chunks must be the "
                                 f"whole sequence's)")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.cfg = cfg
        if device is None and self.mesh is not None:
            device = runtime.local_device()
        self.device = resolve_device(device)
        self.bundle = build(cfg)
        self.seq_len = seq_len
        self.steps_per_epoch = steps_per_epoch
        self.spion_ctl = SpionController(cfg.spion, causal=cfg.causal,
                                         seq_len=seq_len)
        self.spion_state = SpionState()
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
        self.step = 0
        # `data_fn(step) -> host batch` is the fault-tolerant data contract:
        # step-indexed, so a resume replays the exact batch sequence the
        # uninterrupted run would have seen (a bare iterator restarts from
        # its beginning after a crash); otherwise batches come from
        # `data_iter` or a seeded synthetic LM stream (the encdec family's
        # with `seq_len` frames of standard normal embeddings a sequence)
        self.data_fn = data_fn
        if data_fn is None:
            rng = np.random.default_rng(seed)
            self.data = data_iter if data_iter is not None else \
                lm_batch_iterator(rng, batch=batch, seq_len=seq_len + 1,
                                  vocab=cfg.vocab_size)
            if data_iter is None and cfg.family in ("audio", "encdec"):
                self.data = ({**b, "frames": rng.standard_normal(
                    (batch, seq_len, cfg.d_model)).astype(np.float32)}
                    for b in self.data)
        # fault machinery: chaos is env-armed by default (inert when the
        # launcher sets no SPION_CHAOS_* vars); the SIGTERM handler
        # (install_preemption_handler) sets the preemption flag
        self.chaos = chaos if chaos is not None else ChaosMonkey.from_env()
        self._preempted = False
        self.preempted = False          # observable: loop exited via preemption
        # divergence sentinel: default-on loss health check; pass
        # sentinel=False to disable
        self.sentinel = DivergenceSentinel() if sentinel is None \
            else (sentinel or None)
        self.max_rollbacks = max_rollbacks
        self.step_callback = step_callback
        self.data_offset = 0            # data windows skipped by rollbacks
        self.good_step = None           # last checkpoint known loss-healthy
        self.rollback_count = 0         # observable: total rollbacks performed
        self.loss_history = {}          # step -> loss; replays overwrite (stitched)
        self.events = []                # structured fault events (also printed)
        self._diverged_pending = False
        self._diverge_step = None
        self._last_diverge_step = None
        self._rollback_streak = 0       # consecutive rollbacks w/o healthy progress
        self._straggler_steps = 0
        self.heartbeat = None
        if ckpt_dir:
            self.heartbeat = Heartbeat(
                os.path.join(ckpt_dir, f"hb_{runtime.process_index()}"),
                interval=heartbeat_interval)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.bundle.init(gen, device=self.device)
        self.params = masters_of(params).to(self.device)
        if self.mesh is not None:
            # replicated from process 0, whatever each process drew
            with torch.no_grad():
                runtime.broadcast_tensors(list(self.params.parameters()),
                                          group=self.mesh.group(
                                              self.mesh.axis_names))
        # on a 'model' axis: the specs of the whole leaves, and each rank
        # keeps its shard of them (bitwise the one-process masters' slice)
        self._specs = self._full = None
        if self.mesh is not None and model_size(self.mesh) > 1:
            self._specs = param_pspecs(self.params, self.mesh)
            self._full = {n: (tuple(p.shape), p.dtype)
                          for n, p in self.params.named_parameters()}
            self.params = ParamTree(nest(shard_params(
                self.params, self.mesh, self._specs, cfg)), trainable=True)
        self.opt = adamw_init(self.params)
        self._dense_step = make_train_step(cfg, spion=False, lr=lr,
                                           total_steps=total_steps,
                                           mesh=self.mesh, specs=self._specs)
        self._sparse_step = make_train_step(cfg, spion=True, lr=lr,
                                            total_steps=total_steps,
                                            sparse_kernel=sparse_kernel,
                                            mesh=self.mesh, specs=self._specs)
        self._exec = None            # the plan's exec, tables on the device
        self._exec_tables = None
        # maybe_resume is False without a checkpoint: then no retry
        self.supervisor = StepSupervisor(self.maybe_resume)

    def install_preemption_handler(self):
        """SIGTERM -> finish the in-flight step, then save and exit cleanly.
        Main thread only."""
        def _handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, _handler)

    def _device_batch(self, batch):
        """Host batch -> this rank's slice on its device. Every process
        holds the same global batch; under a mesh each keeps its shard of
        the batch axis ('pod' x 'data') and of the sequence ('seq')."""
        if self.mesh is not None:
            return local_batch(self.mesh, batch, self.device)
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def _next_batch(self):
        # `+ data_offset`: each divergence rollback advances the offset past
        # the poisoned window, so the replayed steps see fresh data while
        # staying step-indexed (resume-exact)
        b = self.data_fn(self.step + self.data_offset) if self.data_fn \
            else next(self.data)
        return self._device_batch(b)

    # -- checkpoint/restart --------------------------------------------------

    def _state_tree(self):
        """{"params", "opt": {"count", "mu", "nu"}} as nested dicts of the
        live tensors: the JAX trainer's state tree, leaf for leaf."""
        return {"params": nest(dict(self.params.named_parameters())),
                "opt": {"count": self.opt["count"],
                        "mu": nest(self.opt["mu"]),
                        "nu": nest(self.opt["nu"])}}

    def _checkpoint_tree(self):
        """The state tree a checkpoint holds: `_state_tree()`, with every
        leaf that 'model' splits (and its moments) gathered over the model
        line on process 0's line, the one whose tree is written."""
        tree = self._state_tree()
        if self._specs is None or 0 not in self.mesh.line("model"):
            return tree

        def whole(named):
            return nest(gather_params(named, self._specs, self.mesh,
                                      self.cfg))
        return {"params": whole(dict(self.params.named_parameters())),
                "opt": {"count": self.opt["count"],
                        "mu": whole(self.opt["mu"]),
                        "nu": whole(self.opt["nu"])}}

    def _restore_target(self):
        """The restore's target: the live tree, or on a 'model' axis host
        tensors of the whole leaves' shapes (the checkpoint is
        mesh-agnostic)."""
        if self._specs is None:
            return self._state_tree()

        def whole():
            return nest({n: torch.empty(shape, dtype=dtype)
                         for n, (shape, dtype) in self._full.items()})
        return {"params": whole(),
                "opt": {"count": self.opt["count"], "mu": whole(),
                        "nu": whole()}}

    def _local(self, name, x):
        """A restored leaf -> this rank's shard of it on the device."""
        if self._specs is not None:
            x = x[local_index(self.mesh, name, self._specs[name], x.shape,
                              self.cfg)]
        return x.to(self.device).contiguous()

    def save(self):
        if not self.ckpt:
            return
        # plan tables go binary (extra_arrays); the JSON extra keeps only
        # scalars. A step with a divergence flag pending is saved but NOT
        # promoted to good_step (its state is already poisoned); the
        # rollback quarantines it.
        healthy = not self._diverged_pending
        if healthy:
            # pin BEFORE the (async) write: _gc runs on the writer thread
            # and must already see the new good step as protected
            self.ckpt.pin(self.step)
        arrays = self.spion_state.table_arrays()
        self.ckpt.save(
            self.step, self._checkpoint_tree(),
            extra={"spion": self.spion_state.to_py(include_tables=False),
                   "step": self.step, "data_offset": self.data_offset},
            extra_arrays=None if arrays is None else
            {f"spion_{k}": v for k, v in arrays.items()})
        if healthy:
            if self.good_step is not None and self.good_step != self.step:
                self.ckpt.unpin(self.good_step)
            self.good_step = self.step
            if (self._last_diverge_step is not None
                    and self.step > self._last_diverge_step):
                self._rollback_streak = 0  # healthy progress past the spike

    @torch.no_grad()
    def _restore_latest(self, step=None):
        """Restore the latest (or the given) checkpoint into the live state;
        False if there is none."""
        if not self.ckpt:
            return False
        tree, got, extra = self.ckpt.restore(step=step,
                                             target=self._restore_target())
        if tree is None:
            return False
        # into the live tensors: the masters in place (the step's autograd
        # leaves stay the same objects), the moments and count replaced
        for name, p in self.params.named_parameters():
            *head, last = name.split(".")
            node, mu, nu = tree["params"], tree["opt"]["mu"], \
                tree["opt"]["nu"]
            for k in head:
                node, mu, nu = node[k], mu[k], nu[k]
            p.copy_(self._local(name, node[last]))
            self.opt["mu"][name] = self._local(name, mu[last])
            self.opt["nu"][name] = self._local(name, nu[last])
        self.opt["count"] = tree["opt"]["count"]
        self.step = int(extra.get("step", got or 0))
        self.data_offset = int(extra.get("data_offset", 0))
        # whatever we restore from is by definition our rollback target
        # until a newer healthy save supersedes it — pin it so GC can't
        # age it out of the keep window while training runs past it
        self.good_step = self.step
        self.ckpt.pin(self.step)
        if extra.get("spion"):
            arrays = {k[len("spion_"):]: v
                      for k, v in extra.get("_arrays", {}).items()
                      if k.startswith("spion_")} or None
            # int32 contiguous tables in a new dict: _attention_exec keys on
            # its identity, so the next sparse step rebuilds its exec
            self.spion_state = SpionState.from_py(extra["spion"], arrays)
            self.spion_ctl.verify_plan_sync(self.spion_state)
        return True

    def maybe_resume(self):
        if self.ckpt and self.ckpt.latest_step() is not None:
            return self._restore_latest()
        return False

    # -- steps ----------------------------------------------------------------

    def _attention_exec(self):
        """The sparse phase's exec with its tables on the device, built once
        per plan (None in the dense phase)."""
        tables = self.spion_state.tables
        if tables is not self._exec_tables:
            # a new plan (the transition, a restore) builds its exec anew,
            # and so looks up the plan's tuned kernel config
            ex = self.spion_ctl.attention_exec(self.spion_state,
                                               dtype=self.cfg.dtype)
            self._exec = None if ex is None else ex.to(self.device)
            self._exec_tables = tables
        return self._exec

    def _fetch_and_step(self):
        """The step that StepSupervisor retries: a restore may rewind
        self.step, so the batch is fetched here, after it. Returns (batch,
        metrics, seconds of the step alone)."""
        batch = self._next_batch()
        t0 = time.time()
        metrics = self._one_step(batch)
        return batch, metrics, time.time() - t0

    def _one_step(self, batch):
        ex = self._attention_exec()
        if ex is not None:
            self.params, self.opt, metrics = self._sparse_step(
                self.params, self.opt, batch, self.step, ex)
        else:
            self.params, self.opt, metrics = self._dense_step(
                self.params, self.opt, batch, self.step)
        self.step += 1
        return metrics

    def capture(self, batch):
        """(pooled (Ly, nb, nb), frob_sq (Ly,)) of the dense-phase capture on
        `batch`, with the masters cast to cfg.dtype as the step casts them."""
        cap = self.spion_ctl.capture_kwargs(self.spion_state)
        with torch.no_grad(), mesh_context(self.mesh):
            pc = compute_params(self.params, getattr(torch, self.cfg.dtype))
            _, aux = self.bundle.forward(pc, batch, capture=cap)
        return aux["captured"]

    def _epoch_boundary(self, batch):
        """SPION capture + transition check on the epoch's last batch."""
        if self.spion_ctl.capture_kwargs(self.spion_state) is None:
            self.spion_state.epoch += 1
            return
        pooled, frob = self.capture(batch)
        self.spion_state = self.spion_ctl.observe_epoch(
            self.spion_state, pooled.cpu().numpy(), frob.cpu().numpy())

    def _poll_flags(self):
        """Fleet-wide (preempted, diverged): the same answer on every
        process at the same step, both flags in ONE collective, on the main
        thread at the loop top."""
        if runtime.process_count() > 1:
            return tuple(runtime.any_flags(
                [self._preempted, self._diverged_pending]))
        return self._preempted, self._diverged_pending

    def _emit(self, kind: str, **fields):
        """Structured fault event: appended to self.events on every process
        and printed as one JSON line (`SPION_EVENT {...}`) by the
        coordinator only, so a supervisor tailing stdout sees it once."""
        ev = {"event": kind, "step": self.step,
              "process": runtime.process_index()}
        ev.update(fields)
        self.events.append(ev)
        if runtime.is_coordinator():
            print("SPION_EVENT " + json.dumps(ev), flush=True)

    @torch.no_grad()
    def _poison_params(self):
        """Chaos NaN injection: fill every float master of this process with
        NaN in place; the next real step's loss diverges through the
        forward, and under a mesh through the gradient all-reduce on every
        rank."""
        for p in self.params.parameters():
            if p.is_floating_point():
                p.fill_(float("nan"))

    def _rollback(self, log):
        """Divergence rollback: every process reaches it at the same step
        (the any_flags OR) and agrees on the divergence step (max over the
        processes); quarantine the checkpoints saved after the last good
        step, restore the pinned good checkpoint, and skip the poisoned
        data window so the replay sees fresh batches. Hard-fails after
        `max_rollbacks` consecutive rollbacks with no healthy checkpoint in
        between — then the divergence is not data-borne and a human needs
        to look."""
        t0 = time.time()
        d = -1 if self._diverge_step is None else self._diverge_step
        if runtime.process_count() > 1:
            d = runtime.max_value(d)
        self.rollback_count += 1
        self._rollback_streak += 1
        if self._rollback_streak > self.max_rollbacks:
            raise RuntimeError(
                f"loss diverged through {self.max_rollbacks} consecutive "
                f"rollbacks (last at step {d}): not recoverable by replay")
        g = self.good_step
        if self.ckpt is None or g is None:
            raise RuntimeError(
                f"loss diverged at step {d} but there is no good checkpoint "
                "to roll back to (enable checkpointing / lower ckpt_every)")
        self.ckpt.quarantine_after(g)       # poisoned saves must never restore
        self._restore_latest(step=g)        # also restores data_offset as-of g
        skip = (d - g + 1) if d >= g else 1
        self.data_offset += skip
        self._diverged_pending = False
        self._diverge_step = None
        self._last_diverge_step = d
        if self.sentinel:
            self.sentinel.reset()           # don't inherit spike-adjacent EWMA
        self._emit("rollback", from_step=d, to_step=g, skip=skip,
                   data_offset=self.data_offset,
                   seconds=round(time.time() - t0, 3))
        log(f"divergence at step {d}: rolled back to step {g}, skipping "
            f"data window [{g}, {d}] (offset now {self.data_offset}, "
            f"streak {self._rollback_streak}/{self.max_rollbacks})")

    def train(self, num_steps, *, ckpt_every=100, log_every=10, log=print):
        """Run until the step counter has advanced by `num_steps` (a
        rollback replays steps, so it may take more); returns the loss of
        every step run, replays included."""
        if not runtime.is_coordinator():
            log = lambda *a, **k: None      # noqa: E731 - one log per fleet
        if self.heartbeat:
            self.heartbeat.pulse()          # announce liveness immediately
            self.heartbeat.start_thread()   # keeps ts fresh even mid-step
        try:
            return self._train_loop(num_steps, ckpt_every, log_every, log)
        finally:
            if self.heartbeat:
                self.heartbeat.stop_thread()

    def _train_loop(self, num_steps, ckpt_every, log_every, log):
        t_total = time.time()
        losses = []
        target = self.step + num_steps
        while self.step < target:
            if self.chaos:
                self.chaos.maybe_kill(self.step)
                self.chaos.maybe_hang(self.step)
            preempted, diverged = self._poll_flags()
            if diverged:
                self._rollback(log)
                continue
            if preempted:
                self.preempted = True
                self.save()
                if self.ckpt:
                    self.ckpt.wait()
                log(f"preempted: saved step {self.step}, exiting")
                return losses
            if self.chaos and self.chaos.poison_due(self.step):
                self._poison_params()
            batch, metrics, dt = self.supervisor.run(self._fetch_and_step)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.loss_history[self.step - 1] = loss  # replay overwrites: stitched
            if self.sentinel and self.sentinel.observe(loss):
                # a local observation: the fleet decides at the top of the
                # next iteration (the OR), so every process rolls back at
                # the same step
                self._diverged_pending = True
                self._diverge_step = self.step - 1
                self._emit("divergence", loss=loss,
                           streak=self._rollback_streak)
            straggler = self.monitor.observe(dt)
            if straggler:
                self._straggler_steps += 1
                self._emit("straggler", dt=round(dt, 4),
                           total=self._straggler_steps)
            if self.heartbeat:
                self.heartbeat.beat(step=self.step,
                                    phase=self.spion_state.phase,
                                    extra={"stragglers": self._straggler_steps})
            if self.step_callback:
                self.step_callback(self.step - 1, loss)
            if self.step % log_every == 0:
                log(f"step {self.step} loss {np.mean(losses[-log_every:]):.4f} "
                    f"phase {self.spion_state.phase} dt {dt * 1e3:.0f}ms"
                    + (" [straggler]" if straggler else ""))
            if self.step % self.steps_per_epoch == 0 and \
                    not self._diverged_pending:
                # a poisoned epoch boundary would flood-fill NaN capture
                # stats; the imminent rollback replays the boundary from
                # healthy state anyway
                self._epoch_boundary(batch)
            if ckpt_every and self.step % ckpt_every == 0:
                self.save()
        self.save()
        if self.ckpt:
            self.ckpt.wait()
        log(f"done: {num_steps} steps in {time.time() - t_total:.1f}s, "
            f"final phase={self.spion_state.phase} "
            f"density={self.spion_state.density}")
        return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spion-lra")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps-per-epoch", type=int, default=50,
                    help="steps between SPION capture and transition checks")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its latest step "
                         "and save into it (also where hb_0 lives)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--sparse-kernel", default=None,
                    choices=["auto", "jnp", "fused"],
                    help="sparse-phase attention on CPU tensors (default: "
                         "cfg.spion.kernel); on the card it is always the "
                         "Hopper kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; in a "
                         "multi-process job the rank's card)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="process-group rendezvous (or env "
                         "SPION_COORDINATOR); with --num-processes and "
                         "--process-id this process joins a job")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of the mesh's 'model' axis (tensor, expert "
                         "and vocabulary parallelism) in a joined job")
    args = ap.parse_args(argv)
    distributed = runtime.initialize(args.coordinator, args.num_processes,
                                     args.process_id)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_distributed_mesh(model=args.model) if distributed else None
    tr = Trainer(cfg, seq_len=args.seq_len, batch=args.batch,
                 steps_per_epoch=args.steps_per_epoch, ckpt_dir=args.ckpt_dir,
                 mesh=mesh, sparse_kernel=args.sparse_kernel,
                 device=args.device)
    tr.install_preemption_handler()
    if tr.maybe_resume() and runtime.is_coordinator():
        print(f"resumed from step {tr.step} (phase {tr.spion_state.phase})")
    tr.train(args.steps, ckpt_every=args.ckpt_every)
    # a rank of a job leaves it and ends here (runtime.shutdown)
    runtime.shutdown(0 if distributed else None)


if __name__ == "__main__":
    main()
