"""Training loop, single process on one device: the SPION three phases.

  data -> train step (dense phase) -> SPION capture at each epoch boundary
  -> Frobenius transition -> pattern generation (host flood fill) -> sparse
  phase, whose attention forward and backward run the block-sparse Hopper
  kernels on the card.

    python -m repro_torch.launch.train --arch spion-lra            # the card
    python -m repro_torch.launch.train --arch spion-lra --reduced \\
        --steps 30 --steps-per-epoch 5 --seq-len 128 --batch 2 \\
        --sparse-kernel fused --device cpu                        # the CPU

The JAX package's trainer also checkpoints, heartbeats, injects faults,
rolls back on divergence, handles preemption and spans processes over a
mesh. Those wait in ROADMAP.md: asking for them (`ckpt_dir=`, `mesh=`)
raises NotImplementedError naming the item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.spion import SpionController, SpionState
from repro_torch.data.synthetic import lm_batch_iterator
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


class Trainer:
    def __init__(self, cfg, *, seq_len, batch, lr=3e-4, total_steps=1000,
                 ckpt_dir=None, mesh=None, seed=0, steps_per_epoch=50,
                 data_iter=None, data_fn=None, sparse_kernel=None,
                 params=None, device=None):
        if ckpt_dir is not None:
            raise NotImplementedError(
                "checkpointing (ckpt_dir=) is not ported yet; it waits in "
                "ROADMAP.md item A8 (checkpoint/manager.py)")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training (mesh=) is not ported yet; it waits "
                "in ROADMAP.md item A12")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bundle = build(cfg)
        self.seq_len = seq_len
        self.steps_per_epoch = steps_per_epoch
        self.spion_ctl = SpionController(cfg.spion, causal=cfg.causal,
                                         seq_len=seq_len)
        self.spion_state = SpionState()
        self.step = 0
        # `data_fn(step) -> host batch` is step-indexed, so a run replays the
        # exact batch sequence; otherwise batches come from `data_iter` or a
        # seeded synthetic LM stream
        self.data_fn = data_fn
        if data_fn is None:
            rng = np.random.default_rng(seed)
            self.data = data_iter if data_iter is not None else \
                lm_batch_iterator(rng, batch=batch, seq_len=seq_len + 1,
                                  vocab=cfg.vocab_size)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.bundle.init(gen, device=self.device)
        self.params = masters_of(params).to(self.device)
        self.opt = adamw_init(self.params)
        self._dense_step = make_train_step(cfg, spion=False, lr=lr,
                                           total_steps=total_steps)
        self._sparse_step = make_train_step(cfg, spion=True, lr=lr,
                                            total_steps=total_steps,
                                            sparse_kernel=sparse_kernel)
        self._exec = None            # the plan's exec, tables on the device
        self._exec_tables = None

    def _next_batch(self):
        b = self.data_fn(self.step) if self.data_fn else next(self.data)
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in b.items()}

    def _attention_exec(self):
        """The sparse phase's exec with its tables on the device, built once
        per plan (None in the dense phase)."""
        tables = self.spion_state.tables
        if tables is not self._exec_tables:
            ex = self.spion_ctl.attention_exec(self.spion_state)
            self._exec = None if ex is None else ex.to(self.device)
            self._exec_tables = tables
        return self._exec

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
        with torch.no_grad():
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

    def train(self, num_steps, *, log_every=10, log=print):
        """Run `num_steps` steps; returns their losses."""
        t_total = time.time()
        losses = []
        target = self.step + num_steps
        while self.step < target:
            batch = self._next_batch()
            t0 = time.time()
            metrics = self._one_step(batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            if self.step % log_every == 0:
                log(f"step {self.step} loss {np.mean(losses[-log_every:]):.4f} "
                    f"phase {self.spion_state.phase} dt {dt * 1e3:.0f}ms")
            if self.step % self.steps_per_epoch == 0:
                self._epoch_boundary(batch)
        log(f"done: {num_steps} steps in {time.time() - t_total:.1f}s, "
            f"final phase={self.spion_state.phase} "
            f"density={self.spion_state.density}")
        return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spion-lra")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps-per-epoch", type=int, default=50,
                    help="steps between SPION capture and transition checks")
    ap.add_argument("--sparse-kernel", default=None,
                    choices=["auto", "jnp", "fused"],
                    help="sparse-phase attention on CPU tensors (default: "
                         "cfg.spion.kernel); on the card it is always the "
                         "Hopper kernels")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tr = Trainer(cfg, seq_len=args.seq_len, batch=args.batch,
                 steps_per_epoch=args.steps_per_epoch,
                 sparse_kernel=args.sparse_kernel, device=args.device)
    tr.train(args.steps)


if __name__ == "__main__":
    main()
