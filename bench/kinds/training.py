"""A training cell: the program's `Trainer` driven from the seed through
its set-up steps, then the measured window, then the check.

Set-up, in the mix's order (reference/follow.step_phases): the
configuration as its file states it, the pool of host batches and the
initial parameters from the seed, one `Trainer` (bf16 over fp32 masters,
remat, no checkpoint directory, chaos inert, the divergence sentinel on
NaN and inf only) fed through `data_fn(step)` from the pool; `dense_steps` dense steps; for a sparse cell the program's
capture on the batch of the last of them (batch 0 when there is none,
`Trainer.capture`) and its flood fill (`SpionController.generate`);
`sparse_steps` sparse steps. The first `checked_steps` of these are what
the reference follows (harness/check.py lists what is read); the rest warm
the window's phase.

The window then runs `Trainer.train` until `seconds` have passed: the step
callback stamps the host clock after each step's loss has reached the
host (so after the step's device work) and ends the window at the first
stamp past its end. A traced run follows it with a traced window of the
mix's `trace_seconds` under torch.profiler, the batch fetch inside a span.

The sentinel's spike test stays off: the window cycles through the pool's
few batches, which a model learns by heart within a window, and the
z-score of a loss near zero then flags spikes that fresh data would not
make; with no checkpoint to roll back to, a flag can only end the run.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from bench.harness.check import compare
from bench.harness.params import make_params, nested
from bench.harness.spec import SpecError
from bench.harness.trace import WINDOW, Trace
from bench.reference.follow import (capture_index, leaf_norms, loss_count,
                                    step_phases)

B1 = 0.9                              # AdamW's first-moment decay
FETCH_SPAN = "bench.batch_fetch"


class WindowClosed(Exception):
    """Raised by the step callback at the first step past the window."""


def model_config(config):
    """The program's ModelConfig for the configuration file: its arch with
    every key of the file's `model` and `spion` sections set."""
    from repro_torch.configs import get_config
    base = get_config(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    sfields = {f.name for f in dataclasses.fields(base.spion)}
    bad = (set(config["model"]) - fields) | (set(config["spion"]) - sfields)
    if bad:
        raise SpecError(f"{config['arch']}: no such config keys {sorted(bad)}")
    spion = dataclasses.replace(base.spion, **config["spion"])
    return base.replace(**config["model"], spion=spion)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quiet(*args, **kwargs):
    pass


class Cell:
    def __init__(self, spec, seed, device):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.config, self.traffic = spec.config, spec.traffic
        self.model = self.config["model"]
        self.stamps, self.losses = [], []
        self.window_end = None
        self.tr = None
        self.pool = self.pooled = self.tables = self.density = None
        self.readings = self.loss_positions = None
        self.pool_detail = {}
        self.setup_parts = {}       # host seconds of set-up's parts

    # -- the program --------------------------------------------------------

    def data_fn(self, step):
        return self.pool[step % len(self.pool)]

    def on_step(self, step, loss):
        now = time.perf_counter()
        self.stamps.append(now)
        self.losses.append(loss)
        if self.window_end is not None and now >= self.window_end:
            raise WindowClosed

    def steps(self, n):
        self.tr.train(n, ckpt_every=0, log_every=10 ** 12, log=_quiet)

    def setup(self):
        """Everything before the window. Reads the program's checked steps
        into `self.readings`."""
        from repro_torch.distributed.chaos import ChaosMonkey
        from repro_torch.distributed.fault import DivergenceSentinel
        from repro_torch.launch.train import Trainer
        t = self.traffic
        mark = time.perf_counter()
        self.pool = self.spec.generator().make_pool(t, self.model, self.seed)
        self.setup_parts["pool_s"] = time.perf_counter() - mark
        self.loss_positions = sum(map(loss_count, self.pool)) / len(self.pool)
        describe = getattr(self.spec.generator(), "describe", None)
        self.pool_detail = describe(self.pool) if describe else {}
        mark = time.perf_counter()
        params = nested(make_params(self.model, self.seed, self.device))
        self.tr = Trainer(model_config(self.config), seq_len=t["seq_len"],
                          batch=t["batch"], lr=t["lr"],
                          total_steps=t["total_steps"],
                          steps_per_epoch=t["steps_per_epoch"],
                          data_fn=self.data_fn, chaos=ChaosMonkey(),
                          step_callback=self.on_step, params=params,
                          sentinel=DivergenceSentinel(spike=False),
                          device=self.device, seed=self.seed)
        del params
        sync(self.device)
        self.setup_parts["trainer_s"] = time.perf_counter() - mark
        self.readings = self.checked_steps()
        sync(self.device)

    def make_plan(self):
        """The program's capture and flood fill, as its epoch boundary runs
        them, on the batch of the last dense step."""
        tr = self.tr
        mark = time.perf_counter()
        batch = tr._device_batch(self.data_fn(capture_index(self.traffic)))
        pooled, _ = tr.capture(batch)
        self.pooled = pooled.float().cpu().numpy()
        self.setup_parts["capture_s"] = time.perf_counter() - mark
        tr.spion_state = tr.spion_ctl.generate(tr.spion_state, self.pooled)
        self.setup_parts["flood_fill_s"] = \
            time.perf_counter() - mark - self.setup_parts["capture_s"]
        self.density = tr.spion_state.density
        self.tables = tr.spion_state.table_arrays()
        self.tables["block"] = int(tr.spion_state.tables["block"])

    def checked_steps(self):
        tr, out = self.tr, {"grad": {}}
        checked = self.traffic["checked_steps"]
        for i, phase in enumerate(step_phases(self.traffic)):
            if phase == "sparse" and self.tables is None:
                self.make_plan()
            first = i < checked and phase not in out["grad"]
            before = None
            if first and int(tr.opt["count"]) > 0:
                before = {n: m.clone() for n, m in tr.opt["mu"].items()}
            self.steps(1)
            if first:
                # the clipped gradient the optimizer got, from its moment
                out["grad"][phase] = leaf_norms({
                    n: (m if before is None else m - B1 * before[n]) / (1 - B1)
                    for n, m in tr.opt["mu"].items()})
                del before
            if i + 1 == checked:
                init = make_params(self.model, self.seed, self.device)
                out["update"] = leaf_norms({
                    n: p.detach() - init[n]
                    for n, p in tr.params.named_parameters()})
                del init
        out["losses"] = self.losses[:checked]
        out["pooled"], out["tables"] = self.pooled, self.tables
        return out

    # -- the windows --------------------------------------------------------

    def _run_window(self, seconds):
        sync(self.device)
        self.stamps, self.losses = [], []
        t0 = time.perf_counter()
        self.window_end = t0 + seconds
        try:
            with torch.profiler.record_function(WINDOW):
                self.steps(10 ** 12)
        except WindowClosed:
            pass
        self.window_end = None
        sync(self.device)
        return t0

    def window(self, seconds):
        """The measured window: {t0, stamps, losses, peak_bytes,
        setup_peak_bytes (set-up's, before the window), launches (the
        program's counts of each kernel's launches in it)}."""
        from repro_torch.kernels import block_sparse_attn as bsa
        from bench.metrics.yardstick import KERNELS
        before = {k: getattr(bsa, k).launches for k in KERNELS}
        setup_peak = 0
        if self.device.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = self._run_window(seconds)
        peak = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        return {"t0": t0, "stamps": list(self.stamps),
                "losses": list(self.losses), "peak_bytes": int(peak),
                "setup_peak_bytes": int(setup_peak),
                "launches": {k: getattr(bsa, k).launches - before[k]
                             for k in KERNELS}}

    def traced_window(self):
        """The traced window: {t0, stamps, trace}."""
        from torch.profiler import ProfilerActivity, profile, record_function
        tr = self.tr
        inner = tr._next_batch

        def fetch():
            with record_function(FETCH_SPAN):
                return inner()
        tr._next_batch = fetch
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            with profile(activities=acts) as prof:
                t0 = self._run_window(self.traffic["trace_seconds"])
        finally:
            del tr._next_batch
        events = prof.profiler.kineto_results.events()
        return {"t0": t0, "stamps": list(self.stamps),
                "trace": Trace(events)}

    def free(self):
        """Drop the program's state, so the reference has the card."""
        self.tr = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def check(self):
        """{number: value}: the program's readings against the float32
        reference's (reference/follow.py), which works the plan's tables
        out again from the program's pooled map."""
        from bench.reference.follow import follow
        ref = follow(self.config, self.traffic, self.seed, self.pool,
                     self.device, pooled_of=self.pooled)
        return compare(self.readings, ref)
