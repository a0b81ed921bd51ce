"""What a run hands to the metric readers (bench/metrics/<name>.py, each a
`read(run) -> float | None`; None leaves the metric out of the line)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Run:
    """spec: the harness's Spec of the cell; setup_s: host seconds from
    the process's start to the window's; window: {t0, stamps, losses,
    peak_bytes} of the measured window (host clock, seconds; a stamp after
    each step's loss reached the host); traced: {t0, stamps, trace} of
    the traced window (harness/trace.Trace), None in an untraced run;
    tables: the plan's numpy tables with their "block", None in a dense
    cell; loss_positions: the positions a step's loss covers, the mean
    over the pool."""
    spec: object
    setup_s: float
    window: dict
    traced: Optional[dict] = None
    tables: Optional[dict] = None
    loss_positions: Optional[float] = None

    @property
    def model(self):
        return self.spec.config["model"]

    @property
    def traffic(self):
        return self.spec.traffic

    @property
    def positions(self):
        """Sequence positions a step trains."""
        return self.traffic["batch"] * self.traffic["seq_len"]

    @property
    def steps(self):
        return len(self.window["stamps"])

    @property
    def window_s(self):
        return self.window["stamps"][-1] - self.window["t0"]

    def intervals(self):
        """Host seconds between consecutive step stamps, the first from
        the window's start."""
        w = self.window
        return np.diff(np.asarray([w["t0"]] + list(w["stamps"])))

    @property
    def traced_steps(self):
        return len(self.traced["stamps"])
