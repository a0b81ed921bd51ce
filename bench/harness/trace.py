"""The traced window's reduction: torch.profiler's raw events (CPU and CUDA
activities) to device busy time, kernel time and launches by name, span
time by name, and the breakdown (the device operations that took most
time, the longest idle gaps of the device labelled by what the host was
doing then)."""
from __future__ import annotations

from collections import defaultdict

WINDOW = "bench.window"          # the span around the traced window


def union(intervals):
    """(total length of the union of (start, end) intervals, the gaps
    between the merged intervals as (start, end))."""
    total, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


class Trace:
    """The events of one traced window, on the profiler's clock (ns); the
    span `WINDOW` gives its start and end.

    device: (name, start, end) of every operation that ran on the card
    (kernels, copies, sets; the mirrored user annotations left out);
    host: (name, start, end) of every CPU event (operators, runtime calls
    and the benchmark's spans), on every thread."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        self.device, self.host = [], []
        for e in events:
            s = e.start_ns()
            t = s + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.device.append((e.name(), s, t))
            else:
                self.host.append((e.name(), s, t))
        spans = [(s, t) for n, s, t in self.host if n == WINDOW]
        if len(spans) != 1:
            raise ValueError(f"the trace holds {len(spans)} '{WINDOW}' "
                             "spans, not one")
        self.t0, self.t1 = spans[0]
        self.inside = [(n, max(s, self.t0), min(t, self.t1))
                       for n, s, t in self.device
                       if t > self.t0 and s < self.t1]
        busy, gaps = union([(s, t) for _, s, t in self.inside])
        self.busy_s = busy / 1e9
        self.window_s = (self.t1 - self.t0) / 1e9
        if self.inside:
            first = min(s for _, s, _ in self.inside)
            last = max(t for _, _, t in self.inside)
            self.gaps = [(self.t0, first)] + gaps + [(last, self.t1)]
        else:
            self.gaps = [(self.t0, self.t1)]

    def kernels(self, part):
        """(device seconds, launches) of the operations in the window whose
        name holds `part`."""
        hits = [(s, t) for n, s, t in self.inside if part in n]
        return sum(t - s for s, t in hits) / 1e9, len(hits)

    def span_s(self, name):
        """Host seconds inside the spans called `name` in the window, and
        their count."""
        hits = [t - s for n, s, t in self.host
                if n == name and self.t0 <= s <= self.t1]
        return sum(hits) / 1e9, len(hits)

    def host_at(self, when):
        """The innermost host event that covers the time `when`."""
        best = None
        for n, s, t in self.host:
            if n != WINDOW and s <= when <= t and \
                    (best is None or t - s < best[1]):
                best = (n, t - s)
        return "host idle" if best is None else best[0]

    def breakdown(self, top=10):
        ops = defaultdict(int)
        for n, s, t in self.inside:
            ops[n[:160]] += t - s
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted((g for g in self.gaps if g[1] > g[0]),
                         key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in device_ops],
                "idle_gaps": [[self.host_at((s + t) // 2)[:160],
                               (t - s) / 1e9] for s, t in longest]}
