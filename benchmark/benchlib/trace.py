"""The device trace of a `--trace 1` run, reduced to what the result line holds.

`DeviceTrace` runs `torch.profiler` over the traced window with CUDA
activity only (kernels, copies and sets as CUPTI records them), so the
host, which sets the pace of the decode loop, is not slowed by a record of
every host operation. It reduces the events to:

- `busy_s`: the union of the intervals in which a kernel, copy or set ran on
  the device, inside the window (not the sum of their durations: overlapping
  work counts once);
- `window_s`: the traced window's length;
- `device_ops`: the ten device operations that took most time, by name;
- `idle_gaps`: the device's idle time by what the host was doing, as the
  benchmark's spans (`spans.py`) say: each gap between busy intervals is
  charged to the innermost span open on the host when the gap ended (the
  launch of the work that ended it), or to "outside spans"; the ten largest
  totals.

Host and device times are both on the profiler's clock, which is the
host's `time.time_ns()`. Without a card nothing is traced: the window's
bounds alone, so that no device operation and no idle share is read.
"""


from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


class DeviceTrace:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.h0 = self.h1 = 0.0      # the same bounds on the host's perf_counter

    def start(self) -> None:
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        self.t0_ns = time.time_ns()
        self.h0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.h1 = time.perf_counter()
        if self.prof is not None:
            self.prof.stop()

    @property
    def active(self) -> bool:
        return bool(self.t0_ns) and not self.t1_ns

    def reduce(self, spans: list) -> dict:
        """spans: (start ns, end ns, name) on the host."""
        events = self.prof.profiler.kineto_results.events() if self.prof is not None else []
        return reduce_events(events, self.t0_ns, self.t1_ns, spans)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted, merged copy of (start, end) intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(starts: list[int], items: list[tuple[int, int, str]], t: int,
               look: int = 64) -> str | None:
    """The name of the latest-starting item (start, end, name) that covers t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        s, e, n = items[j]
        if e >= t:
            return n
    return None


def reduce_events(events, t0_ns: int, t1_ns: int, spans: list) -> dict:
    kernels = []                       # (start, end, name)
    for e in events:
        if not _is_device(e) or e.is_user_annotation() or "Sync" in e.name():
            continue                   # host work, a host range mirrored, a wait
        s = e.start_ns()
        end = s + e.duration_ns()
        if end > t0_ns and s < t1_ns:
            kernels.append((max(s, t0_ns), min(end, t1_ns), e.name()))
    window_s = (t1_ns - t0_ns) / 1e9
    busy = merge([(a, b) for a, b, _ in kernels])
    busy_s = sum(b - a for a, b in busy) / 1e9

    by_op: dict[str, float] = defaultdict(float)
    for a, b, name in kernels:
        by_op[name[:160]] += (b - a) / 1e9

    spans = sorted(spans)
    starts = [x[0] for x in spans]
    gaps: dict[str, float] = defaultdict(float)
    edges = [t0_ns] + [x for ab in busy for x in ab] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = _innermost(starts, spans, b) or "outside spans"
            if b == t1_ns:
                label = f"{label} (to the window's end)"
            gaps[label] += (b - a) / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy_s, "window_s": window_s, "device_ops": top(by_op),
            "idle_gaps": top(gaps), "kernels": len(kernels)}
