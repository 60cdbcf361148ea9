"""Spans around the program's layers, recorded from the benchmark's side.

`SpanRecorder.wrap(obj, attr, name)` replaces a function that the entry
looks up at call time (a module attribute) by one that records a span
around it: a CUDA event before the call and one after it, on the calling
thread's stream, and the host's clock at the call and at its return. It
does not wait for the device, so the traced path keeps the overlap of the
next call's host work with this call's device work. The events are read
once the window has closed (`close`, after the device has finished): the
device time between them is the span's time, the device's work and any
time it waited on the host in between. Used only in `--trace 1` runs. A
span that never fires leaves its metric absent; nothing is estimated.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass
class Span:
    name: str
    ns0: int             # time.time_ns() (the profiler's clock) at the call
    ns1: int             # and at its return
    device_s: float | None   # between the CUDA events, once read (host time off the card)
    rows: int
    info: dict = field(default_factory=dict)
    events: tuple | None = None


class SpanRecorder:
    def __init__(self):
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._restore: list[tuple[Any, str, Any]] = []

    def wrap(self, obj: Any, attr: str, name: str,
             rows: Callable[[tuple, dict], int],
             info: Callable[[tuple, dict, Any], dict] | None = None) -> None:
        fn = getattr(obj, attr)
        rec = self

        def spanned(*args, **kwargs):
            dev = _device_of(args)
            cuda = dev is not None and dev.type == "cuda"
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            ns0 = time.time_ns()
            out = fn(*args, **kwargs)
            if cuda:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
            ns1 = time.time_ns()
            extra = info(args, kwargs, out) if info else {}
            span = Span(name, ns0, ns1, None if cuda else (ns1 - ns0) / 1e9,
                        rows(args, kwargs), extra, (e0, e1) if cuda else None)
            with rec._lock:
                rec.spans.append(span)
            return out

        setattr(obj, attr, spanned)
        self._restore.append((obj, attr, fn))

    def close(self) -> None:
        """Put every wrapped function back and read the spans' events (the
        caller has waited for the device)."""
        while self._restore:
            obj, attr, fn = self._restore.pop()
            setattr(obj, attr, fn)
        with self._lock:
            for s in self.spans:
                if s.events is not None and s.device_s is None:
                    e0, e1 = s.events
                    e1.synchronize()
                    s.device_s = e0.elapsed_time(e1) / 1e3
                    s.events = None

    def ranges(self) -> list[tuple[int, int, str]]:
        """(start ns, end ns, name) of every span, for the trace's idle gaps."""
        with self._lock:
            return [(s.ns0, s.ns1, s.name) for s in self.spans]

    def of(self, name: str) -> list[Span]:
        """The spans of `name` whose device time has been read."""
        with self._lock:
            return [s for s in self.spans if s.name == name and s.device_s is not None]


def _device_of(args: tuple):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None
