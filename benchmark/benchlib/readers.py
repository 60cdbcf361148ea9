"""The arithmetic behind the per-layer metrics' readers (`metrics/*.py`).

Each reader takes a `Readings` (the spans, the reduced device trace, the
entry's outcome, the configuration, the card's peaks) and returns a number
or None; None leaves the metric out of the line. A share of a peak is never
clipped: a reading above 100% means the count or the time is wrong.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchlib import flops


@dataclass
class Readings:
    config: dict
    spans: object          # SpanRecorder
    trace: dict | None     # trace.reduce_events' result
    trace_window: tuple | None   # (host start, host end) of the traced window
    outcome: object        # Outcome
    peak: dict

    @property
    def model(self) -> dict:
        return self.config["model"]


def encode_seconds(r: Readings) -> tuple[float, float, int] | None:
    """(frontend + encoder seconds, rows, calls) over the window's calls."""
    enc, pre = r.spans.of("encode"), r.spans.of("preprocess")
    if not enc or len(pre) != len(enc):
        return None
    return (sum(s.device_s for s in enc) + sum(s.device_s for s in pre),
            sum(s.rows for s in enc), len(enc))


def encode_ms(r: Readings) -> float | None:
    got = encode_seconds(r)
    return None if got is None else 1e3 * got[0] / got[2]


def encode_roofline(r: Readings) -> float | None:
    got = encode_seconds(r)
    if got is None:
        return None
    least = got[1] * flops.encoder_flops(r.model) / r.peak["bf16_flops"]
    return 100.0 * least / got[0]


def decode_step_ms(r: Readings) -> float | None:
    spans = r.spans.of("greedy_decode")
    steps = sum(s.info.get("steps", 0) for s in spans)
    if not spans or not steps:
        return None
    return 1e3 * sum(s.device_s for s in spans) / steps


def decode_roofline(r: Readings) -> float | None:
    spans = r.spans.of("greedy_decode")
    if not spans:
        return None
    prog = r.config["program"]
    wb = {"int8": 1.0}.get(prog["quantize"], 2.0)
    kv = 1.0 if prog["decode"]["kv_int8"] else 2.0
    ckv = 1.0 if prog["decode"]["cross_kv_int8"] else 2.0
    prefix = len(r.model["forced_prefix"])
    least = sum(flops.decode_least_seconds(r.model, s.rows, prefix, s.info["steps"],
                                           wb, kv, ckv, r.peak) for s in spans)
    return 100.0 * least / sum(s.device_s for s in spans)


def mfu(r: Readings) -> float | None:
    """Model operations of the requests finished inside the traced window
    over the window and the bf16 peak."""
    if r.trace_window is None or r.trace is None:
        return None
    h0, h1 = r.trace_window
    ops = sum(f for t, f in r.outcome.done if h0 <= t <= h1)
    if not ops:
        return None
    return 100.0 * ops / (h1 - h0) / r.peak["bf16_flops"]


def device_idle(r: Readings) -> float | None:
    """None where the trace holds no device operation (no card traced)."""
    if r.trace is None or r.trace["window_s"] <= 0 or not r.trace["kernels"]:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])


def batch_occupancy(r: Readings) -> float | None:
    occ = r.outcome.counters.get("batch_occupancy")
    return None if occ is None else 100.0 * occ
