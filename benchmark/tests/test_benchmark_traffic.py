"""The seeded traffic, and the open loop's clock."""

from __future__ import annotations

import math
import os
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from benchlib import audio, traffic  # noqa: E402

WINDOW = 64 * 320
SHORT = {"kind": "lognormal", "median_s": 0.6, "sigma": 0.5, "min_s": 0.2, "max_s": 1.2}
CLOSED = {"arrivals": "closed", "batch": 4, "pool_batches": 3, "source_seconds": 10,
          "durations": SHORT, "new_tokens": 8}
POISSON = {"arrivals": "poisson", "rate_per_s": 30.0, "source_seconds": 10,
           "durations": SHORT, "new_tokens": 8}
BIG = 2 ** 31 + 12345


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


@pytest.mark.parametrize("mix", [CLOSED, POISSON], ids=["closed", "poisson"])
@pytest.mark.parametrize("seed", [7, BIG, 2 ** 40 + 3])
def test_same_seed_same_traffic(mix, seed):
    assert _same(traffic.generate(mix, seed, 2.0, WINDOW), traffic.generate(mix, seed, 2.0, WINDOW))


@pytest.mark.parametrize("mix", [CLOSED, POISSON], ids=["closed", "poisson"])
def test_seeds_change_order_and_audio_not_work(mix):
    a = traffic.generate(mix, 11, 2.0, WINDOW)
    b = traffic.generate(mix, BIG, 2.0, WINDOW)
    da, db = np.concatenate(a["durations"] if mix is CLOSED else [a["durations"]]), \
        np.concatenate(b["durations"] if mix is CLOSED else [b["durations"]])
    assert np.array_equal(np.sort(da), np.sort(db))
    assert not np.array_equal(da, db)
    if mix is POISSON:
        gaps = [np.sort(np.diff(t["offsets"], prepend=0.0)) for t in (a, b)]
        assert np.allclose(*gaps)
        assert not _same(a["clips"], b["clips"])
    else:
        assert not _same(a["batches"], b["batches"])


def test_closed_batches():
    t = traffic.generate(CLOSED, 5, 2.0, WINDOW)
    assert len(t["batches"]) == 3
    for wav, d in zip(t["batches"], t["durations"]):
        assert wav.shape == (4, WINDOW) and wav.dtype == np.float32
        for row, s in zip(wav, d):
            n = int(round(s * audio.SR))
            assert np.all(row[n:] == 0) and np.any(row[:n] != 0)
    # every batch carries the same seconds of audio
    assert len({round(float(d.sum()), 9) for d in t["durations"]}) == 1


@pytest.mark.parametrize("burst", [1, 3])
def test_poisson_schedule(burst):
    mix = dict(POISSON, burst_size=burst)
    seconds = 4.0
    t = traffic.generate(mix, 3, seconds, WINDOW)
    off = t["offsets"]
    assert len(off) == burst * round(30.0 * seconds / burst)
    assert off[0] > 0 and np.all(np.diff(off) >= 0) and off[-1] < seconds
    assert len(t["clips"]) == len(off) == len(t["durations"])
    if burst > 1:
        assert np.all(off.reshape(-1, burst) == off[::burst, None])


def test_clips_on_the_pcm16_grid():
    t = traffic.generate(POISSON, 9, 2.0, WINDOW)
    for c in t["clips"]:
        assert np.array_equal(c * 32768.0, np.round(c * 32768.0))
        assert np.abs(c).max() <= 1.0


def test_quantiles():
    d = audio.quantiles({"kind": "lognormal", "median_s": 5.0, "sigma": 0.5,
                         "min_s": 1.5, "max_s": 12.0}, 1001)
    assert d.min() >= 1.5 and d.max() <= 12.0
    assert math.isclose(float(np.median(d)), 5.0, rel_tol=1e-9)
    assert np.array_equal(audio.quantiles({"kind": "fixed", "seconds": 30.0}, 4), [30.0] * 4)
    with pytest.raises(ValueError):
        audio.quantiles({"kind": "uniform"}, 3)


class _SlowService:
    """A service whose `submit` blocks for `block_s` (a stalled front end)
    and answers at once: the generator falls behind its schedule."""

    def __init__(self, block_s: float, n_new: int):
        self.block_s, self.n_new = block_s, n_new
        self.stats = type("S", (), {"_lock": threading.Lock(), "occupancy_sum": 0.0,
                                    "batches": 0})()

    def submit(self, wav):
        time.sleep(self.block_s)
        f = Future()
        f.set_result({"tokens": [1] * self.n_new})
        return f


def test_open_loop_latency_runs_from_the_due_time(tmp_path):
    """Latency counts the wait a stall imposes on the requests behind it:
    each request is answered the moment it is submitted, but the submits run
    late, so latencies grow along the window."""
    import torch

    from benchlib import tiny
    from benchlib.manifest import Bench
    from benchlib.runner import RunContext

    bench = Bench(tiny.make_bench(str(tmp_path)))
    cell = bench.cell("tiny.serve")
    entry = bench.module("entries", "service")
    ctx = RunContext(cell, 5, 1.0, False, torch.device("cpu"))
    ctx.sample = 0
    n = 20
    ctx.traffic = {"offsets": np.linspace(0.0, 0.2, n), "durations": np.full(n, 0.5),
                   "clips": [np.zeros(8000, np.float32)] * n}
    out = entry.window(ctx, {"service": _SlowService(0.05, ctx.new_tokens)})
    lat = np.asarray(out.latencies)
    assert out.attempted == n and out.failed == 0
    # request i is submitted ~0.05 * (i + 1) s after the window opens but was
    # due at 0.2 * i / (n - 1): its latency is at least the difference
    due = np.linspace(0.0, 0.2, n)
    floor = 0.05 * (np.arange(n) + 1) - due
    assert np.all(lat >= floor - 0.005)
    assert lat[-1] > 0.7
    assert out.e2e["latency_p95_ms"] >= 1e3 * np.sort(floor)[math.ceil(0.95 * n) - 1] - 5
