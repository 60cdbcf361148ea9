"""Seeded speech-like audio and the seeded sets that traffic draws from.

`speech_like` makes a long 16 kHz signal with the structure of speech: a
voiced source (a drifting pitch of 90-260 Hz and its first 12 harmonics,
shaped by three slowly moving formant-like resonances), a syllable
envelope near 4 Hz with pauses between words, and noise bursts for
fricatives. `cut` takes clips out of it at seeded offsets and gains. Both
run with torch on the device the traffic is made on (the card in a run),
in a few whole-signal passes from `torch.Generator`s seeded by `--seed`,
so set-up does not wait on the host for minutes of audio. Clips lie on the
16-bit PCM grid.

`quantiles` gives every seed the same set of sizes (the distribution's
quantiles at (i + 0.5) / n), which `permuted` puts into a seeded order: the
amount of work does not depend on the seed, only its order and content do.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

SR = 16000


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for `stream` of `seed`."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), int(seed) >> 63, stream])


def torch_gen_of(seed: int, stream: int, device) -> torch.Generator:
    """An independent torch generator on `device` for `stream` of `seed`."""
    state = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), int(seed) >> 63, stream])
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1, np.uint64)[0]))


def _smooth(gen, n: int, step: int, lo: float, hi: float) -> torch.Tensor:
    """A random curve in [lo, hi] (float64) through a knot every `step` samples."""
    knots = lo + (hi - lo) * torch.rand(n // step + 2, generator=gen, device=gen.device,
                                        dtype=torch.float64)
    pos = torch.arange(n, device=gen.device, dtype=torch.float64) / step
    j = pos.floor().long()
    frac = pos - j
    return knots[j] * (1.0 - frac) + knots[j + 1] * frac


def speech_like(seed: int, seconds: float, device=None) -> torch.Tensor:
    """`seconds` of seeded speech-like audio, float32 on `device` (the CPU by default)."""
    gen = torch_gen_of(seed, 1, torch.device(device or "cpu"))
    n = int(seconds * SR)
    f0 = _smooth(gen, n, SR // 5, 90.0, 260.0)
    phase = torch.remainder(2 * math.pi * torch.cumsum(f0, 0) / SR, 2 * math.pi)
    formants = [_smooth(gen, n, SR // 8, lo, hi)
                for lo, hi in ((300, 900), (900, 2400), (2400, 3400))]
    voiced = torch.zeros_like(f0)
    for k in range(1, 13):
        fk = k * f0
        gain = sum(1.0 / (1.0 + ((fk - fm) / 120.0) ** 2) for fm in formants)
        voiced += gain / k * torch.sin(k * phase)
    syll = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.cumsum(
        _smooth(gen, n, SR // 2, 2.5, 6.0), 0) / SR)
    words = _moving_mean((_smooth(gen, n, SR // 3, -1.0, 1.0) > -0.55).double(), 400)
    noise = torch.randn(2, n, generator=gen, device=gen.device, dtype=torch.float64)
    fric = (_smooth(gen, n, SR // 10, 0.0, 1.0) > 0.8) * noise[0] * 0.3
    x = (voiced * syll + fric) * words + 0.003 * noise[1]
    return (0.5 * x / x.abs().max()).float()


def _moving_mean(x: torch.Tensor, width: int) -> torch.Tensor:
    """The mean of `width` samples centred on each (zeros past the ends), as
    np.convolve(x, ones(width) / width, mode="same") gives it."""
    n = len(x)
    c = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
    i = torch.arange(n, device=x.device) + (width - 1) // 2
    return (c[(i + 1).clamp(0, n)] - c[(i + 1 - width).clamp(0, n)]) / width


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n durations in seconds: {"kind": "fixed", "seconds": s} or
    {"kind": "lognormal", "median_s", "sigma", "min_s", "max_s"}."""
    if spec["kind"] == "fixed":
        return np.full(n, float(spec["seconds"]))
    if spec["kind"] == "lognormal":
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        d = np.exp(math.log(spec["median_s"]) + spec["sigma"] * z)
        return np.clip(d, spec["min_s"], spec["max_s"])
    raise ValueError(f"unknown duration kind {spec['kind']!r}")


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """n inter-arrival gaps of a Poisson process of `rate` a second: the
    exponential distribution's quantiles."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def permuted(x: np.ndarray, seed: int, stream: int) -> np.ndarray:
    return x[rng_of(seed, stream).permutation(len(x))]


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """x on the grid of 16-bit PCM (k / 32768), as audio arrives: a wire
    that sends int16 then carries it without loss, so the program and the
    reference are given the same samples."""
    return torch.round(x * 32768.0).clamp_(-32768, 32767) / 32768.0


def cut(source: torch.Tensor, seconds: np.ndarray, width: int, seed: int,
        stream: int) -> torch.Tensor:
    """One clip of each length from `source` at seeded offsets, each at a
    seeded gain between 0.5 and 1, on the 16-bit grid: (n, width) float32 on
    the source's device, each row zero past its clip (cut at `width`)."""
    rng = rng_of(seed, stream)
    m = np.round(np.asarray(seconds, np.float64) * SR).astype(np.int64)
    off = rng.integers(0, len(source) - m + 1)
    gain = rng.uniform(0.5, 1.0, size=len(m))
    dev = source.device
    rows = torch.nn.functional.pad(source, (0, width)).unfold(0, width, 1)
    x = rows[torch.from_numpy(off).to(dev)] * torch.from_numpy(gain).float().to(dev)[:, None]
    past = torch.arange(width, device=dev)[None, :] >= torch.from_numpy(m).to(dev)[:, None]
    return pcm16(x).masked_fill_(past, 0.0)
