"""The one generator of traffic: it reads a mix's parameters
(`traffic/<mix>.json`) and makes the requests of one run from `--seed`.

Parameters of a mix:

- `arrivals`: "closed" (the caller sends the next batch when the last has
  returned) or "poisson" (open loop: each request is sent when it is due,
  whatever the load);
- closed: `batch` rows a batch and `pool_batches` distinct batches made at
  set-up and sent in turn;
- poisson: `rate_per_s` requests a second and `burst_size` (default 1):
  groups of that many requests share one arrival time, the groups arriving
  as a Poisson process of `rate_per_s / burst_size`;
- `durations`: each clip's length, {"kind": "fixed", "seconds": s} or
  {"kind": "lognormal", "median_s", "sigma", "min_s", "max_s"};
- `new_tokens`: the tokens each request asks for;
- `source_seconds`: the length of the seeded speech the clips are cut from
  (default 120).

Every seed gets the same set of clip lengths and inter-arrival gaps (the
distributions' quantiles, `audio.quantiles`), each in its own seeded
order: a seed changes the order and the audio, never the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import audio


def generate(mix: dict, seed: int, seconds: float, window_samples: int,
             device=None) -> dict:
    """closed: {"batches": [(batch, window) float32], "durations": [(batch,)]};
    poisson: {"offsets": (n,) seconds after the window opens at which each
    request is due (the first after one gap), "durations": (n,), "clips": [float32 arrays]}.
    The audio is made on `device` (the CPU by default) and handed over in
    host arrays."""
    source = audio.speech_like(seed, float(mix.get("source_seconds", 120)), device)
    if mix["arrivals"] == "closed":
        b = int(mix["batch"])
        lengths = audio.quantiles(mix["durations"], b)
        batches, durations = [], []
        for k in range(int(mix["pool_batches"])):
            d = audio.permuted(lengths, seed, 100 + k)
            batches.append(audio.cut(source, d, window_samples, seed, 200 + k).cpu().numpy())
            durations.append(d)
        return {"batches": batches, "durations": durations}
    if mix["arrivals"] == "poisson":
        rate = float(mix["rate_per_s"])
        burst = int(mix.get("burst_size", 1))
        groups = max(1, int(round(rate * seconds / burst)))
        gaps = audio.permuted(audio.exponential_gaps(rate / burst, groups), seed, 300)
        gaps *= seconds / (gaps.sum() + burst / rate)    # the last group due inside
        offsets = np.repeat(np.cumsum(gaps), burst)
        durations = audio.permuted(audio.quantiles(mix["durations"], len(offsets)), seed, 301)
        width = int(round(durations.max() * audio.SR))
        rows = audio.cut(source, durations, width, seed, 302)
        lengths = np.round(durations * audio.SR).astype(np.int64)
        keep = torch.arange(width, device=rows.device)[None, :] < \
            torch.from_numpy(lengths).to(rows.device)[:, None]
        flat = rows[keep].cpu().numpy()              # clip after clip
        return {"offsets": offsets, "durations": durations,
                "clips": np.split(flat, np.cumsum(lengths)[:-1])}
    raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
