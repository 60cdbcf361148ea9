"""What an entry module hands back from its measured window."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Served:
    """One finished request the check may take: its waveform (unpadded, as
    sent) and the tokens the program served after the forced prefix."""
    wav: np.ndarray
    tokens: list[int]


@dataclass
class Outcome:
    attempted: int = 0
    failed: int = 0
    e2e: dict = field(default_factory=dict)         # end-to-end values by name
    served: list[Served] = field(default_factory=list)
    short: int = 0                 # finished requests with fewer tokens than asked
    done: list[tuple[float, float]] = field(default_factory=list)  # (host time, model flops)
    counters: dict = field(default_factory=dict)    # program counters read over the window
    notes: list[str] = field(default_factory=list)  # lines for standard error
    latencies: list[float] = field(default_factory=list)  # seconds, in the order requests were due
