"""device_idle.batch: The share of the traced window in which no kernel, copy or set ran on the device
(torch.profiler; the union of the device's intervals)."""

from benchlib import readers

LAYER = "device"
UNIT = "%"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    return readers.device_idle(r)
