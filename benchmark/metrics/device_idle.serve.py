"""device_idle.serve: The share of the traced window in which no kernel, copy or set ran on the device."""

from benchlib import readers

LAYER = "device"
UNIT = "%"
MOVES = "latency_p95_ms"


def read(r: readers.Readings) -> float | None:
    return readers.device_idle(r)
