"""mfu.serve: Model operations of the requests answered inside the traced window, over that window and the
bf16 peak."""

from benchlib import readers

LAYER = "model step"
UNIT = "%"
MOVES = "latency_p95_ms"


def read(r: readers.Readings) -> float | None:
    return readers.mfu(r)
