"""decode_step_ms.serve: Time a decode step on the service's worker thread: the `greedy_decode` span over its steps."""

from benchlib import readers

LAYER = "decode loop"
UNIT = "ms"
MOVES = "latency_p95_ms"


def read(r: readers.Readings) -> float | None:
    return readers.decode_step_ms(r)
