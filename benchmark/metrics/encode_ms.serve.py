"""encode_ms.serve: Frontend and encoder time a batch on the service's worker thread (the `preprocess` and
`encode` spans)."""

from benchlib import readers

LAYER = "encoder"
UNIT = "ms"
MOVES = "latency_p95_ms"


def read(r: readers.Readings) -> float | None:
    return readers.encode_ms(r)
