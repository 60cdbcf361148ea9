"""encode_ms.batch: Frontend and encoder time a batch: the `preprocess` and `encode` spans' device time (CUDA events,
closed by a synchronise) over the window's batches."""

from benchlib import readers

LAYER = "encoder"
UNIT = "ms"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    return readers.encode_ms(r)
