"""decode_roofline.batch: The decode's least time (per step the larger of bytes over the memory bandwidth and operations
over the peak, `benchlib.flops.decode_least_seconds`) over the `greedy_decode` span."""

from benchlib import readers

LAYER = "decode loop"
UNIT = "%"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    return readers.decode_roofline(r)
