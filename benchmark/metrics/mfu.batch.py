"""mfu.batch: Model operations of the batches finished inside the traced window, over that window and the
bf16 peak (`benchlib.flops.request_flops`)."""

from benchlib import readers

LAYER = "model step"
UNIT = "%"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    return readers.mfu(r)
