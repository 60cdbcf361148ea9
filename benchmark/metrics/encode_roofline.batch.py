"""encode_roofline.batch: The encoder's least time (its operations over the bf16 peak, `benchlib.flops.encoder_flops`)
over its measured time (`preprocess` and `encode` spans)."""

from benchlib import readers

LAYER = "encoder"
UNIT = "%"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    return readers.encode_roofline(r)
