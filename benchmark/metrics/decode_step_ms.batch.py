"""decode_step_ms.batch: Time a decode step: the `greedy_decode` span (cross-KV precompute, prefill and the step loop)
over the steps it ran."""

from benchlib import readers

LAYER = "decode loop"
UNIT = "ms"
MOVES = "rtfx"


def read(r: readers.Readings) -> float | None:
    return readers.decode_step_ms(r)
