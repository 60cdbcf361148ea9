"""batch_occupancy.serve: The service's mean batch occupancy over the window (requests a batch over its largest batch):
the change in `ServiceStats.occupancy_sum` over the change in `ServiceStats.batches`."""

from benchlib import readers

LAYER = "service"
UNIT = "%"
MOVES = "latency_p95_ms"


def read(r: readers.Readings) -> float | None:
    return readers.batch_occupancy(r)
