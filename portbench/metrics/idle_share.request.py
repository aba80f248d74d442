"""The share of the traced sub-window in which no operation ran on the
device: 1 - (union of the device's busy intervals) / the sub-window."""

from portbench import readers

UNIT = "%"
LAYER = "device"
MOVES = "request_p95_ms"


def read(r):
    tr = readers.traced(r, "request")
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
