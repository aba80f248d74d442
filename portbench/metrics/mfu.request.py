"""Model flops of the window's requests (forward, from the configuration's
shapes) over the requests' summed latency times the card's bf16 peak."""

from portbench import readers

UNIT = "%"
LAYER = "whole step"
MOVES = "request_p95_ms"


def read(r):
    return readers.mfu(r, "request")
