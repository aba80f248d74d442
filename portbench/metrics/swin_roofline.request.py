"""The Swin tower's least time a request by the card's peaks (forward)
over the device time of the operations launched inside its span."""

from portbench import readers

UNIT = "%"
LAYER = "Swin kernels (ops/swin_block.py, ops/window_attn.py, ops/mlp.py, ops/gemm.py over csrc/)"
MOVES = "request_p95_ms"


def read(r):
    return readers.roofline(r, "request", "swin")
