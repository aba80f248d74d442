"""The Swin tower's least time a step by the card's peaks, forward and
backward, over the device time of the operations attributed to the tower
(launched inside its forward span, or by a backward node answering an
operation of that span)."""

from portbench import readers

UNIT = "%"
LAYER = "Swin kernels (ops/swin_block.py, ops/window_attn.py, ops/mlp.py, ops/gemm.py over csrc/)"
MOVES = "clips_per_s"


def read(r):
    return readers.roofline(r, "train", "swin")
