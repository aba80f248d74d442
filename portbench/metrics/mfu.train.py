"""Model flops of the steps completed in the window (forward and backward
from the configuration's shapes, nothing recomputed) over the window's
seconds times the chips' bf16 peak."""

from portbench import readers

UNIT = "%"
LAYER = "whole step"
MOVES = "clips_per_s"


def read(r):
    return readers.mfu(r, "train")
