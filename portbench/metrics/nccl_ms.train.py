"""Device milliseconds a step of the NCCL kernels on rank 0 (the
gradient all-reduce and the loss vector's), from the traced sub-window."""

from portbench import readers

UNIT = "ms"
LAYER = "parallel (parallel/mesh.py, parallel/sharding.py)"
MOVES = "clips_per_s"


def read(r):
    tr = readers.traced(r, "train")
    if tr is None or r["chips"] < 2:
        return None
    return 1e3 * tr["nccl_s"] / tr["units"]
