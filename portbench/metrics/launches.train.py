"""Device operations (kernels, copies, sets) a step in the traced
sub-window."""

from portbench import readers

UNIT = "launches/step"
LAYER = "host: the PyTorch ops between kernels (ops/nn.py, the models' Python, train/agent.py)"
MOVES = "clips_per_s"


def read(r):
    tr = readers.traced(r, "train")
    if tr is None:
        return None
    return tr["launches"] / tr["units"]
