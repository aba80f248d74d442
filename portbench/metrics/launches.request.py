"""Device operations (kernels, copies, sets) a request in the traced
sub-window."""

from portbench import readers

UNIT = "launches/req"
LAYER = "host: the PyTorch ops between kernels (ops/nn.py, the models' Python, train/agent.py)"
MOVES = "request_p95_ms"


def read(r):
    tr = readers.traced(r, "request")
    if tr is None:
        return None
    return tr["launches"] / tr["units"]
