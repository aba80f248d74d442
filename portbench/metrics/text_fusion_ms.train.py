"""Device milliseconds a step of the operations attributed to the text
tower and the fusion, forward and backward."""

from portbench import readers

UNIT = "ms"
LAYER = "text tower and fusion (models/bert.py, models/embedding.py, models/fusion.py)"
MOVES = "clips_per_s"


def read(r):
    tr = readers.traced(r, "train")
    if tr is None:
        return None
    parts = tr["part_s"]
    return 1e3 * (parts.get("bert", 0.0) + parts.get("fusion", 0.0)) \
        / tr["units"]
