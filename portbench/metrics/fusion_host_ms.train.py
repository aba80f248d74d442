"""Host milliseconds a train step inside the program's ``fusion`` span
(the fusion's forward; its backward runs inside ``backward``): the median
over steps run with the program's tracer on and no profiler."""

from portbench import spans

UNIT = "ms"
LAYER = "text tower and fusion (models/bert.py, models/embedding.py, models/fusion.py)"
MOVES = "clips_per_s"


def read(r):
    return spans.host_ms(r, "train", "fusion")
