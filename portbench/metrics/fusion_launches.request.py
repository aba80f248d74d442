"""Device operations a request launched inside the program's ``fusion``
span (its embedding, the three clips of the recurrence and the head), from
a profiled sub-window with the program's tracer on."""

from portbench import spans

UNIT = "launches/req"
LAYER = "text tower and fusion (models/bert.py, models/embedding.py, models/fusion.py)"
MOVES = "request_p95_ms"


def read(r):
    return spans.launches(r, "request", "fusion")
