"""Host milliseconds a request inside the program's ``fusion`` span
(``models/e2e.py`` ``e2e_apply``, around ``fusion_model``): the median over
requests run with the program's tracer on and no profiler."""

from portbench import spans

UNIT = "ms"
LAYER = "text tower and fusion (models/bert.py, models/embedding.py, models/fusion.py)"
MOVES = "request_p95_ms"


def read(r):
    return spans.host_ms(r, "request", "fusion")
