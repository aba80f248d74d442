"""Host milliseconds a train step inside the program's ``backward`` span
(``loss.backward()`` in ``AgentBase._train_step``: the autograd engine's
enqueue of every backward operation): the median over steps run with the
program's tracer on and no profiler."""

from portbench import spans

UNIT = "ms"
LAYER = "backward (train/agent.py AgentBase._train_step)"
MOVES = "clips_per_s"


def read(r):
    return spans.host_ms(r, "train", "backward")
