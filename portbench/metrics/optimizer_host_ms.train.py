"""Host milliseconds a train step inside the program's ``optimizer`` spans
(``zero_grad``, ``set_lrs`` and AdamW's step in
``AgentBase._train_step``): the median over steps run with the program's
tracer on and no profiler."""

from portbench import spans

UNIT = "ms"
LAYER = "optimizer (train/optimizer.py, train/agent.py AgentBase._train_step)"
MOVES = "clips_per_s"


def read(r):
    return spans.host_ms(r, "train", "optimizer")
