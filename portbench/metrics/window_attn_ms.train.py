"""Device milliseconds a training step of the Swin tower's window-attention
kernels: the forward CTAs launched inside the program's stage spans
``swin.s<i>`` and K4's attention CTAs answering them (``attn_trace.py``)."""

from portbench import attn_trace

UNIT = "ms"
LAYER = "Swin kernels (ops/swin_block.py, ops/window_attn.py, ops/mlp.py, ops/gemm.py over csrc/)"
MOVES = "clips_per_s"


def read(r):
    if r["mode"] != "train":
        return None
    return attn_trace.device_ms(r)
