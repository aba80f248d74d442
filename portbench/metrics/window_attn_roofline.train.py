"""The Swin tower's window attention in a training step: its least time by
the card's peaks (``attn_trace.bound_s``: the operations and bytes of the
q k^T and P v products and the bias, forward and backward, a window x head
pair at a time, from the configuration's shapes, which the program's
``attn.window_heads*`` counters are held to) over the device time of the
window-attention kernels (``window_attn_ms.train``), in percent."""

from portbench import attn_trace, readers

UNIT = "%"
LAYER = "Swin kernels (ops/swin_block.py, ops/window_attn.py, ops/mlp.py, ops/gemm.py over csrc/)"
MOVES = "clips_per_s"


def read(r):
    pk = readers.card_peaks(r)
    if r["mode"] != "train" or pk is None:
        return None
    ms = attn_trace.device_ms(r)
    if ms is None or ms <= 0:
        return None
    spec = r["spec"]
    clips = spec.traffic["questions"] * sum(spec.config["temporal_scale"])
    return 100.0 * attn_trace.bound_s(spec.config, clips, pk) / (ms * 1e-3)
