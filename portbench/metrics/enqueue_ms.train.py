"""The median host milliseconds from a call of the entry point to its
return (before the read of its result), over the measured window."""

UNIT = "ms"
LAYER = "entry (train/agent.py AgentBase.dispatch, models/e2e.py e2e_forward)"
MOVES = "clips_per_s"


def read(r):
    return r["enqueue_ms"] if r["mode"] == "train" else None
