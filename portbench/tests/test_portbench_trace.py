"""The reduction of a device trace: busy time as a union, device time by
model part forward and backward (through the profiler's sequence numbers),
NCCL apart, and idle time by the host span that launched the operation
ending each gap."""

import pytest
import torch

from portbench import trace

MAIN, BWD = 1, 2


class Ev:
    def __init__(self, kind, name, start, dur, corr=0, seq=-1, thread=MAIN,
                 fwd_thread=0):
        self.kind, self._name, self.start, self.dur = kind, name, start, dur
        self.corr, self.seq, self.thread = corr, seq, thread
        self.fwd_thread = fwd_thread

    def activity_type(self):
        return self.kind

    def device_type(self):
        gpu = self.kind in ("kernel", "gpu_memcpy", "gpu_memset",
                            "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if gpu \
            else torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def sequence_nr(self):
        return self.seq

    def start_thread_id(self):
        return self.thread

    def fwd_thread_id(self):
        return self.fwd_thread


class OlderEv(Ev):
    """An event of a profiler whose events carry no activity type."""

    activity_type = property()


def make_events(cls):
    def span(name, s, d, thread=MAIN):
        return cls("user_annotation", trace.PREFIX + name, s, d,
                   thread=thread)

    def launch(corr, t, thread=MAIN):
        return cls("cuda_runtime", "cudaLaunchKernel", t, 1, corr=corr,
                   thread=thread)

    def kernel(name, corr, s, d):
        return cls("kernel", name, s, d, corr=corr)

    return [
        span("window", 0, 1000),
        span("dispatch", 0, 600),
        cls("gpu_user_annotation", trace.PREFIX + "dispatch", 0, 600),
        span("swin", 10, 100),
        cls("cpu_op", "aten::mm", 20, 10, seq=7),
        launch(1, 25),
        span("bert", 200, 50),
        launch(2, 210),
        cls("cpu_op", trace.BACKWARD + ": MmBackward0", 300, 100, seq=7,
            thread=BWD, fwd_thread=MAIN),
        launch(3, 310, thread=BWD),
        launch(4, 350, thread=BWD),          # NCCL inside swin's backward
        launch(5, 500),                       # the optimizer, no part
        span("read", 700, 200),
        launch(6, 800),
        kernel("k_swin", 1, 100, 50),
        kernel("k_bert", 2, 150, 50),         # back to back with k_swin
        kernel("k_swin_bwd", 3, 400, 100),
        kernel("ncclAllReduce", 4, 450, 100),  # overlaps k_swin_bwd
        kernel("adam", 5, 600, 20),
        kernel("copy", 6, 900, 10),
        kernel("unlaunched", 99, 910, 10),   # takes the part before it
    ]


@pytest.mark.parametrize("cls", [Ev, OlderEv])
def test_parts_busy_idle_and_nccl(cls):
    s = trace.reduce(make_events(cls), units=2,
                     parts=["swin", "bert", "fusion"])
    ns = 1e-9
    assert s["window_s"] == 1000 * ns
    assert s["busy_s"] == (100 + 150 + 20 + 20) * ns
    assert s["launches"] == 7 and s["unlaunched"] == 1
    assert abs(s["part_s"]["swin"] - 150 * ns) < 1e-15
    assert abs(s["part_s"]["bert"] - 50 * ns) < 1e-15
    assert abs(s["nccl_s"] - 100 * ns) < 1e-15
    idle = dict(s["idle_gaps"])
    assert abs(idle["swin"] - 100 * ns) < 1e-15
    assert abs(idle["swin.backward"] - 200 * ns) < 1e-15
    assert abs(idle["dispatch"] - 50 * ns) < 1e-15
    assert abs(idle["read"] - 280 * ns) < 1e-15
    assert abs(idle["window end"] - 80 * ns) < 1e-15
    assert s["device_ops"][0][0] in ("k_swin_bwd", "ncclAllReduce")
