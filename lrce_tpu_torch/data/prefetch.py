"""Device prefetch: overlap the host-to-device copy with the card's compute.

Counterpart of ``lrce_tpu/data/prefetch.py``. It wraps a host batch iterator
and keeps ``depth`` batches ahead of the consumer: each batch is staged in
pinned host memory and copied with ``non_blocking=True`` on a side stream;
an event per batch makes the consumer's stream wait for exactly that copy,
and ``record_stream`` tells the allocator that the consumer's stream uses
the tensors. On the CPU it yields the batches as tensors, in order.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def device_prefetch(iterator: Iterable, device=DEFAULT_DEVICE,
                    depth: int = 2) -> Iterator[tuple]:
    """Yield each batch of ``iterator`` (a tuple of numpy arrays or
    tensors) as a tuple of tensors on ``device``, in order, keeping
    ``depth`` batches in flight. The device is the card unless the caller
    asks for the CPU; with no card it raises."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    queue = collections.deque()

    def put(batch):
        host = tuple(torch.as_tensor(np.asarray(b)) if not torch.is_tensor(b)
                     else b for b in batch)
        if not on_card:
            return tuple(t.to(device) for t in host), None
        with torch.cuda.stream(copy_stream):
            out = tuple(t.pin_memory().to(device, non_blocking=True)
                        for t in host)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    it = iter(iterator)
    try:
        for _ in range(depth):
            queue.append(put(next(it)))
    except StopIteration:
        pass

    while queue:
        out, done = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in out:
                t.record_stream(consumer)
        yield out
