"""Host data loader: sampler parity, batching, threaded prefetch.

The port's own copy of ``lrce_tpu/data/loader.py`` (numpy and threads only),
the same batches in the same order for the same seeds:

  - ``distributed_sampler_indices`` reproduces torch's DistributedSampler
    (pad-to-even by wrapping, stride subsampling, and the epoch-seeded
    ``torch.randperm`` shuffle, including the quirk that ``set_epoch`` is
    never called by the training scripts, so every epoch reuses the epoch-0
    permutation unless an epoch is passed here);
  - ``DataLoader`` assembles global batches: the i-th global batch is the
    concatenation of every emulated rank's i-th per-rank batch, which is
    what a data-parallel world consumes per optimizer step;
  - items are fetched by a thread pool and whole batches are prefetched in
    the background, so decoding overlaps the device's compute.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np
import torch


def distributed_sampler_indices(n: int, num_replicas: int = 1, rank: int = 0,
                                shuffle: bool = True, seed: int = 0,
                                epoch: int = 0) -> np.ndarray:
    """torch.utils.data.DistributedSampler order for one rank.

    Uses torch.randperm on the host for bit-identical shuffling with the
    reference training order.
    """
    num_samples = math.ceil(n / num_replicas)
    total_size = num_samples * num_replicas

    if shuffle:
        g = torch.Generator()
        g.manual_seed(seed + epoch)
        indices = torch.randperm(n, generator=g).tolist()
    else:
        indices = list(range(n))

    pad = total_size - n
    if pad > 0:
        if pad <= n:
            indices += indices[:pad]
        else:
            indices += (indices * math.ceil(pad / n))[:pad]
    return np.asarray(indices[rank:total_size:num_replicas])


def global_batch_indices(n: int, batch_size: int, num_replicas: int = 1,
                         shuffle: bool = True, seed: int = 0,
                         epoch: int = 0) -> List[np.ndarray]:
    """All global batches for one epoch.

    Global batch i = concat over ranks of that rank's i-th per-rank batch
    (DDP-step equivalence). Ragged final batches are kept (drop_last=False).
    """
    per_rank = [distributed_sampler_indices(n, num_replicas, r, shuffle, seed,
                                            epoch)
                for r in range(num_replicas)]
    num_samples = len(per_rank[0])
    batches = []
    for start in range(0, num_samples, batch_size):
        parts = [pr[start:start + batch_size] for pr in per_rank]
        batches.append(np.concatenate(parts))
    return batches


def default_collate(items: Sequence[tuple]) -> tuple:
    """Stack a list of item tuples into a tuple of batched numpy arrays."""
    n_fields = len(items[0])
    return tuple(np.stack([np.asarray(it[f]) for it in items], axis=0)
                 for f in range(n_fields))


class DataLoader:
    """Iterable over prefetched global batches of numpy arrays."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, collate=default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.collate = collate
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch. The training scripts never call
        it; for their training order leave it unused."""
        self.epoch = epoch

    def __len__(self) -> int:
        num_samples = math.ceil(len(self.dataset) / self.num_replicas)
        return math.ceil(num_samples / self.batch_size)

    def __iter__(self) -> Iterator[tuple]:
        batches = global_batch_indices(len(self.dataset), self.batch_size,
                                       self.num_replicas, self.shuffle,
                                       self.seed, self.epoch)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(self.dataset.__getitem__,
                                          [int(i) for i in batch_idx]))
                    out_q.put(self.collate(items))
            out_q.put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
