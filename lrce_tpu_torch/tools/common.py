"""What the tools share: the flagship model and trainer as the JAX package's
tools build them, their synthetic batches, and timing that waits for the
card.

A tool runs on the card unless its caller asks for the CPU, and raises
where there is no card (``utils/device.resolve_device``). ``model_cfg``
replaces the flagship configuration (a small model for the CPU tests).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from lrce_tpu_torch.models.e2e import E2EConfig, LRCEModel

# Swin-B + BERT-base + the 12-layer fusion, the open-ended head over 1000
# classes, one temporal scale of 3 clips, 32 tokens (bench.py's model)
FLAGSHIP = E2EConfig(num_classes=1000, temporal_scale=(3,), text_seq_len=32)
PLAIN_HELP = ("run every Swin block on the plain PyTorch route instead of "
              "the CUDA kernels (the JAX package's LRCE_TPU_DISABLE_PALLAS)")


def flagship(device: torch.device, model_cfg: Optional[E2EConfig] = None, *,
             plain: bool = False, seed: int = 0) -> LRCEModel:
    """The model of ``model_cfg`` (default FLAGSHIP) on ``device``, random
    weights from ``seed``: f32 parameters, bf16 compute on the card and f32
    on the CPU; ``plain``: the Swin tower on its plain route."""
    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = LRCEModel(model_cfg or FLAGSHIP, device=device,
                      dtype=torch.float32, compute_dtype=compute,
                      generator=torch.Generator().manual_seed(seed))
    model.video_extractor.swin.use_kernels = not plain
    return model


def agent_args(dataset: str, batch: int, reg: float = 0.0
               ) -> argparse.Namespace:
    """The trainer's namespace of the JAX package's benches (cosine
    schedule, lr 5e-5 for the three groups)."""
    return argparse.Namespace(
        dataset=dataset, log_dir=os.path.join("runs", dataset),
        ckpt_interval=100, batch_size=batch, eval_per_epoch=1, epoch=1,
        drop_out_rate=0.1, lr=[5e-5] * 3, min_lr=1e-8,
        temporal_scale=[3], lr_decay_factor=0.5, lr_warm_up=0.1,
        lr_restart_epoch=2, lr_restart_mul=1, use_cosine_scheduler=True,
        reg_strength=reg, num_workers=0, use_hinge_loss=False,
        debug_mode=True, sanity_check=False)


def bench_inputs(batch: int, cfg: E2EConfig, device: torch.device,
                 seed: int = 1):
    """bench.py's request: uniform f32 clips in [0, 1) of (batch, clips, 5,
    224, 224, 3) from ``seed``, token ids and mask of ones, type ids of
    zeros."""
    n_clips = sum(cfg.temporal_scale)
    gen = torch.Generator().manual_seed(seed)
    clips = torch.rand((batch, n_clips, cfg.frame_sample_size, 224, 224, 3),
                       generator=gen)
    ids = torch.ones((batch, cfg.text_seq_len), dtype=torch.int64)
    types = torch.zeros((batch, cfg.text_seq_len), dtype=torch.int64)
    return tuple(t.to(device) for t in (clips, ids, ids.clone(), types))


def host_batch(batch: int, cfg: E2EConfig):
    """The JAX benches' train batch from ``RandomState(0)``: uint8 clips,
    token ids below the vocabulary's size, masks of ones, type ids of
    zeros, labels below the class count (the same draws as the JAX tools'
    at the flagship's 30522 words and 1000 classes)."""
    rng = np.random.RandomState(0)
    n_clips = sum(cfg.temporal_scale)
    s = cfg.text_seq_len
    return (
        rng.randint(0, 256, (batch, n_clips, cfg.frame_sample_size, 224, 224,
                             3)).astype(np.uint8),
        rng.randint(0, cfg.bert.vocab_size, (batch, s)).astype(np.int64),
        np.ones((batch, s), np.int64),
        np.zeros((batch, s), np.int64),
        rng.randint(0, cfg.num_classes, (batch,)).astype(np.int64),
    )


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn: Callable, device: torch.device):
    """(fn()'s result, host seconds from a synchronised start to a
    synchronised end)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def time_ms(fn: Callable, device: torch.device, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def count_flops(fn: Callable, module: torch.nn.Module) -> int:
    """FLOPs of ``fn()`` by ``torch.utils.flop_counter.FlopCounterMode``,
    with ``module``'s parameters out of autograd meanwhile (its module
    tracker cannot hook a parameter passed to a submodule under
    ``torch.no_grad``)."""
    from torch.utils.flop_counter import FlopCounterMode

    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        for p in params:
            p.requires_grad_(True)
    return counter.get_total_flops()


@contextlib.contextmanager
def bert_vocab(path: str) -> Iterator[None]:
    """LRCE_TPU_BERT_VOCAB set to ``path`` inside the block (the tokenizer
    reads it at call time), restored after."""
    old = os.environ.get("LRCE_TPU_BERT_VOCAB")
    os.environ["LRCE_TPU_BERT_VOCAB"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("LRCE_TPU_BERT_VOCAB", None)
        else:
            os.environ["LRCE_TPU_BERT_VOCAB"] = old
