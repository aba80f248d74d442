"""What the per-layer metrics share: the card's peaks and the work of a
step or a request, counted from the configuration's shapes
(``counts/<config>.py``). Each reader returns None where it finds nothing
to read: a run without a device trace, or a card without a peak in
``peaks.py``."""

from __future__ import annotations

from typing import Optional

import torch

from portbench.peaks import peaks


def card_peaks(r: dict) -> Optional[dict]:
    if r["device"].type != "cuda":
        return None
    return peaks(torch.cuda.get_device_name(r["device"]))


def pieces(r: dict, one_rank: bool = False):
    """The pieces of a step of every rank, or of one rank's share (what
    rank 0's trace holds); of one request."""
    spec = r["spec"]
    train = r["mode"] == "train"
    q = (spec.traffic["questions"] if one_rank or not train
         else r["questions_per_step"])
    return spec.registry.counts(spec.config["name"]).pieces(spec.config, q,
                                                            train)


def mfu(r: dict, mode: str) -> Optional[float]:
    """Model flops of the work completed over the window's seconds times
    the chips' peak, in percent."""
    pk = card_peaks(r)
    if r["mode"] != mode or pk is None:
        return None
    flops = sum(p.flops for p in pieces(r))
    win = r["window"]
    if mode == "train":
        done, seconds = win["steps"] * flops, win["seconds"]
    else:
        done = len(win["latency_s"]) * flops
        seconds = sum(win["latency_s"])
    return 100.0 * done / (seconds * pk["bf16_flops"] * r["chips"])


def roofline(r: dict, mode: str, part: str) -> Optional[float]:
    """The part's least time on one card by its peaks (the sum over its
    pieces of the larger of flops over the peak rate and bytes over the peak
    bandwidth) over the device time of the operations attributed to it in
    rank 0's trace, in percent."""
    pk, tr = card_peaks(r), r["trace"]
    if r["mode"] != mode or pk is None or tr is None:
        return None
    device_s = tr["part_s"].get(part, 0.0) / tr["units"]
    if device_s <= 0:
        return None
    bound = sum(max(p.flops / pk["bf16_flops"], p.bytes / pk["hbm_bytes"])
                for p in pieces(r, one_rank=True) if p.part == part)
    return 100.0 * bound / device_s


def traced(r: dict, mode: str) -> Optional[dict]:
    """The trace summary of a run of this mode with device operations."""
    tr = r["trace"]
    if r["mode"] != mode or tr is None or tr["launches"] == 0:
        return None
    return tr
