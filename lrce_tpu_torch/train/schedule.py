"""Learning-rate schedules, counterpart of ``lrce_tpu/train/schedule.py``
(pure Python, reimplemented here so the port imports no JAX).

``cosine_warmup_restarts_lr`` follows the external
``pytorch-cosine-annealing-with-warmup`` package in fractional-epoch units,
with its quirks kept: every param group gets the SAME lr (the package
overwrites all group lrs), the per-cycle peak decays by gamma**cycle, the
warmup is linear from min_lr, and for cycle_mult != 1 the cycle length is
first_cycle_steps * cycle_mult**n with the warmup not subtracted.
``ReduceLROnPlateau`` has torch's semantics (relative threshold 1e-4).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def cosine_warmup_restarts_lr(t: float, first_cycle_steps: float,
                              cycle_mult: float, base_max_lr: float,
                              min_lr: float, warmup_steps: float,
                              gamma: float) -> float:
    """LR at fractional epoch t >= 0."""
    cycle, step_in_cycle, cur_cycle_steps = 0, t, first_cycle_steps
    if t >= first_cycle_steps:
        if cycle_mult == 1.0:
            cycle = int(t // first_cycle_steps)
            step_in_cycle = t % first_cycle_steps
        else:
            cycle = int(math.log(t / first_cycle_steps * (cycle_mult - 1) + 1,
                                 cycle_mult))
            step_in_cycle = t - first_cycle_steps * (
                cycle_mult ** cycle - 1) / (cycle_mult - 1)
            cur_cycle_steps = first_cycle_steps * cycle_mult ** cycle
    max_lr = base_max_lr * (gamma ** cycle)
    if step_in_cycle < warmup_steps:
        return (max_lr - min_lr) * step_in_cycle / warmup_steps + min_lr
    return min_lr + (max_lr - min_lr) * (
        1 + math.cos(math.pi * (step_in_cycle - warmup_steps)
                     / (cur_cycle_steps - warmup_steps))) / 2


class CosineWarmupRestarts:
    """``step(epoch + i / len(dl))`` -> the same lr for every group."""

    def __init__(self, num_groups: int, first_cycle_steps: float,
                 cycle_mult: float = 1.0, max_lr: float = 0.1,
                 min_lr: float = 0.001, warmup_steps: float = 0.0,
                 gamma: float = 1.0):
        self.num_groups = num_groups
        self.args = (first_cycle_steps, cycle_mult, max_lr, min_lr,
                     warmup_steps, gamma)
        self.lrs: List[float] = [min_lr] * num_groups

    def step(self, t: float) -> List[float]:
        self.lrs = [cosine_warmup_restarts_lr(t, *self.args)] * self.num_groups
        return self.lrs

    def state_dict(self) -> dict:
        return {"lrs": list(self.lrs)}

    def load_state_dict(self, state: dict) -> None:
        self.lrs = list(state["lrs"])


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics over a list of
    per-group lrs."""

    def __init__(self, initial_lrs: Sequence[float], mode: str = "max",
                 factor: float = 0.5, patience: int = 10,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        self.lrs = list(initial_lrs)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        up = 1.0 + self.threshold
        down = 1.0 - self.threshold
        if self.mode == "max":
            return metric > self.best * (up if self.best >= 0 else down)
        return metric < self.best * (down if self.best >= 0 else up)

    def step(self, metric: float) -> List[float]:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lrs = [max(lr * self.factor, self.min_lr) for lr in self.lrs]
            self.num_bad = 0
        return self.lrs

    def state_dict(self) -> dict:
        return {"lrs": list(self.lrs), "best": self.best,
                "num_bad": self.num_bad}

    def load_state_dict(self, state: dict) -> None:
        self.lrs = list(state["lrs"])
        self.best = state["best"]
        self.num_bad = state["num_bad"]
