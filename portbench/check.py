"""The comparisons that decide ``correct``, and the numbers they print.

Each number compared has a limit of its own, in the cell's file (limits are
set from readings of sound runs and of the control, ``PERF.md``). A number
passes when it is at most its limit; a number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, List, Mapping

import torch

# leaves whose reference gradient is under this share of the median leaf's
# move by rounding alone (a key's bias under softmax) and are left out
TINY_GRADIENT = 1e-3


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64; infinite for different shapes."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-300))


def counted_leaves(ref_grad: Mapping[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= TINY_GRADIENT * med]


def worst_leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                   leaves: Iterable[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    leaves = list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-300)
               for k in leaves)


def training_numbers(prog: dict, ref) -> Dict[str, float]:
    """prog: losses, logits (per step, per rank), grad_norms, change_norms
    (per rank); ref: ``reference.train.Steps``."""
    leaves = counted_leaves(ref.grad_norms)
    return {
        "loss_gap": max(abs(p - r) for p, r in zip(prog["losses"],
                                                   ref.losses)),
        "logits_gap": max(rel_l2(p, r)
                          for ps, rs in zip(prog["logits"], ref.logits)
                          for p, r in zip(ps, rs)),
        "grad_gap": max(worst_leaf_gap(g, ref.grad_norms, leaves)
                        for g in prog["grad_norms"]),
        "change_gap": max(worst_leaf_gap(c, ref.change_norms, leaves)
                          for c in prog["change_norms"]),
    }


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Dict[str, dict]:
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items()}


def passed(checks: Mapping[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def print_checks(checks: Mapping[str, dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for k, c in checks.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr, flush=True)
