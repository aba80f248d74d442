"""Rank programs that drive the agent under a layout and report what every
rank saw, for the tests (gloo on the CPU) and ``chip_smoke.py`` (the
card). They live in the package so that ``parallel/mesh.spawn`` can start
them in fresh processes that import nothing else.

    report = spawn(agent_run, 2, (cfg, state, batches, fsdp, model, args,
                                  plan), device="cpu", threads=1)
    reports = spawn(agent_runs, 2, (cfg, state, batches, [(1, 1), (2, 1)],
                                    args, plan), device="cpu", threads=1)
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from lrce_tpu_torch.parallel import mesh as PM


def _numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def build_agent(device: torch.device, cfg, state: Dict[str, np.ndarray],
                fsdp: int, model_axis: int, args, seed: int = 0,
                is_eval: bool = False, log_enabled: bool = False):
    """An agent of ``cfg``'s task with the weights ``state`` (a whole state
    dict) on this rank's part of the (fsdp, model_axis) mesh."""
    from lrce_tpu_torch.models.e2e import LRCEModel
    from lrce_tpu_torch.train.agent import agent_factory

    layout = PM.make_layout(fsdp, model_axis, device.type)
    model = LRCEModel(cfg, device=device)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return agent_factory(cfg.task_type)(
        model, args, log_enabled=log_enabled, is_eval=is_eval, seed=seed,
        layout=layout)


def rank_batch(batch: Sequence[np.ndarray], layout) -> list:
    """This rank's part of a global batch (the DataLoader's split)."""
    return [np.split(np.asarray(b), layout.n_batch)[layout.batch_rank]
            for b in batch]


def _whole(agent) -> dict:
    """The agent's whole state dict and optimizer state as numpy (every
    rank must call it: it gathers the shards)."""
    model_state, opt = agent._whole_state(only_model=False)
    return {"state": _numpy(model_state),
            "optimizer": {i: {k: (v.detach().cpu().numpy()
                                  if torch.is_tensor(v) else v)
                              for k, v in s.items()}
                          for i, s in opt["state"].items()}}


def agent_run(device: torch.device, cfg, state, batches, fsdp: int,
              model_axis: int, args, plan: Sequence[tuple],
              seed: int = 0) -> dict:
    """Follow ``plan`` on this rank: ("train", i) / ("eval", i) a step on
    this rank's part of global batch i, ("save", path, only_model) /
    ("load", path, only_model) a checkpoint, ("l2",) the regularizer's
    value, ("snapshot",) the whole state at this point, ("fresh",) a new
    agent from ``state`` (a second run in the same ranks), ("eager",) the
    fusion's training call run eagerly from here on, ("graphs",) the
    fusion's graph counts (``utils/graphs.GraphCache``). Returns (on rank
    0) every rank's step results and l2 values, in rank order, the
    snapshots, and the whole state dict and optimizer state after the
    plan."""
    agent = build_agent(device, cfg, state, fsdp, model_axis, args, seed)
    layout = agent.layout
    seen, snapshots = [], []
    for op in plan:
        if op[0] in ("train", "eval"):
            seen.append(agent.step(*rank_batch(batches[op[1]], layout),
                                   is_train=op[0] == "train"))
        elif op[0] == "save":
            agent.args.ckpt_dir = op[1]
            agent.log_enabled = True
            agent.save_checkpoint(0, "ckpt", only_model=op[2])
            agent.finish_pending_checkpoint()
            agent.log_enabled = False
            dist.barrier()
        elif op[0] == "load":
            agent.load_checkpoint(op[1], only_model=op[2])
        elif op[0] == "l2":
            from lrce_tpu_torch.utils.pytree import l2_reg

            with torch.no_grad():
                seen.append(float(l2_reg(agent.reg_groups,
                                         agent.reg_split)))
        elif op[0] == "snapshot":
            snapshots.append(_whole(agent))
        elif op[0] == "fresh":
            agent = build_agent(device, cfg, state, fsdp, model_axis, args,
                                seed)
        elif op[0] == "eager":
            from lrce_tpu_torch.utils.graphs import GraphCache

            agent.model.fusion_model.graphs = GraphCache("fusion")
        elif op[0] == "graphs":
            g = agent.model.fusion_model.graphs
            seen.append((g.eager, g.captures, g.replays, g.backward_replays))
        else:
            raise ValueError(op)
    every = [None] * PM.world_size()
    dist.all_gather_object(every, seen)
    last = _whole(agent)
    lrs = list(agent.lrs)
    if PM.global_rank() != 0:
        return None
    return {"seen": every, **last, "snapshots": snapshots, "lrs": lrs,
            "net": type(agent.net).__name__,
            "layout": SimpleNamespace(n_batch=layout.n_batch,
                                      n_model=layout.n_model,
                                      n_fsdp=layout.n_fsdp)}


def agent_runs(device: torch.device, cfg, state, batches, layouts, args,
               plan: Sequence[tuple], seed: int = 0) -> list:
    """``agent_run`` once for each (fsdp, model_axis) of ``layouts``, in
    the same ranks, each from ``state``; rank 0's reports in that order."""
    return [agent_run(device, cfg, state, batches, fsdp, model_axis, args,
                      plan, seed) for fsdp, model_axis in layouts]


def plateau_run(device: torch.device, cfg, state, batch, args,
                validations: int = 3) -> dict:
    """Data-parallel validations on one global batch whose first half the
    model answers right and whose second half wrong (the labels are made
    from the model's own predictions), so that the ranks' local accuracies
    differ (1 and 0 at two ranks). Returns (on rank 0) every rank's local
    accuracy and, after each validation, its global metric and learning
    rates."""
    from collections import deque

    agent = build_agent(device, cfg, state, 1, 1, args)
    layout = agent.layout
    with torch.no_grad():
        logits = agent.model(*[torch.as_tensor(np.asarray(b), device=device)
                               for b in batch[:4]])
    pred = logits.argmax(1).cpu().numpy()
    n = len(pred)
    gt = np.where(np.arange(n) < n // 2, pred, (pred + 1) % logits.shape[1])
    local = rank_batch(list(batch[:4]) + [gt], layout)
    with torch.no_grad():
        m0, m1 = agent._metric_pair(
            agent.model(*[torch.as_tensor(b, device=device)
                          for b in local[:4]]),
            torch.as_tensor(local[4], device=device))
    seen = {"local_accuracy": float(m0 / m1), "after": []}
    for k in range(validations):
        deque(agent.process_data([local], False, k), maxlen=0)
        seen["after"].append((agent.last_metric_val, list(agent.lrs)))
    every = [None] * PM.world_size()
    dist.all_gather_object(every, seen)
    return every if PM.global_rank() == 0 else None
