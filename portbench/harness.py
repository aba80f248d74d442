"""One run of one cell: the ranks, the comparison with the reference, the
metrics the benchmark assigns the cell, and the result line.

A cell of one rank runs in this process. A cell of several ranks starts one
process per card (spawned, joined over ``tcp://127.0.0.1`` with NCCL on the
card and gloo on the CPU); each rank returns what it measured, and this
process, once every rank has ended, runs the reference and prints. Each
rank also returns the forbidden modules that its process holds once its
window has closed, since the program runs there and not in this process;
a run in which any process holds one prints no result.
"""

from __future__ import annotations

import json
import pickle
import socket
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from portbench import check
from portbench.registry import ROOT, Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "lrce_tpu")
RANK_TIMEOUT_S = 1500


class Spec(NamedTuple):
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    registry: Registry
    benchmark: dict
    fault: Optional[str] = None     # a planted fault (the benchmark's tests)


def load_benchmark(root: Path) -> dict:
    path = Path(root).parent / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def make_spec(name: str, seed: int, seconds: float, trace: bool,
              root: Path = ROOT, benchmark: Optional[dict] = None,
              fault: Optional[str] = None) -> Spec:
    reg = Registry(root)
    cell = reg.workload(name)
    return Spec(cell, reg.config(cell["config"]), reg.traffic(cell["traffic"]),
                seed, seconds, trace, reg,
                load_benchmark(root) if benchmark is None else benchmark,
                fault)


def assigned(spec: Spec):
    """(end-to-end entries, per-layer entries) of BENCHMARK.json that this
    cell reports."""
    name = spec.cell["name"]

    def mine(entry):
        return name in entry.get("workloads", [name])

    e2e = [m for m in spec.benchmark["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per = [m for m in spec.benchmark["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device_type: str, fn,
               args: tuple, queue) -> None:
    """One spawned rank: join the group, run ``fn`` and send its result to
    the parent as pickled bytes (a tensor passed as itself would be shared
    through a handle that dies with this process)."""
    from portbench import program

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    device = program.PM.init_distributed(
        device_type, rank=rank, world_size=world, local_rank=rank,
        init_method=f"tcp://127.0.0.1:{port}",
        backend="nccl" if device_type == "cuda" else "gloo")
    try:
        queue.put((rank, None, pickle.dumps(fn(device, rank, world, *args))))
    except BaseException as e:   # noqa: BLE001 - reported by the parent
        queue.put((rank, f"{type(e).__name__}: {e}", None))
        raise
    finally:
        torch.distributed.destroy_process_group()


def spawn(world: int, device_type: str, fn, args: tuple) -> list:
    """``fn(device, rank, world, *args)`` on ``world`` spawned processes,
    one per card, joined in one process group (NCCL on the card, gloo on
    the CPU); the results by rank. ``fn`` must be importable."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device_type, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    outs = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(outs) < world:    # drain before joining
            rank, error, out = queue.get(
                timeout=max(1.0, deadline - time.monotonic()))
            if error is not None:
                raise RuntimeError(f"rank {rank}: {error}")
            outs[rank] = pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [outs[r] for r in range(world)]


def _cell_rank(device, rank: int, world: int, *spec_args) -> dict:
    spec = make_spec(*spec_args)
    out = spec.registry.mode(spec.cell["mode"]).run_rank(spec, device, rank,
                                                        world)
    return {**out, "forbidden": forbidden_modules()}


def run_ranks(spec: Spec, device: torch.device, root: Path) -> List[dict]:
    world = spec.cell["ranks"]
    if world == 1:
        return [spec.registry.mode(spec.cell["mode"]).run_rank(spec, device,
                                                               0, 1)]
    return spawn(world, device.type, _cell_rank,
                 (spec.cell["name"], spec.seed, spec.seconds, spec.trace,
                  root, spec.benchmark, spec.fault))


def run(spec: Spec, device: torch.device, t0: float,
        root: Path = ROOT) -> dict:
    """The result line of one run; ``t0`` is the process's start on the
    wall clock (``time.time``)."""
    outs = run_ranks(spec, device, root)
    mode = spec.registry.mode(spec.cell["mode"])
    e2e_values, readings, numbers, attempted, failed = mode.finish(
        spec, outs, device, t0)
    for where, found in [("the process that prints the result",
                          forbidden_modules())] + [
            (f"rank {r}", o.get("forbidden", [])) for r, o in enumerate(outs)]:
        if found:
            raise SystemExit(f"the run loaded {found} in {where}")
    checks = check.judge(numbers, spec.cell["limits"])
    e2e, per = assigned(spec)
    metrics: Dict[str, Any] = {}
    if spec.trace:
        for m in per:
            value = spec.registry.metric(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in e2e_values:
                metrics[m["name"]] = {"value": e2e_values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec.cell["ranks"],
           "memory_peak_bytes": max(o["peak_bytes"] for o in outs)}
    line: Dict[str, Any] = {"correct": check.passed(checks) and failed == 0,
                            "attempted": attempted, "failed": failed,
                            "metrics": metrics, "device": dev}
    summary = outs[0].get("trace")
    if spec.trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = checks
    return line


def emit(line: dict) -> None:
    sys.stdout.flush()
    check.print_checks(line["checks"])
    print(json.dumps(line), flush=True)

