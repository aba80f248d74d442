"""Readings that the limits of a cell are set from (``PERF.md``): the
numbers compared, for sound runs of the program over many seeds, for the
control (the reference computed with float8 operands in the program's
place) and for planted faults, at the cell's own sizes.

    python3 portbench/calibrate.py --workload msvd-train \
        --seeds 11 12 13 --control 11 12 13 --faults half_batch

Each reading is one JSON line on standard output. The model is built once;
each seed loads its own weights into it and gets a fresh agent. Only cells
of one rank are calibrated here.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.reference import lrce as R  # noqa: E402


def _emit(kind, seed, numbers, t):
    print(json.dumps({"kind": kind, "seed": seed, **numbers,
                      "seconds": time.perf_counter() - t}), flush=True)


def first_steps(spec, runs, device, rank, world):
    """This rank's first steps for each (seed, fault) of ``runs``, on one
    model and one DDP mesh; the parameter shapes and the readings."""
    mode = spec.registry.mode("train")
    net, shapes, _ = mode.build(spec, device)
    place = mode.layout(world, device)
    out = {}
    for seed, fault in runs:
        s = spec._replace(seed=seed, fault=fault)
        agent, batches = mode.make_agent(s, net, shapes, device, rank, place)
        out[(seed, fault)] = mode.first_steps(s, agent, net, shapes, batches,
                                              device)
        del agent, batches
        gc.collect()
    del net
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return shapes, out


def _rank_first_steps(device, rank, world, name, root, runs):
    spec = harness.make_spec(name, 0, 0.0, False, root)
    return first_steps(spec, runs, device, rank, world)


def ranks_first_steps(spec, runs, device):
    """(shapes, {(seed, fault): [rank 0's readings, rank 1's, ...]})."""
    world = spec.cell["ranks"]
    if world == 1:
        outs = [first_steps(spec, runs, device, 0, 1)]
    else:
        outs = harness.spawn(world, device.type, _rank_first_steps,
                             (spec.cell["name"], spec.registry.root, runs))
    return outs[0][0], {k: [o[1][k] for o in outs] for k in outs[0][1]}


def train_readings(spec, seeds, control, faults, device):
    mode = spec.registry.mode("train")
    runs = [(s, None) for s in seeds] + [(s, f) for f in faults
                                          for s in control]
    shapes, ranks_first = ranks_first_steps(spec, runs, device)
    refs = {}

    def ref(seed, fp8=False):
        key = (seed, fp8)
        if key not in refs:
            refs[key] = mode.reference_steps(spec._replace(seed=seed), shapes,
                                             device, R.Numerics(fp8=fp8))
        return refs[key]

    def program_numbers(seed, fault=None):
        firsts = ranks_first[(seed, fault)]
        prog = {"losses": firsts[0]["losses"],
                "logits": [[f["logits"][i].to(device) for f in firsts]
                           for i in range(mode.CHECK_STEPS)],
                "grad_norms": [f["grad_norms"] for f in firsts],
                "change_norms": [f["change_norms"] for f in firsts]}
        return check.training_numbers(prog, ref(seed))

    def as_program(steps):
        return {"losses": steps.losses, "logits": steps.logits,
                "grad_norms": [steps.grad_norms],
                "change_norms": [steps.change_norms]}

    for seed in seeds:
        t = time.perf_counter()
        _emit("program", seed, program_numbers(seed), t)
    for seed in control:
        t = time.perf_counter()
        _emit("control", seed,
              check.training_numbers(as_program(ref(seed, True)), ref(seed)),
              t)
        refs.pop((seed, True))
    for fault in faults:
        for seed in control:
            t = time.perf_counter()
            _emit(fault, seed, program_numbers(seed, fault), t)


def request_readings(spec, seeds, control, faults, device, count):
    mode = spec.registry.mode("request")
    from portbench import inputs, program

    net = program.model(spec.config, device)
    shapes = [(k, tuple(v.shape)) for k, v in net.named_parameters()]

    def served(seed, fault=None):
        s = spec._replace(seed=seed, fault=fault)
        net.load_state_dict(inputs.make_weights(shapes, seed, device))
        f = mode.feed(s, device)
        for _ in range(mode.WARMUP):
            f.next()
        return mode.loop(program, net, f, device, fault,
                          lambda n, _s: n >= count, False)["answers"]

    def gap(answers, ref):
        return {"logits_gap": max(check.rel_l2(a, r) for a, r in
                                  zip(torch.cat(answers).to(device), ref))}

    refs = {}
    for seed in sorted(set(seeds) | set(control)):
        refs[seed] = mode.reference_logits(spec._replace(seed=seed), shapes,
                                           device, count, R.Numerics())
    for seed in seeds:
        t = time.perf_counter()
        _emit("program", seed, gap(served(seed), refs[seed]), t)
    for seed in control:
        t = time.perf_counter()
        fp8 = mode.reference_logits(spec._replace(seed=seed), shapes, device,
                                    count, R.Numerics(fp8=True))
        _emit("control", seed, gap([fp8], refs[seed]), t)
    for fault in faults:
        for seed in control:
            t = time.perf_counter()
            _emit(fault, seed, gap(served(seed, fault), refs[seed]), t)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--requests", type=int, default=300,
                   help="requests a seed in a request cell")
    a = p.parse_args(argv)
    spec = harness.make_spec(a.workload, 0, 0.0, False)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if spec.cell["mode"] == "train":
        train_readings(spec, a.seeds, a.control, a.faults, device)
    else:
        request_readings(spec, a.seeds, a.control, a.faults, device,
                         a.requests)
    return 0


if __name__ == "__main__":
    sys.exit(main())
