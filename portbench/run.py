"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a profiled sub-window
after the measured one. The last line of standard output is the result
(one JSON object); the numbers compared with the reference, each with its
limit, are the last lines of standard error and the line's last key. The
run needs as many CUDA cards as the cell asks for, and exits with an error
and no result where they are not there.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = harness.make_spec(a.workload, a.seed, a.seconds, bool(a.trace))
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {a.workload} needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    harness.emit(harness.run(spec, torch.device("cuda", 0), T0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
