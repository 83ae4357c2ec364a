"""Run one cell of the port's GPU benchmark once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It draws the weights and the traffic from the seed, warms the cell's
shapes up, measures for `--seconds`, checks the window's outputs against
the plain reference in gpubench/reference/, and prints one JSON line last
on standard output (the numbers compared, with their limits, last on
standard error too). With --trace 1 the line holds the cell's per-layer
metrics, read from a device trace of part of the window, instead of its
end-to-end metrics.
"""

import time

T_PROCESS = time.monotonic()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.apply_env()

    cell = common.load_json("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from gpubench.harness import run_cell

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_process=T_PROCESS)
    found = common.forbidden_loaded()
    if found:
        print(f"JAX or the JAX package loaded in this process: {found[:10]}", file=sys.stderr)
        return 3
    for name, value, limit in out["checks"]:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(out["line"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
