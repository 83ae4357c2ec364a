"""Readings that set a cell's rate and limits; not run by the benchmark.

    python3 gpubench/calibrate.py control <cell> <seconds> <seed> [<seed> ...]
    python3 gpubench/calibrate.py sweep <cell> <seconds> <rate> [<rate> ...]

`control`: for each seed, a run of the cell (a window of `seconds` at the
cell's own load) and, over the same sampled requests, the widest gap of the
served tokens under the float32 reference ("gap", the number the runs
compare) beside the widest gap of the tokens that the fp8 reference puts
first ("control_gap"), in one process. `sweep`: the serve cell's traffic
at each rate on one model, with its latency percentiles and how the
admission queue moved over the window (no reference check). Each prints one
JSON line per seed or rate.
"""

import sys
import time
from pathlib import Path

T_PROCESS = time.monotonic()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import json  # noqa: E402

from gpubench import common  # noqa: E402


def control(cell: str, seconds: float, seeds) -> None:
    from gpubench.harness import run_cell

    for seed in seeds:
        t = time.monotonic()
        out = run_cell(cell, int(seed), seconds, False, control=True, t_process=t)
        print(json.dumps({"cell": cell, "seed": int(seed), **out["readings"],
                          "correct": out["correct"],
                          "metrics": {k: v for k, (v, _) in out["metrics"].items()},
                          "seconds": time.monotonic() - t}), flush=True)


def sweep(cell_name: str, seconds: float, rates) -> None:
    import torch

    from gpubench.harness import Run, build_model, load_cell

    cell, cfg = load_cell(cell_name)
    model = build_model(cfg, 1, torch.device("cuda"), cfg["dtype"])
    driver = common.load_module("drivers", cell["driver"])
    for i, rate in enumerate(rates):
        # traffic of a seed of its own per entry; the weights of seed 1
        run = Run({**cell, "rate_per_s": float(rate)}, cfg, 1 + i, seconds, False, model,
                  torch.device("cuda"), time.monotonic(), sys.stderr)
        res = driver.run(run)
        win = sorted(res["requests"], key=lambda q: q["due"])
        lat = common.request_latencies(win)
        third = max(1, len(win) // 3)
        head, tail = (common.request_latencies(win[:third]), common.request_latencies(win[-third:]))
        row = {"cell": cell_name, "rate": float(rate), "seed": 1 + i, "requests": len(win),
               "failed": res["failed"]}
        for key in ("ttft", "tpot", "latency"):
            if lat[key]:
                for q in (50, 90, 95):
                    row[f"{key}_p{q}_ms"] = common.percentile(lat[key], q) * 1e3
        row["tpot_mean_ms"] = common.mean_tpot(win) * 1e3
        row["ttft_p50_first_third_ms"] = common.percentile(head["ttft"], 50) * 1e3
        row["ttft_p50_last_third_ms"] = common.percentile(tail["ttft"], 50) * 1e3
        row["ttft_s"] = [round(x, 4) for x in lat["ttft"]]
        row["tpot_s"] = [round(x, 5) for x in lat["tpot"]]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    common.apply_env()
    mode, name, secs, *rest = sys.argv[1:]
    (control if mode == "control" else sweep)(name, float(secs), rest)
