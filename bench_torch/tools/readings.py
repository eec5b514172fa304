"""The readings a cell's limits are set from, on the card, in one process:
the program's sound runs over many seeds, the control (the program in the
configuration's lower precision) and planted faults over a few.

    python3 bench_torch/tools/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --faults half_batch,state_unchanged --fault-seeds 3 \
        --seconds 3 [--first-seed N]

Each run prints one JSON line: its kind, seed, ``correct`` under the
cell's present limits, and every reading (compared or not).  The last
line holds, for each reading, the largest sound value and the smallest
control and fault values.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None):
    from bench_torch.lib.harness import require_cards, run_cell
    from bench_torch.lib.spec import load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    device = require_cards(cell.chips)
    runs = [("sound", None, None, a.first_seed + i) for i in range(a.seeds)]
    runs += [("control", cell.config["lower_precision"], None, a.first_seed + 1000 + i)
             for i in range(a.control_seeds)]
    for f in filter(None, a.faults.split(",")):
        runs += [(f, None, f, a.first_seed + 2000 + i) for i in range(a.fault_seeds)]
    summary = {}
    for kind, precision, fault, seed in runs:
        r = run_cell(a.workload, seed, a.seconds, False, device, precision=precision, fault=fault)
        readings = {k: c["value"] for k, c in r["checks"].items()}
        readings.update({k[len("reading_"):]: v for k, v in r["notes"].items()
                         if k.startswith("reading_")})
        print(json.dumps({"kind": kind, "seed": seed, "correct": r["correct"],
                          "failed": r["failed"], "readings": readings,
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()}}),
              flush=True)
        for k, v in readings.items():
            s = summary.setdefault(k, {})
            pick = max if kind == "sound" else min
            s[kind] = v if kind not in s else pick(s[kind], v)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
