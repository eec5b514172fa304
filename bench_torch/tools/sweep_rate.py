"""The one sweep that finds the serving cell's highest sustained rate: the
cell's own set-up and traffic at each offered rate in turn, in one
process, for a short window each.

    python3 bench_torch/tools/sweep_rate.py --workload poseregnet_nyu.serve_open \
        --rates 1000,2000,3000 --seconds 6

A rate is sustained when the backlog does not grow: the median latency of
the window's last fifth of requests is at most 1.5 times that of its first
fifth plus 5 ms, and every request is answered.  Each rate prints one JSON
line; the last line names the highest sustained rate, the knee.  A cell
below the knee writes its own share of it into its file as a number.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=4_000_000_000)
    a = ap.parse_args(argv)
    device = require_cards(load_cell(a.workload).chips)
    knee = None
    for rate in [float(x) for x in a.rates.split(",")]:
        r = run_cell(a.workload, a.seed, a.seconds, False, device,
                     overrides={"rate_per_s": rate, "check_requests": 64})
        n = r["notes"]
        ok = (r["failed"] == 0
              and n["tail_fifth_p50_ms"] <= 1.5 * n["head_fifth_p50_ms"] + 5.0)
        print(json.dumps({"rate_per_s": rate, "sustained": ok, "failed": r["failed"],
                          "serve_p95_ms": r["metrics"]["serve_p95_ms"]["value"], **n}),
              flush=True)
        if ok:
            knee = rate
    print(json.dumps({"knee_per_s": knee}), flush=True)


if __name__ == "__main__":
    main()
