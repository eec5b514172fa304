"""The port's benchmark: run one cell once and print its result line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, configurations and metrics
are named in BENCHMARK.json and live in files under bench_torch/ (see
bench_torch/README.md).  Without the CUDA cards a cell asks for, it exits
with a non-zero code and prints no result.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from bench_torch.lib.harness import main

    sys.exit(main(parse()))
