"""A CUDA graph capture while a dead graph waits for the cyclic collector.

    python -m deepprior_tpu_torch.prof.prof_graph_gc [--trials 5]

A CUDA graph left in a reference cycle (an estimator and its replay
closures form one) is destroyed only when Python's cyclic collector runs,
at whatever allocation crosses its threshold.  If that happens while
another graph is being captured, the destruction invalidates the capture
(cudaErrorStreamCaptureInvalidated), and torch's ``torch.cuda.graph`` no
longer collects before it captures.  Each trial here leaves a captured
and replayed graph in a cycle and captures a few tensor operations with
the collector's threshold at 1 from the capture's start (so it runs at
the first allocation inside), through ``torch.cuda.graph`` and through
``utils.profiling.graph_capture``, which collects first and holds the
collector off until the capture ends.  Each way runs in a process of its
own, since a failed capture may leave the card's context unusable.
Prints how many trials of each captured, the collector's runs inside the
capture, and the CUDA calls refused there, with the card's name and power
limit.  Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import weakref

import torch

from deepprior_tpu_torch.utils.profiling import card_label, graph_capture, require_cuda


def _work(x):
    return (x * 2.0 + 1.0).sum(dim=1)


class _Holder:
    """A CUDA graph in a reference cycle with itself."""

    def __init__(self, graph):
        self.graph, self.me = graph, self


def capture_with_garbage(capture, device, seen=None) -> str:
    """One capture of ``_work`` by ``capture(graph)`` (a context manager)
    while a captured and replayed graph waits in a reference cycle, with
    the collector's threshold at 1 inside the capture.  Returns '' when the graph captured and
    replays to the eager result, else the error's text.  ``seen``, a dict,
    gets the collector's runs during the capture and whether the dead graph
    was gone by its end."""
    x = torch.arange(4096.0, device=device).reshape(64, 64)
    want = _work(x)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        _work(x)
    torch.cuda.current_stream(device).wait_stream(side)
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        _work(x)
    dead.replay()  # instantiated: its destruction calls cudaGraphExecDestroy
    torch.cuda.synchronize(device)
    alive = weakref.ref(_Holder(dead))
    del dead
    runs = []

    def count(phase, info):
        if phase == "start":
            runs.append(info["generation"])

    saved = gc.get_threshold()
    try:
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            # inside the capture: allocations on the way in (synchronize,
            # empty_cache) would otherwise run the collector before it begins
            gc.set_threshold(1, 1, 1)
            gc.callbacks.append(count)
            try:
                out = _work(x)
            finally:
                gc.callbacks.remove(count)
                gc.set_threshold(*saved)
                if seen is not None:
                    seen.update(runs=len(runs), dead_gone=alive() is None)
    except Exception as e:  # the capture's own error is the finding
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    finally:
        gc.set_threshold(*saved)
    graph.replay()
    torch.cuda.synchronize(device)
    return "" if torch.equal(out, want) else "replay != eager"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--way", choices=("torch.cuda.graph", "graph_capture"), default=None,
                    help="run the trials of one way in this process")
    args = ap.parse_args(argv)
    dev = require_cuda("prof_graph_gc")
    if args.way is not None:
        capture = torch.cuda.graph if args.way == "torch.cuda.graph" else graph_capture
        for _ in range(args.trials):
            seen = {}
            err = capture_with_garbage(capture, dev, seen)
            print(f"trial {'captured' if not err else 'failed: ' + err}", flush=True)
            print(f"during the capture: {seen}", flush=True)
            if err:
                break  # the context may be unusable after a failed capture
        return
    for way in ("torch.cuda.graph", "graph_capture"):
        res = subprocess.run([sys.executable, "-m", "deepprior_tpu_torch.prof.prof_graph_gc",
                              "--way", way, "--trials", str(args.trials)],
                             capture_output=True, text=True, timeout=300)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("trial")]
        ok = sum(ln == "trial captured" for ln in lines)
        failed = [ln[len("trial failed: "):] for ln in lines if ln != "trial captured"]
        during = sorted({ln for ln in res.stdout.splitlines() if ln.startswith("during")})
        refused = res.stderr.count("operation not permitted when stream is capturing")
        print(f"[graph gc] {card_label(dev)} {way}: {ok} of {args.trials} trials captured "
              f"with a dead graph in a cycle and the collector's threshold at 1"
              + (f"; failed: {failed[0]}" if failed else "") + f"; {during}; CUDA "
              f"calls refused during a capture (stderr): {refused}"
              + (f"; exit {res.returncode}: {res.stderr.strip().splitlines()[-1:]}"
                 if res.returncode else ""), flush=True)


if __name__ == "__main__":
    main()
