"""Where the benchmark finds its parts: ``BENCHMARK.json`` at the root of the
checkout names the cells, configurations and metrics; each is a file of
its own under ``bench_torch/``, found by its name:

- a configuration:   the ``file`` its ``BENCHMARK.json`` entry names
                     (``bench_torch/configs/<name>.json``)
- a cell:            ``bench_torch/workloads/<cell>.json``
- a traffic mix:     ``bench_torch/traffic/<traffic>.json``, whose ``generator``
                     names ``bench_torch/traffic/<generator>.py``
- a per-layer metric: ``bench_torch/metrics/<metric>.py`` (``read(rec)``), or,
                     where that file is missing, ``<stem>.py`` for the name's part
                     before its first dot: one reader of ``device_idle_pct``
                     serves ``device_idle_pct.serve`` and ``device_idle_pct.train``
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module (names with dots are allowed)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file
    params: dict        # the traffic mix's parameters, then the cell's own
    limits: dict        # name -> limit of each number compared
    generator: str
    end_to_end: list    # BENCHMARK.json's end-to-end entries this cell reports
    per_layer: list     # BENCHMARK.json's per-layer entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str) -> Cell:
    """The cell ``name`` with everything it names, read from the files."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(ROOT, conf["file"]))
    cell = load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", f"{entry['traffic']}.json"))
    params = {k: v for k, v in mix.items() if k != "generator"}
    params.update(cell.get("params", {}))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, int(entry["chips"]), config, params, cell.get("limits", {}),
                mix["generator"], e2e, layer)


def generator_module(generator: str):
    return load_module(os.path.join(BENCH_DIR, "traffic", f"{generator}.py"),
                       f"bench_torch_traffic_{generator}")


def metric_reader(metric: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        path = os.path.join(BENCH_DIR, "metrics", metric.split(".")[0] + ".py")
    return load_module(path, "bench_torch_metric_" + metric.replace(".", "_"))
