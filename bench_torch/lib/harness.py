"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

``run_cell`` drives a cell on a device it is given; ``main`` is the
command's entry, which first requires the CUDA cards the cell asks for and
prints nothing but an error without them.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import subprocess
import sys
import time
from typing import Optional

import torch

from bench_torch.lib import spec as spec_mod
from bench_torch.lib.trace import Tracer, reduce_trace, top
from bench_torch.models import peaks


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


class Context:
    """What a traffic generator gets: the cell, the run's seed and window, the
    device, the tracer, and where to report."""

    def __init__(self, cell, seed, seconds, device, tracer, t_start, precision=None,
                 fault=None):
        self.cell = cell
        self.config = cell.config
        self.params = cell.params
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.tracer = tracer
        self.precision = precision or cell.config["precision"]
        self.fault = fault
        self._t_start = t_start
        self.setup_s = None
        self.values = {}  # what the per-layer readers read
        self.marks = {"run_cell": time.perf_counter() - t_start}
        self.gc_pauses = []
        self._gc_t0 = None
        self._usage0 = None
        self.usage = None

    def mark(self, name: str):
        """Note how far set-up has come: seconds since the process began."""
        self.marks[name] = time.perf_counter() - self._t_start

    def window_opens(self):
        """Call at the first timed request or step: ends set-up."""
        self.setup_s = time.perf_counter() - self._t_start
        self.marks["window"] = self.setup_s
        self._usage0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._gc_timer)
        self.tracer.start(self.device)

    def _gc_timer(self, phase, info):
        """Python's collections from the window's start, for the notes."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_pauses.append(time.perf_counter() - self._gc_t0)
            self._gc_t0 = None

    def window_closed(self):
        """Call as the window closes (again from run_cell, which is a no-op)."""
        if self._gc_timer in gc.callbacks:
            gc.callbacks.remove(self._gc_timer)
        if self._usage0 is not None and self.usage is None:
            u1, u0 = resource.getrusage(resource.RUSAGE_SELF), self._usage0
            # the host's share of the window: CPU seconds of the process and
            # the times the kernel took a core from it
            self.usage = {"host_cpu_s": u1.ru_utime + u1.ru_stime - u0.ru_utime - u0.ru_stime,
                          "involuntary_switches": u1.ru_nivcsw - u0.ru_nivcsw}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Record:
    """What a per-layer reader reads: the generator's values, the spans, the
    reduced trace and the card's peaks."""

    def __init__(self, values, tracer, trace, peak):
        self.values = values
        self.tracer = tracer
        self.trace = trace or {}
        self.peak = peak

    def ops(self, needle: str):
        """(launches, seconds) of the device operations whose name holds
        ``needle``, in the traced window."""
        hits = [v for k, v in self.trace.get("ops", {}).items() if needle in k]
        return sum(n for n, _ in hits), sum(s for _, s in hits)


def card_label(device) -> str:
    """'<name>, <power limit>' from nvidia-smi, or the name alone."""
    name = torch.cuda.get_device_name(device)
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return f"{name}, {proc.stdout.strip()}"
    except (OSError, subprocess.SubprocessError):
        return name


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, precision: Optional[str] = None,
             fault: Optional[str] = None, overrides: Optional[dict] = None) -> dict:
    """Run cell ``name`` once on ``device`` and return its result object.
    ``precision`` (the control's lower precision), ``fault`` (a fault
    planted in the timed path) and ``overrides`` (of the traffic's
    parameters) serve the readings and the self-tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec_mod.load_cell(name)
    if overrides:
        cell = cell._replace(params={**cell.params, **overrides})
    tracer = Tracer(trace, cell.params.get("profile_seconds", 3.0))
    ctx = Context(cell, seed, seconds, device, tracer, t_start, precision, fault)
    generator = spec_mod.generator_module(cell.generator)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        out = generator.run(ctx)
    finally:
        ctx.window_closed()
    gc.collect()
    peak_bytes = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    reduced = (reduce_trace(tracer.events, tracer.window, tracer.wall_spans)
               if tracer.events is not None else None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = out["check"]()
    # the numbers the cell's file gives a limit are compared; the rest are
    # reported beside them
    compared = {k: {"value": float(v), "limit": cell.limits[k]}
                for k, v in readings.items() if k in cell.limits}
    missing = [k for k in cell.limits if k not in readings]
    correct = (out["failed"] == 0 and bool(compared) and not missing
               and all(c["value"] <= c["limit"] for c in compared.values()))

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = dict(out["metrics"], setup_s=ctx.setup_s)
    if trace:
        rec = Record(ctx.values, tracer, reduced,
                     peaks.peak_of(torch.cuda.get_device_name(device))
                     if device.type == "cuda" else None)
        for m in cell.per_layer:
            v = spec_mod.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": units[m["name"]]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak_bytes}
    if device.type == "cuda":
        dev["card"] = card_label(device)
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace and reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        out.setdefault("notes", {})["trace_first_event_offset_s"] = reduced["first_event_offset_s"]
        result["breakdown"] = {
            "device_ops": top({k: s for k, (_, s) in reduced["ops"].items()}),
            "idle_gaps": top(reduced["idle_by_host"]),
        }
    gc_ms = [1e3 * t for t in ctx.gc_pauses]
    result["notes"] = dict(out.get("notes", {}), **(ctx.usage or {}), setup_marks_s=ctx.marks,
                           gc_collections=len(gc_ms),
                           gc_max_ms=max(gc_ms, default=0.0), gc_total_ms=sum(gc_ms),
                           **{"reading_" + k: v for k, v in readings.items() if k not in compared})
    result["checks"] = compared
    return result


def require_cards(chips: int) -> torch.device:
    """The first CUDA card, or SystemExit when fewer than ``chips`` cards
    are visible: the benchmark measures the card and has no CPU fallback."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"bench_torch: the cell needs {chips} CUDA card(s); "
                         f"this machine has {have}")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def main(args) -> int:
    age = process_age_s()
    t_start = time.perf_counter() - (age if age is not None else 0.0)
    cell = spec_mod.load_cell(args.workload)
    device = require_cards(cell.chips)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                      t_start=t_start)
    for k, v in result["notes"].items():
        print(f"note {k} = {v!r}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
