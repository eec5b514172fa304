"""CPU self-tests of the per-layer readers of the program's own spans and
counters (``deepprior_tpu_torch.utils.profiling``, ``MicroBatchServer.stats``):
each gives the number it says on a hand-built record, and None where the
program recorded nothing, as a program without the recorder does.

    python -m pytest bench_torch/tests -q
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from bench_torch.lib import spec
from bench_torch.lib.harness import Record
from deepprior_tpu_torch.utils import profiling

NAMES = ("queue_wait_ms.serve", "stage_ms.serve", "stage_idle_pct.serve",
         "queue_wait_p95_ms.serve", "label_passes.camera", "scan_ms.camera",
         "augment_ms.train", "optimizer_ms.train")
MS = 1_000_000


class _Event:
    """A kineto event as the readers read one."""

    def __init__(self, name, start, dur, device):
        self._v = (name, start, dur, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]


def _read(name, rec):
    return spec.metric_reader(name).read(rec)


@pytest.fixture
def recorded():
    """Spans recorded over a window [t0, t0 + 100 ms): two scans, two
    augments, one optimizer update, one batch's staging at [60, 80) ms with
    the requests it served; after the window, one of each.  Yields the
    window's start on both clocks."""
    profiling.clear()
    t0 = time.perf_counter_ns()
    with profiling.recording():
        profiling.record("detect.scan", t0 + 10 * MS, t0 + 30 * MS, passes=4)
        profiling.record("detect.scan", t0 + 40 * MS, t0 + 50 * MS, passes=8)
        profiling.record("train.augment", t0 + 10 * MS, t0 + 11 * MS)
        profiling.record("train.augment", t0 + 20 * MS, t0 + 23 * MS)
        profiling.record("train.optimizer", t0 + 30 * MS, t0 + 30 * MS + MS // 2)
        profiling.record("server.stage", t0 + 60 * MS, t0 + 80 * MS, id=7)
        for i in range(20):  # submitted at 40 .. 59 ms: waits 20 .. 1 ms
            profiling.record("server.request", t0 + (40 + i) * MS, t0 + 90 * MS, id=i, batch=7)
        for name in ("detect.scan", "train.augment", "train.optimizer", "server.stage"):
            profiling.record(name, t0 + 200 * MS, t0 + 300 * MS, id=8, passes=100)
        profiling.record("server.request", t0 + 99 * MS, t0 + 300 * MS, id=20, batch=8)
    try:
        yield t0, profiling.to_wall_ns(t0)
    finally:
        profiling.clear()


def _record(t0, wall, busy):
    """A record of the window with the card busy over ``busy`` (ms pairs)."""
    events = [_Event("kernel", wall + a * MS, (b - a) * MS, "CUDA") for a, b in busy]
    tracer = SimpleNamespace(perf_window=(t0 / 1e9, (t0 + 100 * MS) / 1e9), events=events,
                             window=[wall, wall + 100 * MS])
    values = {"server": {"frames": 100, "batches": 4, "errors": 0,
                         "queue_wait_s": 0.5, "stage_s": 0.06}}
    return Record(values, tracer, {}, None)


def test_readers_of_the_program_spans_and_counters(recorded):
    t0, wall = recorded
    rec = _record(t0, wall, [(0, 70)])
    assert _read("queue_wait_ms.serve", rec) == pytest.approx(5.0)
    assert _read("stage_ms.serve", rec) == pytest.approx(15.0)
    assert _read("queue_wait_p95_ms.serve", rec) == pytest.approx(
        np.percentile(np.arange(1, 21), 95))
    assert _read("label_passes.camera", rec) == pytest.approx(6.0)
    assert _read("scan_ms.camera", rec) == pytest.approx(15.0)
    assert _read("augment_ms.train", rec) == pytest.approx(2.0)
    assert _read("optimizer_ms.train", rec) == pytest.approx(0.5)


@pytest.mark.parametrize("busy, idle_ms", [
    ([(0, 70)], 10),  # idle over [70, 80) of the staging
    ([(0, 65), (75, 100)], 10),  # a gap [65, 75) half inside it
    ([(0, 62), (66, 68), (79, 100)], 15),  # gaps [62, 66) and [68, 79)
    ([(0, 100)], 0),
    ([], 20),  # an idle card: the whole staging
])
def test_stage_idle_is_the_idle_time_inside_the_staging(recorded, busy, idle_ms):
    """Idle time counts where it lies inside a ``server.stage`` span, not by
    the midpoint of the gap that holds it; copies and kernels off the card
    (a host event) do not make it busy."""
    t0, wall = recorded
    rec = _record(t0, wall, busy)
    rec.tracer.events.append(_Event("cudaLaunchKernel", wall + 60 * MS, 20 * MS, "CPU"))
    assert _read("stage_idle_pct.serve", rec) == pytest.approx(idle_ms)


def test_readers_give_none_without_the_programs_spans_or_counters(recorded):
    t0, wall = recorded
    rec = _record(t0, wall, [(0, 70)])
    rec.values = {"server": {"frames": 100, "batches": 4, "errors": 0}}
    profiling.clear()
    for name in NAMES:
        assert _read(name, rec) is None
        assert _read(name, Record({}, SimpleNamespace(), {}, None)) is None
