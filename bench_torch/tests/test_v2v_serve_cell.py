"""The cell ``v2v_nyu.serve_b8`` driven small on the CPU through the rest of
a run (the look for a card skipped): a 24^3 grid (the published margin of 4
voxels a side), B = 4, 8 rendered frames.  A sound run is ``correct``; the
control (the program in bfloat16) and the faults planted in the timed path
(each answer altered by 1 mm; every 97th voxel of the grids cleared) are
not.  The reference's calibration is kept out of ``setup_s``.  The cell's two new readers are held
to hand-built records: the device time of the work launched inside the
program's ``server.launch`` spans, and the estimator's voxel counters; each
returns None where the program recorded nothing.

    python -m pytest bench_torch/tests/test_v2v_serve_cell.py -q
"""

import time
from types import SimpleNamespace

import pytest
import torch

from bench_torch.lib import spec
from bench_torch.lib.harness import Record, run_cell
from deepprior_tpu_torch.utils import profiling

CELL = "v2v_nyu.serve_b8"
SMALL = dict(rate_per_s=40.0, pool_frames=8, check_requests=12, warm_batches=1, max_batch=4)
READERS = ("batch_device_ms.serve", "voxel_occupancy_pct.serve")


@pytest.fixture
def small_grid(monkeypatch):
    """The cell with its configuration's grid cut to 24^3 in 32 voxels."""
    load = spec.load_cell

    def small(name):
        cell = load(name)
        model = dict(cell.config["model"], grid=24, cube_voxels=32, heat_grid=12)
        return cell._replace(config=dict(cell.config, model=model))

    monkeypatch.setattr(spec, "load_cell", small)


@pytest.mark.parametrize("precision,fault,expect", [
    (None, None, True),
    ("bfloat16", None, False),
    (None, "answer_altered", False),
    (None, "voxels_dropped", False),
])
def test_correct_separates_sound_runs_from_the_control_and_fault(small_grid, precision,
                                                                  fault, expect):
    r = run_cell(CELL, 3_000_000_123, 0.5, False, torch.device("cpu"), precision=precision,
                 fault=fault, overrides=SMALL)
    assert set(r["checks"]) == {"grid_mismatch", "heatmap_rel", "joints_mm"}
    assert r["correct"] is expect, r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 20
    assert set(r["metrics"]) == {"serve_p95_ms", "setup_s"}
    notes = r["notes"]
    # most joints are compared: a clear top voxel
    assert notes["reading_joints_skipped"] < 0.5 * notes["reading_joints_checked"]
    if expect:
        assert r["checks"]["grid_mismatch"]["value"] == 0.0
        assert r["checks"]["joints_mm"]["value"] == 0.0
        # every batch computes max_batch rows, padding included
        assert notes["rows_computed"] == 4 * notes["batches"] > 0
        reference_s = notes["setup_reference_s"]
        assert 0.0 < reference_s < notes["setup_marks_s"]["window"]
        assert r["metrics"]["setup_s"]["value"] == pytest.approx(
            notes["setup_marks_s"]["window"] - reference_s)
    elif fault == "answer_altered":
        assert r["checks"]["joints_mm"]["value"] >= 1.0 - 1e-3
    elif fault == "voxels_dropped":
        # about 1/97 of the set voxels, each a voxel of the union
        grid = r["checks"]["grid_mismatch"]
        assert 0.003 < grid["value"] < 0.03 and grid["value"] > 100 * grid["limit"]


def test_traced_run_reports_the_voxel_occupancy(small_grid):
    """On the CPU the occupancy; the device reader has no device operation
    to read there."""
    r = run_cell(CELL, 3_000_000_124, 0.5, True, torch.device("cpu"), overrides=SMALL)
    got = r["metrics"]
    assert 0.0 < got["voxel_occupancy_pct.serve"]["value"] < 20.0
    assert "batch_device_ms.serve" not in got


class _Event:
    """A profiler event as the readers see one: a host call (a CUDA
    runtime call) or a device operation, with its correlation id."""

    def __init__(self, name, on_device, start_ns, duration_ns, correlation_id):
        self._v = (name, on_device, start_ns, duration_ns, correlation_id)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return False


def test_batch_device_reader_takes_the_work_launched_inside_the_launch_spans():
    """Two batches, each a 1 ms ``server.launch`` span holding a copy and a
    graph launch whose kernels run 5-40 ms later, beside the fetch's copy
    back outside the span: the reader gives the launched work's device time
    a batch (30.1 ms), not the span's host time nor the fetch."""
    profiling.clear()
    t0 = time.perf_counter_ns()
    with profiling.recording():
        for k in range(2):
            at = t0 + k * 50_000_000
            profiling.record("server.launch", at, at + 1_000_000, id=k, rows=8)
    events = []
    for k in range(2):
        at = profiling.to_wall_ns(t0 + k * 50_000_000)
        c = 10 * k
        events += [_Event("cudaMemcpyAsync", False, at + 100, 5_000, c + 1),
                   _Event("Memcpy HtoD", True, at + 10_000, 100_000, c + 1),
                   _Event("cudaGraphLaunch", False, at + 200_000, 20_000, c + 2),
                   _Event("conv_kernel", True, at + 5_000_000, 20_000_000, c + 2),
                   _Event("bn_kernel", True, at + 25_000_000, 10_000_000, c + 2),
                   _Event("cudaMemcpyAsync", False, at + 2_000_000, 5_000, c + 3),
                   _Event("Memcpy DtoH", True, at + 40_000_000, 10_000, c + 3)]
    tracer = SimpleNamespace(perf_window=[t0 / 1e9 - 1.0, t0 / 1e9 + 1.0], spans={},
                             events=events)
    rec = Record({}, tracer, {}, None)
    try:
        assert spec.metric_reader("batch_device_ms.serve").read(rec) == pytest.approx(30.1)
    finally:
        profiling.clear()


def test_voxel_reader_takes_the_counters_change():
    rec = Record({"voxels_set": 1_227, "voxels_seen": 681_472}, SimpleNamespace(), {}, None)
    assert spec.metric_reader("voxel_occupancy_pct.serve").read(rec) == pytest.approx(
        100.0 * 1_227 / 681_472)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_where_the_program_recorded_nothing(name):
    profiling.clear()
    now = time.perf_counter()
    tracer = SimpleNamespace(perf_window=[now - 1.0, now], spans={}, events=[])
    rec = Record({"server": {"frames": 8, "batches": 1}, "max_batch": 8}, tracer,
                 {"ops": {}, "busy_s": 0.0, "window_s": 1.0}, None)
    assert spec.metric_reader(name).read(rec) is None
