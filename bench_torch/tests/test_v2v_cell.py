"""The cell ``v2v_nyu.train_b8`` driven small on the CPU through the rest of
a run (the look for a card skipped): a 24^3 grid (the published margin of 4
voxels a side), B = 4, 64 rows of 8 rendered frames.  A sound run is
``correct``; the control (the program in bfloat16) and both faults planted
in the timed path (the state left unchanged, half of each batch left out)
are not.  The cell's three new readers return None where the program
recorded no span or counter, as the parent program does; the two device
readers take the device time of the work launched inside their spans,
which a CPU run's trace does not have.

    python -m pytest bench_torch/tests/test_v2v_cell.py -q
"""

import time
from types import SimpleNamespace

import pytest
import torch

from bench_torch.lib import spec
from bench_torch.lib.harness import Record, run_cell
from deepprior_tpu_torch.utils import profiling

CELL = "v2v_nyu.train_b8"
SMALL = dict(batch_size=4, train_frames=64, pool_frames=8)
READERS = ("voxelize_ms.train", "heatmap_ms.train", "voxel_occupancy_pct.train")


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
    (None, "state_unchanged", False),
    (None, "half_batch", False),
])
def test_correct_separates_sound_runs_from_the_control_and_faults(small_grid, precision,
                                                                   fault, expect):
    r = run_cell(CELL, 3_000_000_123, 0.5, False, torch.device("cpu"), precision=precision,
                 fault=fault, overrides=SMALL)
    assert set(r["checks"]) == {"loss_rel", "grad_norm_gap", "step_norm_gap",
                                "window_loss_rel", "window_grad_norm_gap",
                                "window_step_norm_gap"}
    assert r["correct"] is expect, r["checks"]
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_traced_run_reports_the_new_readings(small_grid):
    """On the CPU the occupancy; the device readers have no device
    operation to read there."""
    r = run_cell(CELL, 3_000_000_124, 0.5, True, torch.device("cpu"), overrides=SMALL)
    got = r["metrics"]
    assert 0.0 < got["voxel_occupancy_pct.train"]["value"] < 20.0
    assert "voxelize_ms.train" not in got and "heatmap_ms.train" not in got


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


def test_device_readers_take_the_work_launched_inside_their_spans():
    """Two steps, each with a 1 ms ``train.voxelize`` and ``train.targets``
    span, whose launches run 50-60 ms later (a full launch queue), beside a
    launch outside both: the readers give the launched work's device time a
    step (0.2 and 0.13 ms), not the spans' host time."""
    profiling.clear()
    t0 = time.perf_counter_ns()
    with profiling.recording():
        for k in range(2):
            at = t0 + k * 10_000_000
            profiling.record("train.voxelize", at, at + 1_000_000, id=k)
            profiling.record("train.targets", at + 2_000_000, at + 3_000_000, id=k)
    events = []
    for k in range(2):
        at = profiling.to_wall_ns(t0 + k * 10_000_000)
        c = 10 * k
        events += [_Event("cudaLaunchKernel", False, at + 100, 5_000, c + 1),
                   _Event("cudaLaunchKernel", False, at + 900_000, 5_000, c + 2),
                   _Event("scatter_kernel", True, at + 50_000_000, 150_000, c + 1),
                   _Event("fill_kernel", True, at + 50_200_000, 50_000, c + 2),
                   _Event("cudaLaunchKernel", False, at + 2_000_100, 5_000, c + 3),
                   _Event("exp_kernel", True, at + 60_000_000, 130_000, c + 3),
                   _Event("cudaLaunchKernel", False, at + 5_000_000, 5_000, c + 4),
                   _Event("conv_kernel", True, at + 5_500_000, 9_000_000, c + 4)]
    tracer = SimpleNamespace(perf_window=[t0 / 1e9 - 1.0, t0 / 1e9 + 1.0], spans={},
                             events=events)
    rec = Record({}, tracer, {}, None)
    try:
        assert spec.metric_reader("voxelize_ms.train").read(rec) == pytest.approx(0.2)
        assert spec.metric_reader("heatmap_ms.train").read(rec) == pytest.approx(0.13)
    finally:
        profiling.clear()


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_where_the_program_recorded_nothing(name):
    profiling.clear()
    now = time.perf_counter()
    tracer = SimpleNamespace(perf_window=[now - 1.0, now], spans={})
    rec = Record({"steps": 10, "window_s": 1.0, "batch": 8, "step_flops": 1}, tracer,
                 {"ops": {}, "busy_s": 0.0, "window_s": 1.0}, None)
    assert spec.metric_reader(name).read(rec) is None
