"""The cell ``a2j_nyu.train_b64`` driven small on the CPU through the rest of
a run (the look for a card skipped): 96x96 crops (a 6x6 map of 576
anchors), B = 8, 64 rows of 8 rendered frames.  A sound run is
``correct``; the control (the program in bfloat16) and the faults planted
in the timed path (the state left unchanged, half of each batch left out,
the weight decay left out) are not.  The two new readers
return None where the program recorded no span, as the parent program
does, and take the device time of the work launched inside their spans,
which a CPU run's trace does not have.

    python -m pytest bench_torch/tests/test_a2j_cell.py -q
"""

import time
from types import SimpleNamespace

import pytest
import torch

from bench_torch.lib import spec
from bench_torch.lib.harness import Record, run_cell
from bench_torch.tests.test_v2v_cell import _Event
from deepprior_tpu_torch.utils import profiling

CELL = "a2j_nyu.train_b64"
SMALL = dict(batch_size=8, train_frames=64, pool_frames=8)
READERS = ("heads_ms.train", "anchor_ms.train")


@pytest.fixture
def small_crop(monkeypatch):
    """The cell with its configuration's crop cut to 96x96."""
    load = spec.load_cell

    def small(name):
        cell = load(name)
        return cell._replace(config=dict(cell.config, input_hw=96))

    monkeypatch.setattr(spec, "load_cell", small)


@pytest.mark.parametrize("precision,fault,expect", [
    (None, None, True),
    ("bfloat16", None, False),
    (None, "state_unchanged", False),
    (None, "half_batch", False),
    (None, "no_decay", False),
])
def test_correct_separates_sound_runs_from_the_control_and_faults(small_crop, precision,
                                                                   fault, expect):
    r = run_cell(CELL, 3_000_000_123, 0.5, False, torch.device("cpu"), precision=precision,
                 fault=fault, overrides=SMALL)
    assert set(r["checks"]) == {"loss_rel", "grad_norm_gap", "step_norm_gap", "decay_gap",
                                "window_loss_rel", "window_grad_norm_gap",
                                "window_step_norm_gap"}
    assert r["correct"] is expect, r["checks"]
    if fault == "no_decay":  # the decay alone tells it from a sound run
        assert [k for k, c in r["checks"].items() if c["value"] > c["limit"]] == ["decay_gap"]
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert r["failed"] == 0


def test_traced_run_reports_no_device_reading_on_the_cpu(small_crop):
    """The device readers have no device operation to read on the CPU."""
    r = run_cell(CELL, 3_000_000_124, 0.5, True, torch.device("cpu"), overrides=SMALL)
    assert not set(READERS) & set(r["metrics"])


def test_device_readers_take_the_work_launched_inside_their_spans():
    """Two steps, each with an ``a2j.heads`` and a ``train.anchor`` span whose
    launches run later (a full launch queue), beside a launch outside both:
    the readers give the launched work's device time a step."""
    profiling.clear()
    t0 = time.perf_counter_ns()
    with profiling.recording():
        for k in range(2):
            at = t0 + k * 10_000_000
            profiling.record("a2j.heads", at, at + 1_000_000)
            profiling.record("train.anchor", at + 2_000_000, at + 3_000_000)
    events = []
    for k in range(2):
        at = profiling.to_wall_ns(t0 + k * 10_000_000)
        c = 10 * k
        events += [_Event("cudaLaunchKernel", False, at + 100, 5_000, c + 1),
                   _Event("cudaLaunchKernel", False, at + 900_000, 5_000, c + 2),
                   _Event("conv_kernel", True, at + 50_000_000, 7_000_000, c + 1),
                   _Event("bn_kernel", True, at + 57_000_000, 1_000_000, c + 2),
                   _Event("cudaLaunchKernel", False, at + 2_000_100, 5_000, c + 3),
                   _Event("softmax_kernel", True, at + 60_000_000, 120_000, c + 3),
                   _Event("cudaLaunchKernel", False, at + 5_000_000, 5_000, c + 4),
                   _Event("wgrad_kernel", True, at + 5_500_000, 9_000_000, c + 4)]
    tracer = SimpleNamespace(perf_window=[t0 / 1e9 - 1.0, t0 / 1e9 + 1.0], spans={},
                             events=events)
    rec = Record({}, tracer, {}, None)
    try:
        assert spec.metric_reader("heads_ms.train").read(rec) == pytest.approx(8.0)
        assert spec.metric_reader("anchor_ms.train").read(rec) == pytest.approx(0.12)
    finally:
        profiling.clear()


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_where_the_program_recorded_nothing(name):
    profiling.clear()
    now = time.perf_counter()
    tracer = SimpleNamespace(perf_window=[now - 1.0, now], spans={}, events=[])
    rec = Record({"steps": 10, "window_s": 1.0, "batch": 64, "step_flops": 1}, tracer,
                 {"ops": {}, "busy_s": 0.0, "window_s": 1.0}, None)
    assert spec.metric_reader(name).read(rec) is None


def test_the_cell_reports_the_train_metrics_and_its_own():
    """The cell reports the end-to-end rate and setup, the four train
    readers it was appended to and its two new ones, and not the K5 reader,
    whose byte model is fixed at 128x128."""
    cell = spec.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"train_samples_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "mfu_pct.train", "step_device_ms.train", "device_idle_pct.train", *READERS}
    assert cell.chips == 1 and cell.config["input_hw"] == 176
