"""The port's span recorder (deepprior_tpu_torch/utils/profiling.py) on the
CPU: off it reads no clock; on, inside ``recording()`` or under a
``torch.profiler`` session, it records nested spans per thread on a clock
the profiler's events share; the spans and counters of the server (its
eager and fixed-estimator paths), the realtime pipeline's detection and the
train step; and that the children of a batch and of a step cover it (its
self time is small, so no stage goes unseen).  The benchmark's readers of
these spans are tested in bench_torch/tests/test_program_readers.py."""

import threading
import time

import numpy as np
import pytest
import torch

from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_depth_frame, make_sequence
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ScaleNet, ScaleNetConfig
from deepprior_tpu_torch.ops import com as tcom
from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
from deepprior_tpu_torch.parallel import ShardedEstimator
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.realtime import camera as tcamera
from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
from deepprior_tpu_torch.realtime.fused import FusedEstimator
from deepprior_tpu_torch.realtime.pipeline import RealtimeHandposePipeline
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer
from deepprior_tpu_torch.utils import profiling

SERVER_STAGES = ["server.stage", "server.launch", "server.fetch", "server.resolve"]
TRAIN_STAGES = ["train.augment", "train.forward", "train.backward", "train.optimizer"]


def _prior():
    rng = np.random.default_rng(0)
    return PCAPrior((rng.standard_normal((30, 42)) * 0.05).astype(np.float32),
                    rng.uniform(-0.1, 0.1, 42).astype(np.float32))


def _pose_net():
    torch.manual_seed(0)
    return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))


def _recorded(fn):
    """fn()'s result and the spans recorded while it ran."""
    profiling.clear()
    with profiling.recording():
        out = fn()
    got = profiling.spans()
    profiling.clear()
    return out, got


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.seq), key=lambda s: s.start_ns)


def _coverage(spans, parent):
    """The share of ``parent`` its children cover (one minus its self time)."""
    return sum(s.end_ns - s.start_ns for s in _children(spans, parent)) / (
        parent.end_ns - parent.start_ns)


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    assert not profiling.enabled()
    profiling.clear()

    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(time, "time_ns", no_clock)
    first = profiling.span("a", id=1, n=2)
    assert profiling.span("b") is first  # one shared object
    with first, profiling.span("c", id=3):
        profiling.annotate(passes=4)
    profiling.record("d", 0, 1)
    assert profiling.spans() == []


def test_on_nests_per_thread_with_ids_and_attrs():
    def work(tag):
        with profiling.span(f"{tag}.outer", id=7, kind=tag):
            with profiling.span(f"{tag}.inner", id=7):
                profiling.annotate(passes=2)
                profiling.annotate(passes=3)
                time.sleep(0.01)
            with profiling.timed(f"{tag}.timed", id=8) as t:
                pass
        assert t.seconds >= 0.0

    def both():
        other = threading.Thread(target=work, args=("b",))
        other.start()
        work("a")
        other.join(timeout=60)
        assert not other.is_alive()

    _, got = _recorded(both)
    assert len(got) == 6
    for tag in ("a", "b"):
        by = {s.name: s for s in got if s.name.startswith(tag + ".")}
        outer, inner, timed = by[f"{tag}.outer"], by[f"{tag}.inner"], by[f"{tag}.timed"]
        assert outer.parent is None and inner.parent == timed.parent == outer.seq
        assert outer.id == inner.id == 7 and timed.id == 8
        assert outer.attrs == {"kind": tag} and inner.attrs == {"passes": 5}
        assert outer.start_ns <= inner.start_ns < inner.end_ns <= timed.start_ns <= outer.end_ns
        assert len({outer.thread, inner.thread, timed.thread}) == 1
    assert {s.thread for s in got if s.name.startswith("a.")} != {
        s.thread for s in got if s.name.startswith("b.")}
    # a timed block outside recording keeps its times and records nothing
    with profiling.timed("off") as t:
        time.sleep(0.001)
    assert t.seconds > 0.0 and profiling.spans() == []


def test_profiler_flag_turns_spans_on_and_shares_its_clock():
    """Under a CPU torch.profiler session, with no recording(), spans
    record; a span around a matmul, put on the wall clock, holds the
    profiler's aten::mm event within 1 ms; recording stops with the
    profiler.  The flag the recorder reads is the one torch sets at the
    profiler's start and clears at its stop."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((256, 256))
    profiling.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled and profiling.enabled()
        with profiling.span("matmul", id=1):
            x @ x
    assert not torch.autograd.profiler._is_profiler_enabled and not profiling.enabled()
    assert profiling.span("after") is profiling.span("again")
    (s,) = profiling.spans()
    profiling.clear()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    lo, hi = profiling.to_wall_ns(s.start_ns), profiling.to_wall_ns(s.end_ns)
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert lo - 1_000_000 <= start and end <= hi + 1_000_000


@pytest.fixture(scope="module")
def served():
    """A CPU MicroBatchServer (graph=False): stats after three requests with
    tracing off, then the spans of three more under recording()."""
    est = FusedEstimator(_pose_net(), NYU_CAMERA, prior=_prior(), device="cpu")
    rng = np.random.default_rng(3)
    frames = [make_depth_frame(NYU_CAMERA, rng) for _ in range(3)]
    srv = MicroBatchServer(est, max_batch=4, max_wait_ms=100.0, graph=False)
    try:
        for f in [srv.submit(d, c) for d, c in frames]:
            f.result(timeout=120)
        stats = dict(srv.stats)

        def traced():
            # an idle collector wakes every 100 ms: let one collect open
            # while recording
            time.sleep(0.3)
            futs = [srv.submit(d, c) for d, c in frames]
            for f in futs:
                f.result(timeout=120)
            srv.close()  # the worker records each request after resolving it
            return futs

        _, got = _recorded(traced)
    finally:
        srv.close()
    return stats, got


def test_server_spans_and_stats(served):
    stats, got = served
    assert stats["frames"] == 3 and stats["queue_wait_s"] > 0.0 and stats["stage_s"] > 0.0
    (batch,) = [s for s in got if s.name == "server.batch"]
    assert batch.attrs == {"frames": 3, "padded": 1}
    kids = _children(got, batch)
    assert [s.name for s in kids] == SERVER_STAGES
    assert {s.id for s in kids} == {batch.id}
    assert any(s.name == "server.collect" and s.end_ns <= batch.start_ns for s in got)
    requests = [s for s in got if s.name == "server.request"]
    assert len(requests) == 3 and len({s.id for s in requests}) == 3
    assert all(s.attrs == {"batch": batch.id} and s.parent is None for s in requests)
    stage = kids[0]
    assert all(s.start_ns <= stage.start_ns and s.end_ns >= kids[-1].start_ns
               for s in requests)


def test_fixed_estimator_server_records_the_same_spans_and_stats():
    """The server's fixed-estimator path (a ShardedEstimator of two CPU
    replicas, stacked without pinned buffers) takes the eager path's clock
    reads: the same spans under one batch, the same stats, and the
    sharded estimator's answers on the tail-padded batch."""
    est = FusedEstimator(_pose_net(), NYU_CAMERA, prior=_prior(), device="cpu")
    rng = np.random.default_rng(4)
    frames = [make_depth_frame(NYU_CAMERA, rng) for _ in range(3)]
    sharded = ShardedEstimator(est, devices=["cpu", "cpu"])
    srv = MicroBatchServer(sharded, max_batch=4, max_wait_ms=100.0)
    try:
        def traced():
            futs = [srv.submit(d, c) for d, c in frames]
            out = np.stack([f.result(timeout=120) for f in futs])
            srv.close()  # the worker records each request after resolving it
            return out

        got_joints, got = _recorded(traced)
    finally:
        srv.close()
    assert srv.stats["frames"] == 3 and srv.stats["batches"] == 1
    assert srv.stats["queue_wait_s"] > 0.0 and srv.stats["stage_s"] > 0.0
    (batch,) = [s for s in got if s.name == "server.batch"]
    assert batch.attrs == {"frames": 3, "padded": 1}
    assert [s.name for s in _children(got, batch)] == SERVER_STAGES
    assert _coverage(got, batch) >= 0.95
    assert sorted(s.attrs["batch"] for s in got if s.name == "server.request") == [batch.id] * 3
    depth = np.stack([d for d, _ in frames] + [frames[-1][0]])
    com = np.stack([c for _, c in frames] + [frames[-1][1]])
    np.testing.assert_array_equal(got_joints, sharded(depth, com)[0][:3].numpy())


@pytest.fixture(scope="module")
def detected():
    """One CPU frame through a pipeline with device detection and the
    ScaleNet refiner, recorded; and the frame."""
    torch.manual_seed(1)
    scale = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3, hidden=64))
    est = FusedEstimator(_pose_net(), ICVL_CAMERA, prior=_prior(), device="cpu")
    pipe = RealtimeHandposePipeline(
        est, {"fx": ICVL_CAMERA.fx, "fy": ICVL_CAMERA.fy, "cube": (250.0, 250.0, 250.0)},
        com_refiner=CNNComRefiner(scale, ICVL_CAMERA))
    dev = tcamera.SyntheticDevice(ICVL_CAMERA, seed=5)
    dev.start()
    frame = dev.getDepth()[1]
    out, got = _recorded(lambda: pipe.process_frame(frame))
    assert out is not None
    return pipe, frame, got


def test_detection_spans_count_the_label_passes(detected, monkeypatch):
    pipe, frame, got = detected
    detect, pose = sorted((s for s in got if s.parent is None), key=lambda s: s.start_ns)
    assert (detect.name, pose.name) == ("pipeline.detect", "pipeline.pose")
    scan, refine = _children(got, detect)
    assert (scan.name, refine.name) == ("detect.scan", "detect.refine")
    assert detect.id == pose.id == scan.id == refine.id == 1
    assert pipe.times["detect"] == detect.seconds and pipe.times["pose"] == pose.seconds
    # the label scan's passes counted apart: two segmented scans a pass
    scans = []
    inner = tcom._seg_min_scan
    monkeypatch.setattr(tcom, "_seg_min_scan", lambda *a: scans.append(1) or inner(*a))
    tcom.detect(torch.as_tensor(frame, dtype=torch.float32)[None],
                torch.tensor([250.0, 250.0, 250.0]), ICVL_CAMERA.fx, ICVL_CAMERA.fy)
    assert scan.attrs["passes"] == len(scans) // 2 >= 2


def _train_once(trace: bool):
    seq = make_sequence(NYU_CAMERA, 8, seed=3)
    data = TrainData.from_sequence(seq).to("cpu")
    trainer = Trainer(_pose_net(), TrainConfig(batch_size=8), NYU_CAMERA, prior=_prior(),
                      device="cpu")
    state = trainer.init_state()

    def step():
        return trainer.train_step(state, data.take(torch.arange(8)),
                                  torch.Generator().manual_seed(1),
                                  torch.Generator().manual_seed(2), 1e-3)

    if trace:
        (state, loss), got = _recorded(step)
    else:
        (state, loss), got = step(), []
    return loss, [p.detach().clone() for p in state.model.parameters()], got


@pytest.fixture(scope="module")
def trained():
    return _train_once(False), _train_once(True)


def test_train_step_spans_change_nothing(trained):
    (loss0, params0, _), (loss1, params1, got) = trained
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
    (step,) = [s for s in got if s.parent is None]
    assert step.name == "train.step"
    assert [s.name for s in _children(got, step)] == TRAIN_STAGES
    assert {s.id for s in got} == {0}


def test_children_cover_the_batch_and_the_step(served, trained):
    _, got = served
    (batch,) = [s for s in got if s.name == "server.batch"]
    assert _coverage(got, batch) >= 0.95
    got = trained[1][2]
    (step,) = [s for s in got if s.name == "train.step"]
    assert _coverage(got, step) >= 0.90
