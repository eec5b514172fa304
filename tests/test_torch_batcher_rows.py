"""MicroBatchServer's graph path (realtime/batcher.py) on the CPU: one graph
for each row count from 1 to ``max_batch``, all over leading slices of one
set of static buffers, and a batch of n requests staged as n rows and
replayed by the n-row graph, answering bit for bit what the eager pipeline
answers on those n rows; per-request cube and mirror on the right rows; the
server's ``rows`` counter and the ``server.launch`` span's ``rows``;
``_stage(shape)[0]``, the ``max_batch`` capture the benchmark replays.

A CUDA graph needs a card, so a stand-in takes its place: captured through
``utils.profiling.graph_capture`` (``torch.cuda.graph`` stubbed), its
``replay`` reruns the captured ``_pipeline_cfg`` eagerly on the graph's
static slices into the captured outputs.  Pinning is a no-op here (a
CPU-only torch refuses it).  chip_smoke.py phases 53-54 hold the real
graphs to the eager pipeline on the card."""

import contextlib
import itertools
import gc

import numpy as np
import pytest
import torch

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_depth_frame
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, V2VConfig, V2VPoseNet
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.realtime import fused
from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
from deepprior_tpu_torch.realtime.fused import Captured, FusedEstimator
from deepprior_tpu_torch.utils import profiling

MB = 4  # the server's max_batch
WAIT_MS = 300.0  # every request of a test's batch arrives well inside it


class FakeGraph:
    """Stands in for a CUDA graph of ``fn``: ``replay`` reruns it into the
    outputs of its capture, as a replay overwrites them.  ``pool()`` is the
    pool it was captured into (a new one unless given), ``order`` its place
    among the captures."""

    captured = itertools.count()

    def __init__(self, fn, outputs, pool):
        self.fn, self.outputs, self.replays = fn, outputs, 0
        self._pool = object() if pool is None else pool
        self.order = next(self.captured)

    def pool(self):
        return self._pool

    def replay(self):
        self.replays += 1
        with torch.inference_mode():
            for out, new in zip(self.outputs, self.fn()):
                out.copy_(new)


def fake_capture_graph(fn, device, pool=None):
    with profiling.graph_capture(None, pool):
        outputs = fn()
    return FakeGraph(fn, outputs, pool), outputs


@pytest.fixture
def graphs(monkeypatch):
    """The server's graph path on the CPU: the estimator captures, each
    capture a FakeGraph; returns the count of Python's garbage collections."""
    collected = []
    real_collect = gc.collect
    monkeypatch.setattr(FusedEstimator, "captures", property(lambda self: True))
    monkeypatch.setattr(fused, "capture_graph", fake_capture_graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a, **k: self)
    monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or real_collect(*a))
    return collected


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(21)
    pairs = [make_depth_frame(NYU_CAMERA, rng) for _ in range(6)]
    return np.stack([d for d, _ in pairs]), np.stack([c for _, c in pairs])


def _estimator():
    torch.manual_seed(0)
    net = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    rng = np.random.default_rng(0)
    prior = PCAPrior((rng.standard_normal((30, 42)) * 0.05).astype(np.float32),
                     rng.uniform(-0.1, 0.1, 42).astype(np.float32))
    return FusedEstimator(net, NYU_CAMERA, prior=prior, device="cpu")


def _v2v_estimator():
    """A V2V-PoseNet on a 24^3 grid, He-normal convolutions and random
    BatchNorm scales, shifts and statistics, in eval mode."""
    net = V2VPoseNet(V2VConfig(grid=24, cube_voxels=32))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, float(np.sqrt(2.0 / (p.numel() // p.shape[0]))), generator=gen)
            else:
                p.uniform_(0.5, 1.5, generator=gen)
        for name, b in net.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=gen)
    return FusedEstimator(net, NYU_CAMERA, cube=(300.0, 300.0, 300.0), device="cpu")


def _batch(srv, reqs):
    """Submit ``reqs`` ((depth, com, cube, mirror) each) at once; their
    answers, which arrive as one batch."""
    batches = srv.stats["batches"]
    futs = [srv.submit(d, c, cube=cb, mirror=m) for d, c, cb, m in reqs]
    got = np.stack([f.result(timeout=120) for f in futs])
    assert srv.stats["batches"] == batches + 1
    return got


def _eager(est, reqs):
    """The eager pipeline on ``reqs`` as one batch of len(reqs) rows."""
    cube = np.stack([est.cube.numpy() if cb is None else cb for _, _, cb, _ in reqs])
    return est(np.stack([d for d, _, _, _ in reqs]), np.stack([c for _, c, _, _ in reqs]),
               cube=cube, mirror=np.array([m for _, _, _, m in reqs]))[0].numpy()


def _nan_fill(staged):
    """NaN in every row of the pinned and static buffers: a row the batch
    does not stage or copy stays NaN."""
    staged.depth.fill_(float("nan"))
    staged.com.fill_(float("nan"))
    with torch.inference_mode():
        staged.full.depth.fill_(float("nan"))
        staged.full.com.fill_(float("nan"))


@pytest.mark.parametrize("n", [1, 3, MB])
def test_a_batch_of_n_replays_the_n_row_graph_on_n_staged_rows(graphs, frames, n):
    depth, com = frames
    est = _estimator()
    reqs = [(depth[i], com[i], None, False) for i in range(n)]
    with MicroBatchServer(est, max_batch=MB, max_wait_ms=WAIT_MS) as srv:
        assert srv.graph
        staged = srv._stage(depth.shape[1:])
        _nan_fill(staged)
        profiling.clear()
        with profiling.recording():
            got = _batch(srv, reqs)
        spans = profiling.spans()
        profiling.clear()
    assert [g.graph.replays for g in staged.graphs] == [int(k == n) for k in range(1, MB + 1)]
    for buf in (staged.depth, staged.com, staged.full.depth, staged.full.com):
        assert not torch.isnan(buf[:n]).any() and torch.isnan(buf[n:]).all()
    (batch,) = [s for s in spans if s.name == "server.batch"]
    (launch,) = [s for s in spans if s.name == "server.launch"]
    assert batch.attrs == {"frames": n, "padded": 0} and launch.attrs == {"rows": n}
    np.testing.assert_array_equal(got, _eager(est, reqs))


def test_per_request_cube_and_mirror_reach_their_rows_after_a_larger_batch(graphs, frames):
    """A full batch writes every row's cube and mirror; the smaller batches
    after it answer with their own, the estimator's where a request has
    none, bit-equal to the eager pipeline at their row counts."""
    depth, com = frames
    est = _estimator()
    c300, c280 = np.full(3, 300.0, np.float32), np.full(3, 280.0, np.float32)
    groups = [[(depth[i], com[i], c300 if i % 2 else None, i % 2 == 0) for i in range(MB)],
              [(depth[4], com[4], None, True), (depth[5], com[5], c280, False)],
              [(depth[0], com[0], None, False)],
              [(depth[1], com[1], c280, True), (depth[2], com[2], None, False),
               (depth[3], com[3], None, False)]]
    with MicroBatchServer(est, max_batch=MB, max_wait_ms=WAIT_MS) as srv:
        got = [_batch(srv, g) for g in groups]
    for answers, reqs in zip(got, groups):
        np.testing.assert_array_equal(answers, _eager(est, reqs))


@pytest.mark.parametrize("graph", [True, False])
def test_rows_count_what_the_device_computed(graphs, frames, graph):
    """``stats['rows']`` equals the frames on the graph path and batches x
    max_batch on the eager path, which pads; every stat is a number."""
    depth, com = frames
    est = _estimator()
    with MicroBatchServer(est, max_batch=MB, max_wait_ms=WAIT_MS, graph=graph) as srv:
        assert srv.graph == graph
        profiling.clear()
        with profiling.recording():
            for n in (1, 3):
                _batch(srv, [(depth[i], com[i], None, False) for i in range(n)])
        launches = [s.attrs["rows"] for s in profiling.spans() if s.name == "server.launch"]
        profiling.clear()
        stats = dict(srv.stats)
    assert stats["frames"] == 4 and stats["batches"] == 2 and not stats["errors"]
    assert stats["rows"] == (4 if graph else 2 * MB)
    assert launches == ([1, 3] if graph else [MB, MB])
    assert all(isinstance(v, (int, float)) for v in stats.values())


def test_stage_puts_the_max_batch_capture_first(graphs, frames):
    """``_stage(shape)[0]`` is the capture at max_batch rows whose static
    buffers every graph reads and whose outputs every graph writes the
    leading rows of, captured first, the rest largest first into its memory
    pool; its replay (as the benchmark's readout makes it) is the eager
    pipeline at max_batch rows.  The server collects Python's garbage once
    for all its captures."""
    depth, com = frames
    est = _estimator()
    shape = depth.shape[1:]
    srv = MicroBatchServer(est, max_batch=MB, max_wait_ms=WAIT_MS)
    try:
        assert len(graphs) == 1  # max_batch captures, one collection
        staged = srv._stage(shape)
        cap = staged[0]
        assert isinstance(cap, Captured) and cap is staged.graphs[-1] is staged.full
        assert srv._stage(shape) is staged
        assert (tuple(cap.depth.shape), tuple(cap.com.shape), tuple(cap.cube.shape),
                tuple(cap.mirror.shape)) == ((MB, *shape), (MB, 3), (MB, 3), (MB,))
        for n, g in enumerate(staged.graphs, 1):
            for name in ("depth", "com", "cube", "mirror"):
                t, full = getattr(g, name), getattr(cap, name)
                assert t.shape[0] == n and t.data_ptr() == full.data_ptr()
            assert len(g.outputs) == len(cap.outputs) == 3
            for t, full in zip(g.outputs, cap.outputs):
                assert t.shape[0] == n and t.data_ptr() == full.data_ptr()
            assert g.graph.pool() is cap.graph.pool()
        orders = [g.graph.order for g in staged.graphs]
        assert orders[-1] < orders[-2] and orders[:-1] == sorted(orders[:-1], reverse=True)
        assert tuple(cap.outputs[0].shape) == (MB, 14, 3)
        with torch.inference_mode():
            cap.depth.copy_(torch.from_numpy(depth[:MB]))
            cap.com.copy_(torch.from_numpy(com[:MB]))
            cap.cube.copy_(est.cube.expand(MB, 3))
            cap.mirror.zero_()
            cap.graph.replay()
            want = est._pipeline(torch.from_numpy(depth[:MB]), torch.from_numpy(com[:MB]))
        assert all(torch.equal(a, b) for a, b in zip(cap.outputs, want))
    finally:
        srv.close()


def test_v2v_batch_of_n_answers_the_eager_pipeline_at_n_rows(graphs, frames):
    """V2V-PoseNet, whose padded row would cost a whole forward pass: a
    batch of 3 replays the 3-row graph, joints, grids and heatmaps bit-equal
    to the eager pipeline on those 3 rows."""
    depth, com = frames
    est = _v2v_estimator()
    reqs = [(depth[i], com[i], None, i == 1) for i in range(3)]
    with MicroBatchServer(est, max_batch=MB, max_wait_ms=WAIT_MS) as srv:
        got = _batch(srv, reqs)
        cap = srv._stage(depth.shape[1:]).graphs[2]
        outputs = [t.clone() for t in cap.outputs]
    assert cap.graph.replays == 1 and srv.stats["rows"] == 3
    want = est(depth[:3], com[:3], mirror=np.array([False, True, False]))
    np.testing.assert_array_equal(got, want[0].numpy())
    assert len(outputs) == 5 and all(torch.equal(a, b) for a, b in zip(outputs, want))
