"""The port's profiling hooks (deepprior_tpu_torch/utils/profiling.py) on
the CPU: StageTimer against the JAX package's under one scripted clock, the
device timers on CPU tensors (the caller asking for the CPU: the host
clock, as tests/test_aux.py::test_profiling_timers checks the JAX ones),
and a device trace written on the CPU.  On the card the timers use CUDA
events and a CUDA graph; chip_smoke.py runs them there."""

import itertools
import json
import os
import time

import pytest
import torch

from deepprior_tpu.utils.profiling import StageTimer as JaxStageTimer

from deepprior_tpu_torch.utils import profiling


def _run_stages(timer):
    for name in ("crop", "net", "crop", "decode", "crop"):
        with timer.stage(name):
            pass
    return timer


def test_stage_timer_matches_jax(monkeypatch):
    results = []
    for cls in (JaxStageTimer, profiling.StageTimer):
        # the same clock for both: stage durations 1, 2, 3, ... ms
        ticks = itertools.accumulate(itertools.chain.from_iterable(
            (0.0, k * 1e-3) for k in itertools.count(1)))
        monkeypatch.setattr(time, "perf_counter", lambda ticks=ticks: next(ticks))
        timer = _run_stages(cls(window=2))
        results.append(([timer.ms(n) for n in ("crop", "net", "decode", "none")],
                        [timer.fps(n) for n in ("crop", "net", "none")],
                        timer.report()))
    assert results[0] == results[1]
    ms, fps, report = results[1]
    assert ms[0] == pytest.approx(4.0)  # the last two crops: 3 and 5 ms
    assert ms[3] == 0.0 and fps[2] == 0.0
    assert report.split() == ["crop=4.00ms", "decode=4.00ms", "net=2.00ms"]


def test_timers_on_cpu_tensors():
    x = torch.ones((64, 64))
    ms = profiling.time_batched_inference(lambda a: (a @ a).sum(dim=1), (x,), iters=3)
    assert ms >= 0.0

    def step(c):
        y = (x + c[0]) @ x
        return y[0, :1] * 1e-32

    dev_ms = profiling.device_loop_latency(step, torch.zeros(1), iters=5)
    assert dev_ms >= 0.0
    # loop-invariant tensors through args, outputs in a tuple
    dev_ms = profiling.device_loop_latency(
        lambda c, a: (a @ a)[0, :1] * 1e-32 + c, torch.zeros(1), iters=3, args=(x,))
    assert dev_ms >= 0.0
    assert profiling.time_batched_inference(
        lambda a: {"out": (a.sum(), a.mean())}, (x,), iters=2) >= 0.0
    profiling._drain((x, [x]))  # CPU tensors: done when the call returns
    with pytest.raises(TypeError, match="no tensor"):
        profiling.time_batched_inference(lambda: 3.0, (), iters=1)


def test_kernel_ms_on_cpu_tensors():
    x = torch.ones((64, 64))
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    assert profiling.kernel_ms(fn, (x, x), iters=4) >= 0.0
    assert len(calls) == 1 + 4  # one warm-up, then the timed calls
    with pytest.raises(TypeError, match="no tensor"):
        profiling.kernel_ms(lambda: None, (), iters=1)


def test_device_trace_writes_a_trace_on_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.device_trace(str(log_dir)) as prof:
        torch.ones((32, 32)) @ torch.ones((32, 32))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        trace = json.load(f)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


def test_card_helpers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        profiling.require_cuda("a probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.card_label()


def test_graph_capture_holds_the_collector_off(monkeypatch):
    """graph_capture collects first and keeps the cyclic collector off for
    the capture (torch.cuda.graph stubbed: the capture itself needs a card),
    until the last of nested captures ends, also when one raises; a
    collector the caller had turned off stays off."""
    import contextlib
    import gc

    seen = []

    @contextlib.contextmanager
    def fake_graph(graph):
        seen.append((graph, gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    collected = []
    real_collect = gc.collect
    monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or real_collect(*a))
    assert gc.isenabled()
    with profiling.graph_capture("outer"):
        with profiling.graph_capture("inner"):
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    assert seen == [("outer", False), ("inner", False)] and collected == [1]
    with pytest.raises(ValueError):
        with profiling.graph_capture("raises"):
            raise ValueError
    assert gc.isenabled()
    gc.disable()
    try:
        with profiling.graph_capture("off"):
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_graph_gc_probe_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from deepprior_tpu_torch.prof import prof_graph_gc

    with pytest.raises(RuntimeError, match="no CPU fallback"):
        prof_graph_gc.main(["--trials", "1"])
