"""Open-loop serving: single depth frames submitted to ``MicroBatchServer``
over ``FusedEstimator`` on a fixed arrival schedule, as independent
clients behind ``serve_http`` send them.

Parameters (the traffic mix, then the cell's file):
  rate_per_s      offered requests a second; the arrivals are that many
                  per second of the window, at uniform random times (a
                  Poisson process given its count), so every seed offers
                  the same load in another order
  max_batch, max_wait_ms   the server's batching
  pool_frames     distinct frames the requests are drawn from
  warm_batches    full batches served in set-up
  check_requests  answers compared with the plain reference
Every request carries the configuration's cube and no mirror.  A
request's latency runs from its due time to the moment its Future
resolves, so a stalled generator or server counts against it.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import time

import numpy as np
import torch

from bench_torch.lib import frames, system
from bench_torch.models.crop_bytes import crop_bytes_per_sample
from bench_torch.models.flops import forward_flops
from bench_torch.reference import serve as reference

DRAIN_S = 60.0  # how long answers may come after the window closes


def arrivals(seed: int, rate: float, seconds: float, pool: int):
    """(due times in s from the window's start, pool frame of each): rate x
    seconds arrivals at sorted uniform times, frames drawn uniformly."""
    r = system.rng(seed, "schedule")
    n = int(round(rate * seconds))
    return np.sort(r.uniform(0.0, seconds, n)), r.integers(0, pool, n)


def run(ctx):
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    spec = cfg["model"]
    b = int(p["max_batch"])
    weights = system.net_weights(spec, ctx.seed, "pose_net", dev)
    comp, mean = system.pca_basis(cfg, ctx.seed, dev)
    cam = system.program_camera(cfg)
    cube = tuple(float(c) for c in cfg["cube_mm"])
    depth, com, _ = frames.render_pool(cfg, system.rng(ctx.seed, "frames"), int(p["pool_frames"]))
    due, which = arrivals(ctx.seed, float(p["rate_per_s"]), ctx.seconds, len(depth))
    n = len(due)

    ctx.mark("inputs")
    net = system.program_net(spec, weights, ctx.precision, dev)
    est = FusedEstimator(net, cam, cube=cube, prior=system.program_prior(comp, mean),
                         device=dev)
    server = MicroBatchServer(est, max_batch=b, max_wait_ms=float(p["max_wait_ms"]))
    if ctx.fault == "answer_altered":
        resolve = server._resolve
        server._resolve = lambda items, joints: resolve(items, joints + 1.0)
    pool_of = {}  # id(Future) -> pool frame, for the traced run's byte count
    step_s = []  # each batch step's seconds, for the notes
    run_batch = server._run_batch

    def timed_batch(items):
        t = time.perf_counter()
        run_batch(items)
        step_s.append(time.perf_counter() - t)

    server._run_batch = timed_batch
    if ctx.tracer.enabled:
        per_frame = crop_bytes_per_sample(
            torch.as_tensor(com), torch.tensor(cube).expand(len(com), 3),
            cam.fx, cam.fy, depth.shape[1:]).numpy()
        batch_bytes = ctx.values.setdefault("k1_batch_bytes", [])

        def traced_batch(items):
            with ctx.tracer.span("batch_step"):
                timed_batch(items)
            rows = [pool_of.get(id(it.future)) for it in items]
            rows += [rows[-1]] * (b - len(rows))
            if None not in rows:
                batch_bytes.append((time.perf_counter(), int(per_frame[rows].sum())))

        server._run_batch = traced_batch
        ctx.tracer.warm(dev)
    ctx.mark("program")
    pick = np.sort(system.rng(ctx.seed, "sample").choice(
        n, size=min(n, int(p["check_requests"])), replace=False))
    keep, got = set(pick.tolist()), {}
    done = np.full(n, np.nan)
    answered = np.zeros(n, bool)
    sent = np.empty(n)

    def finish(i, fut):
        # runs where the Future resolves; holds no Future past that moment
        done[i] = time.perf_counter()
        if fut.exception() is None:
            answered[i] = True
            if i in keep:
                got[i] = fut.result()

    try:
        for _ in range(int(p["warm_batches"])):
            cf.wait([server.submit(depth[i % len(depth)], com[i % len(depth)])
                     for i in range(b)])
        ctx.window_opens()
        step_s.clear()
        stats0 = dict(server.stats)
        # host-clock readings of a traced run: from the profiler's stop
        ctx.tracer.on_stop.append(lambda: stats0.update(server.stats))
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent[i] = time.perf_counter()
            fut = server.submit(depth[which[i]], com[which[i]])
            if ctx.tracer.enabled:
                pool_of[id(fut)] = which[i]
            fut.add_done_callback(functools.partial(finish, i))
            ctx.tracer.poll()
        deadline = t0 + ctx.seconds + DRAIN_S
        while np.isnan(done).any() and time.perf_counter() < deadline:
            time.sleep(0.01)
        ctx.window_closed()
        ctx.tracer.stop()
        stats = {k: server.stats[k] - stats0[k] for k in stats0}
    finally:
        server.close()
    lat = np.where(np.isnan(done), time.perf_counter(), done) - (t0 + due)
    late = sent - (t0 + due)
    fifth = max(1, n // 5)
    spans = [s for s in ctx.tracer.spans.get("batch_step", [])
             if s[0] >= (ctx.tracer.stopped or t0)]
    ctx.values.update(server=stats, max_batch=b, batch_spans=spans,
                      flops_per_batch=forward_flops(spec["family"], weights, b))
    pick = np.array([i for i in pick if i in got], int)
    got = np.stack([got[i] for i in pick]) if len(pick) else None
    del server, est, net

    def check():
        if got is None:
            return {}
        ref = reference.joints(cfg, weights, comp, mean, depth[which[pick]], com[which[pick]],
                               dev)
        return {"joints_mm": float(np.abs(got - ref).max())}

    return {
        "metrics": {"serve_p95_ms": 1e3 * float(np.percentile(lat, 95))},
        "attempted": n,
        "failed": int(n - answered.sum()),
        "check": check,
        "notes": {"requests": n, "serve_p50_ms": 1e3 * float(np.percentile(lat, 50)),
                  "generator_late_p95_ms": 1e3 * float(np.percentile(late, 95)),
                  "generator_late_max_ms": 1e3 * float(late.max()),
                  "head_fifth_p50_ms": 1e3 * float(np.median(lat[:fifth])),
                  "tail_fifth_p50_ms": 1e3 * float(np.median(lat[-fifth:])),
                  "occupancy": stats["frames"] / max(1, stats["batches"] * b),
                  "batch_step_p50_ms": 1e3 * float(np.median(step_s)) if step_s else None,
                  "serve_p95_ms_by_fifth": [1e3 * float(np.percentile(q, 95))
                                            for q in np.array_split(lat, 5)]},
    }
