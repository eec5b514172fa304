"""Open-loop serving of V2V-PoseNet: single depth frames submitted to
``MicroBatchServer`` over ``FusedEstimator`` on a fixed arrival schedule,
as ``serve_open.py`` submits them to the PCA regressor, each frame's crop
voxelized and run through the 3D network on the device.

Parameters (the traffic mix, then the cell's file):
  rate_per_s      offered requests a second, at ``serve_open.arrivals``'s
                  uniform random times (a Poisson process given its count)
  max_batch, max_wait_ms   the server's batching
  pool_frames     distinct frames the requests are drawn from
  warm_batches    full batches served in set-up
  check_requests  answers compared with the plain reference
Every request carries the configuration's cube and no mirror.  A request's
latency runs from its due time to the moment its Future resolves.

Set-up: He-normal weights from the seed with zero biases; the estimator,
made before any frame is rendered (a program that refuses the family
fails here, in seconds); the frames; BatchNorm's running statistics, set
by the reference's training-mode passes over the pool's grids
(``reference/serve_v2v.py::calibrate``) and loaded into the program's
network; then the server, which captures its graph, and the warm batches.
The calibration stands in for a trained checkpoint and is the
reference's work, so its seconds are taken out of ``setup_s`` (the note
``setup_reference_s``).
After the window the server's own graph replays the checked requests'
frames, max_batch at a time, and its grids and heatmaps, with the joints
the server answered to those requests in the window, are compared with the
reference.  The per-layer readers get the server's counters, the batch
steps, the forward flops of the mean batch the device computed (a frame's
flops x the estimator's ``stats['rows']`` over the server's batches in the
window: padding counts, as computed work), K1's bytes a batch and the
estimator's voxel counters over the window.

Faults (the readings' planted ones): ``answer_altered`` adds 1 mm to every
answer; ``voxels_dropped`` clears every 97th voxel of each grid the
network is fed (about 1% of the hand's), inside the graph.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import time

import numpy as np
import torch

from bench_torch.lib import frames, system
from bench_torch.models.crop_bytes import crop_bytes_per_sample
from bench_torch.models.v2v_flops import forward_flops
from bench_torch.reference import serve_v2v as reference
from bench_torch.traffic.serve_open import DRAIN_S, arrivals


def run(ctx):
    from deepprior_tpu_torch.models.v2v import V2VConfig, V2VPoseNet
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    spec = cfg["model"]
    b, hw = int(p["max_batch"]), int(cfg["input_hw"])
    cam = system.program_camera(cfg)
    cube = tuple(float(c) for c in cfg["cube_mm"])

    def net_config(dtype):
        return V2VConfig(num_joints=cfg["num_joints"], grid=spec["grid"],
                         cube_voxels=spec["cube_voxels"], sigma=spec["sigma"], dtype=dtype)

    with torch.device("meta"):
        net = V2VPoseNet(net_config(system.compute_dtype(ctx.precision)))
    layout = net.state_dict()
    weights = system.draw_weights(layout, system.stream_seed(ctx.seed, "pose_net"), dev)
    net = net.to_empty(device=dev)
    net.load_state_dict(weights)
    # the family first: a program that does not serve it fails here
    est = FusedEstimator(net, cam, cube=cube, dsize=(hw, hw), device=dev)
    depth, com, _ = frames.render_pool(cfg, system.rng(ctx.seed, "frames"), int(p["pool_frames"]))
    due, which = arrivals(ctx.seed, float(p["rate_per_s"]), ctx.seconds, len(depth))
    n = len(due)
    ctx.mark("inputs")
    t = time.perf_counter()
    weights = reference.calibrate(cfg, weights, depth, com, dev)
    ctx.sync()
    calibrate_s = time.perf_counter() - t
    net.load_state_dict(weights)
    ctx.mark("calibrated")
    if ctx.fault == "voxels_dropped":
        inputs = net.inputs

        def dropped(*args, **kw):
            x = inputs(*args, **kw).flatten().clone()
            x[::97] = 0.0
            return x.view(-1, 1, *[spec["grid"]] * 3)

        net.inputs = dropped
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

    def readout(rows):
        """The server's graph (its eager call without one) on the pool frames
        ``rows``, at most max_batch, padded as the server pads: their grids
        (uint8) and heatmaps on the host."""
        k = len(rows)
        rows = np.concatenate([rows, np.repeat(rows[-1:], b - k)])
        d, c = torch.from_numpy(depth[rows]), torch.from_numpy(com[rows])
        with torch.inference_mode():
            if server.graph:
                cap = server._stage(tuple(d.shape[1:]))[0]
                cap.depth.copy_(d)
                cap.com.copy_(c)
                cap.cube.copy_(est.cube.expand(b, 3))
                cap.mirror.zero_()
                cap.graph.replay()
                out = cap.outputs
            else:
                out = est(d.to(dev), c.to(dev))
            return out[3][:k].to(torch.uint8).cpu(), out[4][:k].float().cpu()

    try:
        for _ in range(int(p["warm_batches"])):
            cf.wait([server.submit(depth[i % len(depth)], com[i % len(depth)])
                     for i in range(b)])
        ctx.sync()
        counted = {k: int(v) for k, v in est.stats.items()}
        ctx.window_opens()
        ctx.setup_s -= calibrate_s  # the reference's seconds, not the program's
        step_s.clear()
        stats0 = dict(server.stats)
        batches0 = server.stats["batches"]
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
        counts = {k: int(v) - counted[k] for k, v in est.stats.items()}
        batches = server.stats["batches"] - batches0
        pick = np.array([i for i in pick if i in got], int)
        rows = which[pick]
        outs = [readout(rows[s:s + b]) for s in range(0, len(rows), b)]
    finally:
        server.close()
    lat = np.where(np.isnan(done), time.perf_counter(), done) - (t0 + due)
    late = sent - (t0 + due)
    fifth = max(1, n // 5)
    spans = [s for s in ctx.tracer.spans.get("batch_step", [])
             if s[0] >= (ctx.tracer.stopped or t0)]
    ctx.values.update(server=stats, max_batch=b, batch_spans=spans,
                      flops_per_batch=forward_flops(layout, 1, spec["grid"])
                      * counts["rows"] / max(1, batches),
                      voxels_set=counts["voxels_set"], voxels_seen=counts["voxels_seen"])
    answers = np.stack([got[i] for i in pick]) if len(pick) else None
    grid = torch.cat([g for g, _ in outs]).numpy() if outs else None
    heat = torch.cat([h for _, h in outs]).numpy() if outs else None
    del server, est, net, outs

    def check():
        if answers is None:
            return {}
        return reference.readings(cfg, weights, depth[rows], com[rows], grid, heat, answers,
                                  10.0 * ctx.cell.limits["heatmap_rel"], dev)

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
                  "rows_computed": counts["rows"], "batches": batches,
                  "setup_reference_s": calibrate_s,
                  "batch_step_p50_ms": 1e3 * float(np.median(step_s)) if step_s else None,
                  "serve_p95_ms_by_fifth": [1e3 * float(np.percentile(q, 95))
                                            for q in np.array_split(lat, 5)]},
    }
