"""One depth camera in the reference's realtime loop: frames handed back to
back to ``RealtimeHandposePipeline.process_frame`` at batch 1 (a closed
loop: the next frame waits for the last one's joints), with full device
detection on every frame (tracking off, the pipeline's default state),
the ScaleNet CoM refinement, then the estimator.

Parameters (the traffic mix, then the cell's file):
  sequence_frames  rendered frames, cycled in order
  warm_frames      frames processed in set-up
  check_frames     processed frames compared with the plain reference
A frame in which no hand is found counts as failed.  A frame's latency
runs from handing it over to its joints on the host.
"""

from __future__ import annotations

import time

import numpy as np

from bench_torch.lib import frames, system
from bench_torch.models.flops import forward_flops
from bench_torch.reference import camera as reference


def run(ctx):
    from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.realtime.pipeline import RealtimeHandposePipeline

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    pose_spec, ref_spec = cfg["model"], cfg["refiner"]
    pose_w = system.net_weights(pose_spec, ctx.seed, "pose_net", dev)
    refine_w = system.net_weights(ref_spec, ctx.seed, "refiner_net", dev)
    comp, mean = system.pca_basis(cfg, ctx.seed, dev)
    seq, _, _ = frames.render_pool(cfg, system.rng(ctx.seed, "frames"), int(p["sequence_frames"]))
    cam = system.program_camera(cfg)
    cube = tuple(float(c) for c in cfg["cube_mm"])

    ctx.mark("inputs")
    net = system.program_net(pose_spec, pose_w, ctx.precision, dev)
    scale_net = system.program_net(ref_spec, refine_w, ctx.precision, dev)
    est = FusedEstimator(net, cam, cube=cube, prior=system.program_prior(comp, mean), device=dev)
    refiner = CNNComRefiner(scale_net, cam)
    seen = {}

    def recording_refiner(dpt, com, cb):
        seen["detected"] = com  # a fresh tensor each frame, made from the host's CoM
        return refiner(dpt, com, cb)

    pipe = RealtimeHandposePipeline(est, {"fx": cam.fx, "fy": cam.fy, "cube": cube},
                                    camera=cam, com_refiner=recording_refiner)
    if ctx.fault == "answer_altered":
        estimate = pipe.estimate_pose
        pipe.estimate_pose = lambda frame, com: estimate(frame, com) + 1.0
    if ctx.tracer.enabled:
        for name in ("detect", "estimate_pose"):
            inner = getattr(pipe, name)

            def traced(*a, _inner=inner, _name=name):
                with ctx.tracer.span(_name):
                    return _inner(*a)

            setattr(pipe, name, traced)
        ctx.tracer.warm(dev)
    ctx.mark("program")
    for i in range(int(p["warm_frames"])):
        pipe.process_frame(seq[i % len(seq)])

    lat, starts, detect_s, pose_s, rows = [], [], [], [], []
    failed = 0
    ctx.window_opens()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        seen.clear()
        frame = seq[i % len(seq)]
        t = time.perf_counter()
        out = pipe.process_frame(frame)
        lat.append(time.perf_counter() - t)
        starts.append(t)
        detect_s.append(pipe.times["detect"])
        pose_s.append(None if out is None else pipe.times["pose"])
        if out is None:
            failed += 1
            rows.append((i % len(seq), None, None, None))
        else:
            rows.append((i % len(seq), seen.get("detected"), out["com"], out["joints3d"]))
        i += 1
        ctx.tracer.poll()
    t_end = time.perf_counter()
    window_s = t_end - t0
    ctx.window_closed()
    ctx.tracer.stop()
    # host-clock readings: the untraced rest of a traced window
    host, host_s = ctx.tracer.after_stop(starts, t_end)
    first = len(starts) - len(host)
    ctx.values.update(detect_s=detect_s[first:],
                      pose_s=[t for t in pose_s[first:] if t is not None],
                      frames=len(host), window_s=host_s or window_s,
                      flops_per_frame=forward_flops(ref_spec["family"], refine_w, 1)
                      + forward_flops(pose_spec["family"], pose_w, 1))
    pick = np.sort(system.rng(ctx.seed, "sample").choice(
        len(rows), size=min(len(rows), int(p["check_frames"])), replace=False))
    got = [rows[k] for k in pick]
    got = [(j, None if d is None else d.cpu().numpy()[0], c, q) for j, d, c, q in got]
    del pipe, est, refiner, net, scale_net, seen

    def check():
        errs = {"com_detect_px_mm": 0.0, "com_refined_px_mm": 0.0, "joints_mm": 0.0}
        for j, det, com, joints in got:
            r_det, r_com, r_joints = reference.frame_outputs(cfg, pose_w, refine_w, comp, mean,
                                                             seq[j], dev)
            if (det is None) != (r_com is None):
                return {k: float("inf") for k in errs}
            if det is None:
                continue
            errs["com_detect_px_mm"] = max(errs["com_detect_px_mm"], float(np.abs(det - r_det).max()))
            errs["com_refined_px_mm"] = max(errs["com_refined_px_mm"], float(np.abs(com - r_com).max()))
            errs["joints_mm"] = max(errs["joints_mm"], float(np.abs(joints - r_joints).max()))
        return errs

    lat = np.asarray(lat)
    return {"metrics": {"camera_frame_p95_ms": 1e3 * float(np.percentile(lat, 95))},
            "attempted": i, "failed": failed, "check": check,
            "notes": {"frames": i, "camera_frame_p50_ms": 1e3 * float(np.percentile(lat, 50)),
                      "fps": i / window_s,
                      "frames_by_second": np.bincount(
                          (np.asarray(starts) - t0).astype(int)).tolist()}}
