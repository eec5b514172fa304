"""Smoke run of the PyTorch port (deepprior_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from deepprior_tpu_torch/csrc/ (crop.cu: the
nearest crop K1 and the cv2-linear crop K2; warp.cu: the augmentation
warps K4 and K5; probes.cu: the band-read probes K6a-c and the general
warp K7) and holds each bit for bit against its plain PyTorch version
(the crops K1/K2 compute their geometry and M in the kernel: crops and M
are held to the plain crop).  Then it drives the main paths: serving
(FusedEstimator with a full-width PoseRegNet, then MicroBatchServer; phase
6 counts the crop wrapper's device operations per estimator call with
torch.profiler and fails above 5) at B = 512 NYU frames,
training (the port's main_nyu_posereg_embedding: 12 steps at B = 128
through K4, then an epoch through K5) with a training step on the card
against the CPU, and realtime serving (phases 12-15: the 'linear'
estimator through K2 at B = 512, detection and CoM refinement on the card
at B = 64, the RealtimeHandposePipeline with a full-width ScaleNet CoM
refiner over a synthetic camera, and the demo main; phase 16 times
them).  Phases 17-18 drive the measuring path, the probe scripts
deepprior_tpu_torch.prof.prof_bench (K6) and prof_warp_bf16 (K7), then
hold each probe against its plain version and its library call (K6 in
turns with its call) and time K7 in turns with K4; phase 19 times K1, K2,
K4 and K5 alone against their bounds from the byte models, with their
launches per estimator call and train step; phase 20 runs the profiling
helpers on the estimator at B = 1 (dispatch included, and its CUDA graph:
the device floor) and holds a replayed CUDA graph of the estimator to the
eager call bit for bit.  Every phase
raises on failure, so the exit code is 0 only when all passed.  The last
line is {"ok": true, "device": {...}}; the line before it carries each
kernel's launches, error, times and bound as JSON.

--profile adds phase 11: torch.profiler over the train step and its
stages (augment via K4, forward + backward, optimizer) at B = 128 and 512,
printing host ms, device busy ms, busy share and launches per call, and
the kernels that take the most device time and the most launches.

Needs one CUDA card; without one it exits non-zero before any result.
Imports nothing of jax or of the JAX package.
"""

import argparse
import copy
import json
import math
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around iters calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def is_device_op(event):
    """A profiler event that is a kernel, copy or memset on the card.  The
    device-side copies of user annotations (Optimizer.step#...) span other
    kernels and are left out; PyTorch's elementwise kernels carry '#' too
    ({lambda()#1}), but inside a parenthesised signature."""
    import torch

    name = event.name
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not ("#" in name and "(" not in name))


def profile_stage(label, fn, iters, log):
    """torch.profiler over iters calls of fn() after 3 warm-up calls.

    Logs the host ms per call (the profiler inflates it), the device busy
    ms per call (the union of the intervals of the kernels and copies on
    the card, so that nothing counts twice), its share of the host time,
    the launches per call, and the kernels that take the most device time
    and the most launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
    evs = [e for e in prof.events() if is_device_op(e)]
    busy_us, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 / iters
    by = {}
    for e in evs:
        c, t = by.get(e.name, (0, 0.0))
        by[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    log(f"[11 profile] {label}: host {host_ms:.4f} ms/call (profiled), device "
        f"busy {busy_ms:.4f} ms/call, busy share {busy_ms / host_ms:.3f}, "
        f"launches/call {len(evs) / iters:.1f}")
    for key, what in ((lambda kv: -kv[1][1], "time"), (lambda kv: -kv[1][0], "launches")):
        for name, (c, t) in sorted(by.items(), key=key)[:8]:
            log(f"    by {what}: {t / iters:.4f} ms/call x{c / iters:.1f} {name[:100]}")


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the train step and its stages (phase 11)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; this script "
            "runs the port on a CUDA card and has no CPU fallback"
        )

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops import hopper_crop, hopper_probes, hopper_warp
    from deepprior_tpu_torch.ops._build import BUILD_LOG
    from deepprior_tpu_torch.ops.crop import clamp_depth, normalized_crop
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    # ---------------------------------------------------------------- 1
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    log(f"[1 device] {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    log(card)

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    builds = (hopper_crop.build, hopper_warp.build, hopper_probes.build)
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, in parallel
        for fut in [pool.submit(b) for b in builds]:
            fut.result()
    build_s = time.perf_counter() - t0
    for src in ("crop.cu", "warp.cu", "probes.cu"):
        ptxas = [ln.strip() for ln in BUILD_LOG.get(src, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[2 build] {src} built and loaded ({build_s:.3f} s for all) "
            f"({'cached' if not ptxas else '; '.join(ptxas)})")

    # ---------------------------------------------------------------- 3
    rng = np.random.default_rng(23455)
    max_err = 0.0
    cases = []

    def frames(cam, n):
        pairs = [make_depth_frame(cam, rng) for _ in range(n)]
        depth = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
        com = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
        return depth, com

    def check(label, cam, raw, com, cube, fuse_clamp, zero_one=False, **knobs):
        """Kernel vs plain on identical GPU inputs; bit-exact."""
        nonlocal max_err
        got, m_got = hopper_crop.hopper_normalized_crop(
            raw, com, cube, cam.fx, cam.fy, norm_zero_one=zero_one,
            fuse_clamp=fuse_clamp, **knobs,
        )
        src = clamp_depth(raw)[0] if fuse_clamp else raw
        want, m_want = normalized_crop(src, com, cube, cam.fx, cam.fy,
                                       norm_zero_one=zero_one)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not (torch.equal(got, want) and torch.equal(m_got, m_want)):
            bad = int((got != want).sum())
            raise AssertionError(
                f"{label}: kernel != plain on {bad} pixels, max |d| {err}")
        cases.append(label)
        return got

    cam = NYU_CAMERA
    raw, com = frames(cam, 64)
    cube = (250.0, 250.0, 250.0)
    clamped = clamp_depth(raw)[0]
    ref = check("nyu64 clamped", cam, clamped, com, cube, fuse_clamp=False)
    noisy = raw.clone()
    mask = torch.rand(noisy.shape, generator=torch.Generator(dev).manual_seed(5),
                      device=dev) < 0.01
    noisy[mask] = 1600.0 + 900.0 * torch.rand(int(mask.sum()), device=dev)
    check("nyu64 1% at 1600-2500 mm, fuse_clamp", cam, noisy, com, cube, True)
    check("nyu64 raw, fuse_clamp", cam, raw, com, cube, True)
    check("cube 900", cam, raw, com, (900.0,) * 3, True)
    per_sample = torch.from_numpy(
        rng.uniform(150.0, 450.0, (64, 3)).astype(np.float32)).to(dev)
    check("per-sample cube", cam, raw, com, per_sample, True)
    com_d0 = com.clone()
    com_d0[::4, 2] = 0.0
    check("d = 0 centred fallback", cam, raw, com_d0, cube, True)
    com_b = com.clone()
    edge = torch.from_numpy(rng.uniform(0.0, 20.0, 64).astype(np.float32)).to(dev)
    com_b[0::4, 0] = edge[0::4]                       # left
    com_b[1::4, 0] = cam.width - 1 - edge[1::4]       # right
    com_b[2::4, 1] = edge[2::4]                       # top
    com_b[3::4, 1] = cam.height - 1 - edge[3::4]      # bottom
    check("CoMs within 20 px of each border", cam, raw, com_b, cube, True)
    check("norm_zero_one", cam, raw, com, cube, True, zero_one=True)
    icvl, com_i = frames(ICVL_CAMERA, 32)
    check("icvl32 320x240", ICVL_CAMERA, icvl, com_i, cube, True)
    check("icvl32 norm_zero_one", ICVL_CAMERA, icvl, com_i, cube, True,
          zero_one=True)
    knobbed = check("block_k/win_rows/win_cols", cam, clamped, com, cube, False,
                    win_rows=304, win_cols=640, block_k=4)
    if not torch.equal(knobbed, ref):
        raise AssertionError("block_k/win_rows/win_cols changed the output")
    log(f"[3 kernel vs plain] {len(cases)} cases bit-exact (torch.equal), "
        f"max |kernel - plain| = {max_err}")

    # ---------------------------------------------------------------- 4
    batch, n_unique = 512, 16
    model = PoseRegNet(
        PoseRegNetConfig(num_joints=1, n_dims=30, hidden=1024,
                         dtype=torch.bfloat16),
        generator=torch.Generator().manual_seed(0),
    )
    prior = PCAPrior(rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
                     np.zeros(42, np.float32))
    est = FusedEstimator(model, cam, prior=prior, crop_method="auto", device=dev)
    plain_est = FusedEstimator(model, cam, prior=prior, crop_method="gather",
                               device=dev)
    if est.crop_method != "hopper":
        raise AssertionError(f"'auto' chose {est.crop_method!r} on {dev}")
    depth_u, com_u = frames(cam, n_unique)
    depth_d = depth_u.repeat(batch // n_unique, 1, 1)
    com_d = com_u.repeat(batch // n_unique, 1)
    cube_d = torch.from_numpy(
        rng.uniform(200.0, 350.0, (batch, 1)).repeat(3, 1).astype(np.float32)
    ).to(dev)
    mirror = torch.arange(batch, device=dev) % 2 == 0
    calls = (dict(), dict(cube=cube_d, mirror=mirror, invx=True))

    hopper_crop.LAUNCHES.update(normalized_crop=0, normalized_crop_linear=0)
    outs = [est(depth_d, com_d, **kw) for kw in calls]
    torch.cuda.synchronize()
    launches = hopper_crop.LAUNCHES["normalized_crop"]
    if dict(hopper_crop.LAUNCHES) != {"normalized_crop": len(calls),
                                      "normalized_crop_linear": 0}:
        raise AssertionError(f"main path launched {hopper_crop.LAUNCHES}")

    for kw, (joints, com3d, crops) in zip(calls, outs):
        pj, pc3, pcr = plain_est(depth_d, com_d, **kw)
        if joints.shape != (batch, 14, 3) or not torch.isfinite(joints).all():
            raise AssertionError(f"joints {tuple(joints.shape)} not finite/shaped")
        max_err = max(max_err, (crops - pcr).abs().max().item())
        if not torch.equal(crops, pcr):
            raise AssertionError("estimator crops: kernel != plain gather")
        jerr = (joints - pj).abs().max().item()
        if jerr > 1e-3:
            raise AssertionError(f"joints differ from the plain path by {jerr} mm")
    # a small input against the CPU: the crops bit-exact, the bf16 model
    # against float32 weights on the CPU within 5% of the pose's extent
    cpu_model = PoseRegNet(model.cfg._replace(dtype=torch.float32))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_est = FusedEstimator(cpu_model, cam, prior=prior, device="cpu")
    cj, cc3, ccr = cpu_est(depth_u.cpu(), com_u.cpu())
    gj, gc3, gcr = (t[:n_unique].cpu() for t in outs[0])
    if not torch.equal(gcr, ccr):
        raise AssertionError("GPU crops differ from the CPU crops")
    rel_gpu, rel_cpu = gj - gc3[:, None], cj - cc3[:, None]
    dev_mm = (rel_gpu - rel_cpu).abs().max().item()
    extent = rel_cpu.abs().max().item()
    if dev_mm > 0.05 * extent + 0.5:
        raise AssertionError(f"bf16 GPU pose vs float32 CPU: {dev_mm} mm "
                             f"(pose extent {extent} mm)")
    log(f"[4 main path] B={batch} NYU 640x480, PoseRegNet hidden=1024 bf16, "
        f"PCA (30, 42): kernel launches {launches}, joints finite, crops "
        f"== plain gather, joints |d| <= 1e-3 mm; bf16 GPU vs f32 CPU "
        f"relative pose max |d| {dev_mm:.4f} mm (extent {extent:.2f} mm)")

    # ---------------------------------------------------------------- 5
    depth_np, com_np = depth_u.cpu().numpy(), com_u.cpu().numpy()
    n_req, n_threads, max_batch = 128, 4, 64

    def request(i):
        cube_i = np.full(3, 300.0, np.float32) if i % 3 == 0 else None
        return depth_np[i % n_unique], com_np[i % n_unique], cube_i, i % 4 == 1

    def serve(srv, n):
        futs = [None] * n

        def worker(t):
            for i in range(t, n, n_threads):
                d, c, cb, mr = request(i)
                futs[i] = srv.submit(d, c, cube=cb, mirror=mr)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            if th.is_alive():
                raise AssertionError("a submitting thread hung")
        return np.stack([f.result(timeout=300) for f in futs])

    with MicroBatchServer(est, max_batch=max_batch, max_wait_ms=2) as srv:
        got = serve(srv, n_req)
        stats, occ = dict(srv.stats), srv.occupancy()
    if stats["frames"] != n_req or stats["errors"]:
        raise AssertionError(f"server stats {stats}")
    want = []
    for s in range(0, n_req, max_batch):  # direct calls at the server's shape
        reqs = [request(i) for i in range(s, s + max_batch)]
        j, _, _ = est(
            np.stack([r[0] for r in reqs]), np.stack([r[1] for r in reqs]),
            cube=np.stack([r[2] if r[2] is not None else np.full(3, 250.0, np.float32)
                           for r in reqs]),
            mirror=np.array([r[3] for r in reqs]),
        )
        want.append(j.cpu().numpy())
    serr = float(np.abs(got - np.concatenate(want)).max())
    if serr > 1e-3:
        raise AssertionError(f"server results differ from direct calls by {serr} mm")
    log(f"[5 server] {n_req} requests from {n_threads} threads: stats {stats}, "
        f"occupancy {occ:.3f}, max |server - direct| {serr} mm")

    # ---------------------------------------------------------------- 6
    cube_b = est.cube.expand(batch, 3)  # the cube as the estimator passes it

    def kernel_crop():
        return hopper_crop.hopper_normalized_crop(
            depth_d, com_d, cube_b, cam.fx, cam.fy, fuse_clamp=True)

    def plain_crop():
        return normalized_crop(clamp_depth(depth_d)[0], com_d, cube, cam.fx, cam.fy)

    # the crop wrapper's device operations per nearest estimator call, and
    # the whole call's, counted by torch.profiler over one call
    wrapper_ops = device_ops(kernel_crop)
    est_ops = device_ops(lambda: est(depth_d, com_d))
    n_kernel = sum("normalized_crop_kernel" in op for op in wrapper_ops)
    if len(wrapper_ops) > 5 or n_kernel != 1:
        raise AssertionError(f"crop wrapper launched {len(wrapper_ops)} device "
                             f"operations (kernel {n_kernel}x): {wrapper_ops}")
    kinds = Counter(op.removeprefix("void ")[:40] for op in est_ops)
    log(f"[6 launches] crop wrapper (nearest, fused clamp) per estimator call: "
        f"{len(wrapper_ops)} device operations ({'; '.join(op[:48] for op in wrapper_ops)}); "
        f"the whole estimator call: {len(est_ops)} ("
        + "; ".join(f"{n}x {k}" for k, n in kinds.most_common(8)) + ")")
    # alternate plain, kernel, kernel, plain within this one call
    t_plain, t_kernel = [], []
    for fn, acc in ((plain_crop, t_plain), (kernel_crop, t_kernel),
                    (kernel_crop, t_kernel), (plain_crop, t_plain)):
        acc.append(time_ms(fn, iters=20))
    ms, plain_ms = float(np.mean(t_kernel)), float(np.mean(t_plain))
    # the kernel alone, its geometry included, from a CUDA graph; then the
    # launch's arguments alone (the clamp limits and the output buffers)
    launch_args = hopper_crop.crop_args(depth_d, com_d, cube_b, cam.fx, cam.fy, fuse_clamp=True)
    launch_ms = graph_ms(lambda: hopper_crop.launch_crop(depth_d, launch_args), iters=50)
    args_ms = time_ms(lambda: hopper_crop.crop_args(
        depth_d, com_d, cube_b, cam.fx, cam.fy, fuse_clamp=True), iters=50)
    crops = kernel_crop()[0]
    with torch.inference_mode():
        model_ms = time_ms(lambda: est.model(crops[:, None]), iters=20)
        est_ms = time_ms(lambda: est(depth_d, com_d), iters=20)
    fps = batch / (est_ms / 1e3)
    d1, c1 = depth_d[:1].contiguous(), com_d[:1].contiguous()
    lat = []
    for _ in range(23):  # host clock around synchronised batch-1 calls
        t0 = time.perf_counter()
        est(d1, c1)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    b1_ms = float(np.median(lat[3:]))
    log(f"[6 timing] {tag} B={batch} NYU: crop kernel path {ms:.4f} ms "
        f"(runs {', '.join(f'{t:.4f}' for t in t_kernel)}): args (clamp limits, "
        f"outputs) {args_ms:.4f} ms, kernel alone with its geometry {launch_ms:.4f} ms "
        f"(CUDA graph); plain clamp+crop "
        f"{plain_ms:.4f} ms (runs {', '.join(f'{t:.4f}' for t in t_plain)}); "
        f"PoseRegNet bf16 {model_ms:.4f} ms; estimator {est_ms:.4f} ms/batch "
        f"= {fps:.1f} frames/s; batch-1 call {b1_ms:.4f} ms (median of 20)")

    n_load = 2048
    with MicroBatchServer(est, max_batch=max_batch, max_wait_ms=2) as srv:
        serve(srv, 64)  # warm
        t0 = time.perf_counter()
        serve(srv, n_load)
        wall = time.perf_counter() - t0
        occ = srv.occupancy()
    log(f"[6 timing] {tag} server: {n_load} requests from {n_threads} threads "
        f"in {wall:.3f} s = {n_load / wall:.1f} requests/s (occupancy {occ:.3f})")

    kernels = [{
        "name": "normalized_crop",
        "route": "cuda",
        "source": "deepprior_tpu_torch/csrc/crop.cu",
        "replaces": "deepprior_tpu/ops/pallas_crop.py:417",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "kernel_only_ms": launch_ms,
        "wrapper_device_ops_per_call": len(wrapper_ops),
    }]
    kernels += training_phases(dev, tag, log, profile=args.profile)
    kernels.insert(1, realtime_phases(dev, tag, log, model, prior))
    kernels += probe_phases(dev, tag, log)
    roofline_phases(dev, tag, log, model, prior, kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


def alternate(plain_fn, kernel_fn, iters, timer=time_ms):
    """Mean ms of each, timed in the order plain, kernel, kernel, plain."""
    t_plain, t_kernel = [], []
    for fn, acc in ((plain_fn, t_plain), (kernel_fn, t_kernel),
                    (kernel_fn, t_kernel), (plain_fn, t_plain)):
        acc.append(timer(fn, iters=iters))
    return float(np.mean(t_plain)), float(np.mean(t_kernel))


def device_ops(fn):
    """The names of the device operations (kernels, copies, memsets) of one
    fn() call, from torch.profiler, after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if is_device_op(e)]


def graph_outputs(fn):
    """fn()'s outputs from one replay of a CUDA graph that captured one
    fn() call (warmed up on a side stream first, as capture requires)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    out = [t.clone() for t in out]  # out of the graph's memory pool
    torch.cuda.synchronize()
    return out


def graph_ms(fn, iters):
    """Device ms of one fn() from a CUDA graph of iters calls: no host
    enqueue between the launches, so a kernel shorter than its Python
    wrapper's dispatch is timed by the card and not by the host."""
    import torch

    from deepprior_tpu_torch.utils.profiling import device_loop_latency

    return device_loop_latency(lambda c: (fn(), c)[1],
                               torch.zeros(1, device="cuda"), iters=iters)


def training_phases(dev, tag, log, profile=False):
    """Phases 7-10: the warp kernels K4 and K5 against their plain
    versions, the training main path, a training step on the card against
    the CPU, and the training timings; with ``profile``, phase 11.  Returns
    the kernels' JSON records."""
    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.geometry import rotation_matrix_2d
    from deepprior_tpu_torch.mains import main_nyu_posereg_embedding
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import (
        NV_VAL, augment_batch, augment_geometry, sample_augment_params)
    from deepprior_tpu_torch.ops.crop import com_to_bounds
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    cam = NYU_CAMERA
    modes = ("com", "rot", "sc", "none")
    gen = torch.Generator(dev).manual_seed(11)

    # ---------------------------------------------------------------- 7
    seq = make_sequence(cam, 128, seed=5)
    host = {z1: TrainData.from_sequence(seq, norm_zero_one=z1) for z1 in (False, True)}
    data = {z1: d.to(dev) for z1, d in host.items()}
    b = data[False].n
    mm = torch.from_numpy(np.stack([f.dpt for f in seq.data])).to(dev)
    err = {"warp_patch": 0.0, "warp_norm": 0.0}
    cases = []

    def check4(label, patch, m_fwd, nv=NV_VAL, **knobs):
        got = hw.hopper_warp_patch(patch, m_fwd, nv_val=nv, **knobs)
        want = hw.warp_patch_plain(patch, hw.warp_patch_params(m_fwd), 0.0, nv)
        torch.cuda.synchronize()
        err["warp_patch"] = max(err["warp_patch"], (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {label}: kernel != plain on "
                                 f"{int((got != want).sum())} pixels")
        cases.append(f"K4 {label}")
        return got

    eye = torch.eye(3, device=dev).expand(b, 3, 3).contiguous()
    if not torch.equal(check4("identity", mm, eye, nv=None), mm):
        raise AssertionError("K4 identity changed its input")
    scale = torch.rand(b, generator=gen, device=dev) * 0.2 + 0.9
    shift = (torch.rand((b, 2), generator=gen, device=dev) - 0.5) * 10.0
    sep = eye.clone()
    sep[:, 0, 0] = sep[:, 1, 1] = scale
    sep[:, :2, 2] = shift
    check4("separable scale + translate", mm, sep)
    ang = (torch.rand(b, generator=gen, device=dev) - 0.5) * 360.0
    ang[:4] = torch.tensor([90.0, 180.0, -90.0, 270.0], device=dev)
    center = torch.tensor([64.0, 64.0], device=dev).expand(b, 2)
    check4("rotations incl. 90/180 deg", mm, rotation_matrix_2d(center, ang))
    far = eye.clone()
    far[:, 0, 2] = 500.0
    if check4("out of frame", mm, far).abs().max().item() != 0.0:
        raise AssertionError("K4 out of frame: not all border")
    nv = mm.clone()
    nv[torch.rand(nv.shape, generator=gen, device=dev) < 0.01] = NV_VAL
    got = check4("NV markers", nv, rotation_matrix_2d(center, ang))
    if (got == NV_VAL).any():
        raise AssertionError("K4 let an NV marker through")
    params = sample_augment_params(gen, b, len(modes))
    for z1 in (False, True):
        d = data[z1]
        geo = augment_geometry(params, d.com, d.cube, d.m, cam, modes, (128, 128), z1)
        img, premax = hw.unnormalize(d.crops, geo.norm)
        ref = check4(f"B={b} synthetic crops, augment modes {'/'.join(modes)}, "
                     f"norm_zero_one={z1}", img, geo.a_fwd)
        if not torch.equal(hw.hopper_warp_patch(img, geo.a_fwd, nv_val=NV_VAL,
                                                block_k=4), ref):
            raise AssertionError("block_k=4 changed K4's output")
        k5_params = hw.warp_norm_params(geo.a_fwd, geo.norm)
        got = hw.warp(d.crops, k5_params, 0.0, NV_VAL, fused=True)
        want = hw.warp_norm_plain(d.crops, k5_params, 0.0, NV_VAL)
        unfused = hw.warp_norm_epilogue(ref, premax, geo.norm)
        torch.cuda.synchronize()
        err["warp_norm"] = max(err["warp_norm"], (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"K5 norm_zero_one={z1}: kernel != plain on "
                                 f"{int((got != want).sum())} pixels")
        cases.append(f"K5 norm_zero_one={z1}")
        n_diff = int((got != unfused).sum())
        log(f"[7 warp kernels] K5 vs the unfused pipeline with K4, "
            f"norm_zero_one={z1}: {n_diff} of {got.numel()} pixels differ")
        if n_diff > 1e-4 * got.numel():
            raise AssertionError(f"K5 differs from the unfused pipeline on {n_diff} pixels")
    log(f"[7 warp kernels] {len(cases)} cases bit-exact (torch.equal): "
        f"{'; '.join(cases)}; max |kernel - plain| K4 {err['warp_patch']}, "
        f"K5 {err['warp_norm']}")

    # ---------------------------------------------------------------- 8
    def train_main(extra, epochs):
        """The port's flagship entry point, as a user runs it."""
        hw.LAUNCHES.update(warp_patch=0, warp_norm=0)
        t0 = time.perf_counter()
        _, results, hist = main_nyu_posereg_embedding.main([
            "--synthetic", "--epochs", str(epochs), "--batch-size", "128",
            "--nmax", "512", "--out", "eval/chip_smoke", "--device",
            str(dev)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(hw.LAUNCHES)
        costs = np.asarray(hist["train_cost"])
        if costs.shape != (4 * epochs,) or not np.isfinite(costs).all():
            raise AssertionError(f"training costs {costs}")
        for name, hpe in results.items():
            if not (np.isfinite(hpe.getMeanError()) and np.isfinite(hpe.getMaxError())):
                raise AssertionError(f"{name}: non-finite test error")
        return counts, costs, results, wall

    counts, costs, results, wall = train_main([], 3)
    steps = costs.size
    if counts != {"warp_patch": steps, "warp_norm": 0}:
        raise AssertionError(f"12 unfused steps launched {counts}")
    k4_launches = counts["warp_patch"]
    log(f"[8 train main] main_nyu_posereg_embedding, synthetic NYU 640x480, nmax 512, "
        f"B=128, {steps} steps, PoseRegNet hidden 1024 f32 + dropout, PCA 30 of "
        f"50k sampled poses, reference ADAM, aug com/rot/none: launches {counts}, "
        f"costs {costs[0]:.4f} -> {costs[-1]:.4f} (all finite), "
        + ", ".join(f"{k} mean {v.getMeanError():.3f} mm max {v.getMaxError():.3f} mm"
                    for k, v in results.items())
        + f"; {wall:.1f} s with data and prior")
    counts, costs, results, wall = train_main(["--aug-fuse-norm"], 1)
    if counts != {"warp_patch": 0, "warp_norm": costs.size}:
        raise AssertionError(f"fused epoch launched {counts}")
    k5_launches = counts["warp_norm"]
    log(f"[8 train main] one epoch with --aug-fuse-norm: launches {counts}, "
        f"costs {', '.join(f'{c:.4f}' for c in costs)}")

    # ---------------------------------------------------------------- 9
    d = host[False]
    pri = fit_pose_prior(cam, np.random.default_rng(0), d.gt3d_crop, d.com,
                         d.cube, num_poses=5000)
    net_cfg = PoseRegNetConfig(num_joints=1, n_dims=30, hidden=1024, dropout=False)
    sd = PoseRegNet(net_cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    cfg = TrainConfig(batch_size=b, aug_modes=modes, model_has_dropout=False)
    cpu_params = sample_augment_params(torch.Generator().manual_seed(9), b, len(modes))
    dev_params = [t.to(dev) for t in cpu_params]
    out = {}
    for where, prm in (("cpu", cpu_params), (dev, dev_params)):
        tr = Trainer(PoseRegNet(net_cfg), cfg, cam, prior=pri, device=where)
        st = tr.init_state(state_dict=sd)
        batch = d.to(where).take(torch.arange(b, device=where))
        crops = augment_batch(None, batch["crops"], batch["gt3d_crop"], batch["com"],
                              batch["cube"], batch["m"], cam, aug_modes=modes,
                              use_pallas=True, params=prm)[0]
        losses = []
        for _ in range(2):  # the second loss sees the first update
            st, loss = tr._train_step_core(st, batch, prm, None, 1e-4)
            losses.append(float(loss))
        out[str(where)] = (crops.cpu(), losses)
    (c_cpu, l_cpu), (c_dev, l_dev) = out["cpu"], out[str(dev)]
    frac = float((c_cpu != c_dev).float().mean())
    rel = max(abs(a - c) / abs(c) for a, c in zip(l_dev, l_cpu))
    if frac >= 1e-4 or rel > 1e-3:
        raise AssertionError(f"card vs CPU: crops differ on {frac} of pixels, "
                             f"losses {l_dev} vs {l_cpu}")
    log(f"[9 card vs cpu] B={b}, hidden 1024, no dropout, same weights and aug "
        f"draws: crops differ on {frac} of pixels (kernel vs plain K4); losses "
        f"card {l_dev} cpu {l_cpu}, max rel |d| {rel:.2e}")

    # --------------------------------------------------------------- 10
    timings = {}
    for bsz in (128, 512):
        rep = bsz // b
        dd = TrainData(*(t.repeat((rep,) + (1,) * (t.dim() - 1)) for t in data[False]))
        tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=1024)),
                     TrainConfig(batch_size=bsz), cam, prior=pri, device=dev)
        st = tr.init_state()
        idx = torch.randperm(dd.n, generator=gen, device=dev)[:bsz]
        batch = dd.take(idx)
        aug_gen = torch.Generator(dev).manual_seed(1)
        drop_gen = torch.Generator(dev).manual_seed(2)
        aug = lambda **kw: augment_batch(  # noqa: E731
            aug_gen, batch["crops"], batch["gt3d_crop"], batch["com"], batch["cube"],
            batch["m"], cam, **kw)
        step_ms = time_ms(lambda: tr._train_step_core(st, dd.take(idx), aug_gen,
                                                      drop_gen, 1e-4), iters=20)
        aug_plain, aug_k4 = alternate(lambda: aug(use_pallas=False),
                                      lambda: aug(use_pallas=True), 20)
        geo = augment_geometry(sample_augment_params(gen, bsz, 3), batch["com"],
                               batch["cube"], batch["m"], cam, ("com", "rot", "none"),
                               (128, 128))
        img, _ = hw.unnormalize(batch["crops"], geo.norm)
        p6 = hw.warp_patch_params(geo.a_fwd)
        k5_params = hw.warp_norm_params(geo.a_fwd, geo.norm)
        k4_plain, k4 = alternate(lambda: hw.warp_patch_plain(img, p6, 0.0, NV_VAL),
                                 lambda: hw.launch_warp(img, p6, 0.0, NV_VAL), 50)
        wrap_plain, wrap_k4 = alternate(
            lambda: hw.warp_patch_plain(img, hw.warp_patch_params(geo.a_fwd), 0.0, NV_VAL),
            lambda: hw.hopper_warp_patch(img, geo.a_fwd, nv_val=NV_VAL), 50)
        k5_plain, k5 = alternate(
            lambda: hw.warp_norm_plain(batch["crops"], k5_params, 0.0, NV_VAL),
            lambda: hw.launch_warp(batch["crops"], k5_params, 0.0, NV_VAL, fused=True),
            50)
        # K5's wrapper from the per-sample scalars, as augment_batch has them
        _, _, _, _, zs, ze = com_to_bounds(geo.new_com, batch["cube"], cam.fx,
                                           cam.fy, (cam.height, cam.width))
        norm_args = (geo.a_fwd, batch["com"][:, 2], batch["cube"][:, 2],
                     geo.is_mode["com"] | geo.is_mode["sc"], zs, ze,
                     geo.new_com[:, 2], geo.new_cube[:, 2])
        wrap5_plain, wrap_k5 = alternate(
            lambda: hw.warp_norm_plain(
                batch["crops"],
                hw.warp_norm_params(geo.a_fwd, hw.norm_params(*norm_args[1:])),
                0.0, NV_VAL),
            lambda: hw.hopper_warp_norm(batch["crops"], *norm_args, nv_val=NV_VAL), 50)
        crops, labels = aug()[:2]
        y = tr._targets(labels)
        model, opt = st.model, st.optimizer
        model.train()

        def fwd_bwd():
            opt.zero_grad(set_to_none=True)
            loss = torch.sum(torch.square(model(crops[:, None], generator=drop_gen) - y),
                             dim=1).mean()
            loss.backward()

        fb_ms = time_ms(fwd_bwd, iters=20)
        opt_ms = time_ms(opt.step, iters=20)
        timings[bsz] = dict(wrap_k4=wrap_k4, wrap_plain=wrap_plain, k4=k4,
                            wrap_k5=wrap_k5, wrap5_plain=wrap5_plain, k5=k5)
        log(f"[10 timing] {tag} train step B={bsz}: {step_ms:.4f} ms = "
            f"{bsz / (step_ms / 1e3):.1f} samples/s; augment via K4 {aug_k4:.4f} ms "
            f"vs via the gather warp {aug_plain:.4f} ms; K4 alone {k4:.4f} ms vs "
            f"plain K4 {k4_plain:.4f} ms (with params: {wrap_k4:.4f} vs "
            f"{wrap_plain:.4f} ms); K5 alone {k5:.4f} ms vs plain unfused "
            f"{k5_plain:.4f} ms (with params: {wrap_k5:.4f} vs {wrap5_plain:.4f} "
            f"ms); forward + backward {fb_ms:.4f} ms; optimizer "
            f"{opt_ms:.4f} ms")
        if profile:
            for label, fn in (
                    ("train step", lambda: tr._train_step_core(
                        st, dd.take(idx), aug_gen, drop_gen, 1e-4)),
                    ("augment via K4", lambda: aug(use_pallas=True)),
                    ("forward + backward", fwd_bwd),
                    ("optimizer", opt.step)):
                profile_stage(f"{tag} {label} B={bsz}", fn, 10, log)

    t = timings[128]
    return [
        {"name": "warp_patch", "route": "cuda",
         "source": "deepprior_tpu_torch/csrc/warp.cu",
         "replaces": "deepprior_tpu/ops/pallas_warp.py:293",
         "launches": k4_launches, "max_abs_err": err["warp_patch"],
         "ms": t["wrap_k4"], "plain_ms": t["wrap_plain"], "kernel_only_ms": t["k4"]},
        {"name": "warp_norm", "route": "cuda",
         "source": "deepprior_tpu_torch/csrc/warp.cu",
         "replaces": "deepprior_tpu/ops/pallas_warp.py:150",
         "launches": k5_launches, "max_abs_err": err["warp_norm"],
         "ms": t["wrap_k5"], "plain_ms": t["wrap5_plain"], "kernel_only_ms": t["k5"]},
    ]



def realtime_phases(dev, tag, log, model, prior, batch=512, n_det=64):
    """Phases 12-16: K2 against its plain version, the 'linear' estimator
    through K2 at B = 512, detection and refinement on the card at B = 64,
    the realtime pipeline and the demo main, and their timings.  ``model``
    is the full-width bf16 PoseRegNet of phase 4.  Returns K2's JSON
    record."""
    import os

    import torch

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data.detector_np import HandCropper
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.models import PoseRegNet, ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.ops import com as tcom
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops.crop import clamp_depth, normalized_crop
    from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
    from deepprior_tpu_torch.realtime.camera import SyntheticDevice
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.realtime.pipeline import (
        HAND_RIGHT, STATE_RUN, RealtimeHandposePipeline)
    from deepprior_tpu_torch.train.trainer import float32_compute

    cam = NYU_CAMERA
    cube = (250.0, 250.0, 250.0)
    rng = np.random.default_rng(31)
    counts = hopper_crop.LAUNCHES

    def frames(c, n):
        pairs = [make_depth_frame(c, rng) for _ in range(n)]
        depth = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
        com = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
        return depth, com

    def reset():
        counts.update(normalized_crop=0, normalized_crop_linear=0)

    # --------------------------------------------------------------- 12
    max_err = 0.0
    cases = []

    def check(label, c, raw, com, cb, fuse_clamp, zero_one=False, **knobs):
        """K2 vs the plain 'linear' crop on identical GPU inputs; bit-exact."""
        nonlocal max_err
        got, m_got = hopper_crop.hopper_normalized_crop(
            raw, com, cb, c.fx, c.fy, norm_zero_one=zero_one,
            fuse_clamp=fuse_clamp, use_bilinear=True, **knobs)
        src = clamp_depth(raw)[0] if fuse_clamp else raw
        want, m_want = normalized_crop(src, com, cb, c.fx, c.fy,
                                       norm_zero_one=zero_one, resize="linear")
        torch.cuda.synchronize()
        max_err = max(max_err, (got - want).abs().max().item())
        if not (torch.equal(got, want) and torch.equal(m_got, m_want)):
            raise AssertionError(f"K2 {label}: kernel != plain on "
                                 f"{int((got != want).sum())} pixels")
        cases.append(label)
        return got

    raw, com = frames(cam, 64)
    clamped = clamp_depth(raw)[0]
    ref = check("nyu64 clamped", cam, clamped, com, cube, False)
    noisy = raw.clone()
    mask = torch.rand(noisy.shape, generator=torch.Generator(dev).manual_seed(5),
                      device=dev) < 0.01
    noisy[mask] = 1600.0 + 900.0 * torch.rand(int(mask.sum()), device=dev)
    check("nyu64 1% at 1600-2500 mm, fuse_clamp", cam, noisy, com, cube, True)
    check("nyu64 raw, fuse_clamp", cam, raw, com, cube, True)
    check("cube 900", cam, raw, com, (900.0,) * 3, True)
    per_sample = torch.from_numpy(
        rng.uniform(150.0, 450.0, (64, 3)).astype(np.float32)).to(dev)
    check("per-sample cube", cam, raw, com, per_sample, True)
    com_d0 = com.clone()
    com_d0[::4, 2] = 0.0
    check("d = 0 centred fallback", cam, raw, com_d0, cube, True)
    com_b = com.clone()
    edge = torch.from_numpy(rng.uniform(0.0, 20.0, 64).astype(np.float32)).to(dev)
    com_b[0::4, 0] = edge[0::4]
    com_b[1::4, 0] = cam.width - 1 - edge[1::4]
    com_b[2::4, 1] = edge[2::4]
    com_b[3::4, 1] = cam.height - 1 - edge[3::4]
    check("CoMs within 20 px of each border", cam, raw, com_b, cube, True)
    check("norm_zero_one", cam, raw, com, cube, True, zero_one=True)
    icvl, com_i = frames(ICVL_CAMERA, 32)
    check("icvl32 320x240", ICVL_CAMERA, icvl, com_i, cube, True)
    check("icvl32 norm_zero_one", ICVL_CAMERA, icvl, com_i, cube, True, zero_one=True)
    knobbed = check("block_k/win_rows/win_cols", cam, clamped, com, cube, False,
                    win_rows=304, win_cols=640, block_k=4)
    if not torch.equal(knobbed, ref):
        raise AssertionError("block_k/win_rows/win_cols changed K2's output")
    near = hopper_crop.hopper_normalized_crop(clamped, com, cube, cam.fx, cam.fy)[0]
    if (near - ref).abs().max().item() < 1e-3:
        raise AssertionError("K2 did not interpolate (equals the nearest crop)")
    log(f"[12 K2 vs plain] {len(cases)} cases bit-exact (torch.equal), "
        f"max |kernel - plain| = {max_err}")

    # --------------------------------------------------------------- 13
    n_unique = 16
    est = FusedEstimator(model, cam, prior=prior, resize="linear", device=dev)
    plain_est = FusedEstimator(model, cam, prior=prior, resize="linear",
                               crop_method="gather", device=dev)
    depth_u, com_u = frames(cam, n_unique)
    depth_d = depth_u.repeat(batch // n_unique, 1, 1)
    com_d = com_u.repeat(batch // n_unique, 1)
    cube_d = torch.from_numpy(
        rng.uniform(200.0, 350.0, (batch, 1)).repeat(3, 1).astype(np.float32)).to(dev)
    mirror = torch.arange(batch, device=dev) % 2 == 0
    calls = (dict(), dict(cube=cube_d, mirror=mirror, invx=True))
    reset()
    outs = [est(depth_d, com_d, **kw) for kw in calls]
    torch.cuda.synchronize()
    launches = dict(counts)
    if launches != {"normalized_crop": 0, "normalized_crop_linear": len(calls)}:
        raise AssertionError(f"linear main path launched {launches}")
    for kw, (joints, _, crops) in zip(calls, outs):
        pj, _, pcr = plain_est(depth_d, com_d, **kw)
        if joints.shape != (batch, 14, 3) or not torch.isfinite(joints).all():
            raise AssertionError(f"joints {tuple(joints.shape)} not finite/shaped")
        max_err = max(max_err, (crops - pcr).abs().max().item())
        if not torch.equal(crops, pcr):
            raise AssertionError("linear estimator crops: K2 != plain gather")
        jerr = (joints - pj).abs().max().item()
        if jerr > 1e-3:
            raise AssertionError(f"linear joints differ from the plain path by {jerr} mm")
    cpu_model = PoseRegNet(model.cfg._replace(dtype=torch.float32))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_est = FusedEstimator(cpu_model, cam, prior=prior, resize="linear", device="cpu")
    ccr = cpu_est(depth_u.cpu(), com_u.cpu())[2]
    if not torch.equal(outs[0][2][:n_unique].cpu(), ccr):
        raise AssertionError("linear GPU crops differ from the CPU crops")
    k2_launches = launches["normalized_crop_linear"]
    log(f"[13 linear main path] FusedEstimator(resize='linear') B={batch} NYU "
        f"640x480, PoseRegNet hidden=1024 bf16, PCA (30, 42): launches {launches}, "
        f"joints finite, crops == plain gather, joints |d| <= 1e-3 mm, crops == CPU")

    # --------------------------------------------------------------- 14
    b64 = n_det
    # b64 distinct frames, every one also detected on the CPU
    depth_6, com_6 = frames(cam, b64)
    cpu_6 = depth_6.cpu()
    dc6, dmin6, dmax6 = clamp_depth(depth_6)
    det_dev = tcom.detect_closest(dc6, cube, cam.fx, cam.fy, min_depth=dmin6,
                                  max_depth=dmax6)
    dcc, dminc, dmaxc = clamp_depth(cpu_6)
    det_cpu = tcom.detect_closest(dcc, cube, cam.fx, cam.fy, min_depth=dminc,
                                  max_depth=dmaxc)
    full_dev = tcom.detect(depth_6, cube, cam.fx, cam.fy)
    full_cpu = tcom.detect(cpu_6, cube, cam.fx, cam.fy)
    com_err = max((det_dev.cpu() - det_cpu).abs().max().item(),
                  (full_dev.cpu() - full_cpu).abs().max().item())
    if com_err > 0.5:
        raise AssertionError(f"CoMs on the card differ from the CPU's by {com_err}")
    modes = (("detect, K1", dict(detect=True), "normalized_crop"),
             ("refine_iters=3 + linear, K2", dict(refine_iters=3, resize="linear"),
              "normalized_crop_linear"))
    for label, kw, kernel in modes:
        e = FusedEstimator(model, cam, prior=prior, device=dev, **kw)
        pe = FusedEstimator(model, cam, prior=prior, device=dev, crop_method="gather", **kw)
        ce = FusedEstimator(cpu_model, cam, prior=prior, device="cpu", **kw)
        reset()
        joints, c3, crops = e(depth_6, com_6)
        torch.cuda.synchronize()
        got = dict(counts)
        if got[kernel] != 1 or sum(got.values()) != 1:
            raise AssertionError(f"{label}: launched {got}")
        pj, pc3, pcr = pe(depth_6, com_6)
        if not (torch.equal(crops, pcr) and torch.equal(c3, pc3)):
            raise AssertionError(f"{label}: crops or CoMs != the plain path's")
        cerr = (c3.cpu() - ce(cpu_6, com_6.cpu())[1]).abs().max().item()
        if cerr > 0.5 or not torch.isfinite(joints).all():
            raise AssertionError(f"{label}: CoM vs CPU {cerr} mm")
        com_err = max(com_err, cerr)
        log(f"[14 detection] {label} B={b64}: launches {got}, crops and CoMs == "
            f"plain path, com3d vs CPU max |d| {cerr} mm")
    log(f"[14 detection] detect_closest and detect (slice scan) on the card at "
        f"B={b64} distinct frames vs the CPU on all of them: max |d| {com_err} "
        f"px/mm (bound 0.5)")

    # --------------------------------------------------------------- 15
    scalenet = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3, hidden=1024),
                        generator=torch.Generator().manual_seed(3)).to(dev)
    refiner = CNNComRefiner(scalenet, cam)
    # the f32 refiner on the card against a CPU copy, on phase 14's frames
    # and detected CoMs; a TF32 run of the same net shows what a leak of
    # TF32 into the refiner would cost
    cpu_scalenet = copy.deepcopy(scalenet).cpu()
    ref_err = (refiner(dc6, det_dev, cube).cpu()
               - CNNComRefiner(cpu_scalenet, cam)(dcc, det_dev.cpu(), cube)
               ).abs().max().item()
    crops6 = hopper_crop.hopper_normalized_crop(dc6, det_dev, cube, cam.fx, cam.fy)[0]
    with torch.inference_mode():
        off_cpu = cpu_scalenet(crops6.cpu()[:, None])
        with float32_compute():
            off_f32 = scalenet(crops6[:, None]).cpu()
        backends = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = [b.allow_tf32 for b in backends]
        for b in backends:
            b.allow_tf32 = True
        try:
            off_tf32 = scalenet(crops6[:, None]).cpu()
        finally:
            for b, v in zip(backends, saved):
                b.allow_tf32 = v
    f32_mm = (off_f32 - off_cpu).abs().max().item() * cube[2] / 2.0
    tf32_mm = (off_tf32 - off_cpu).abs().max().item() * cube[2] / 2.0
    if ref_err > 0.5 or not f32_mm < tf32_mm:
        raise AssertionError(f"ScaleNet refiner on the card vs CPU: {ref_err} px/mm, "
                             f"offset {f32_mm} mm (TF32 run: {tf32_mm} mm)")
    log(f"[15 refiner] CNNComRefiner (ScaleNet hidden 1024 f32) on the card vs a CPU "
        f"copy, B={b64}: refined CoMs max |d| {ref_err} px/mm (bound 0.5); offsets "
        f"max |d| {f32_mm} mm, vs {tf32_mm} mm with TF32 allowed")
    cfg = {"fx": cam.fx, "fy": cam.fy, "cube": cube}
    pipe = RealtimeHandposePipeline(est, cfg, com_refiner=refiner)
    reset()
    pipe.process_key("i")
    t0 = time.perf_counter()
    single = pipe.process_video(SyntheticDevice(cam, seed=0), max_frames=100)
    single_s = time.perf_counter() - t0
    if pipe.state != STATE_RUN or pipe.config["cube"][0] == cube[0]:
        raise AssertionError(f"INIT calibration: state {pipe.state}, cube {pipe.config['cube']}")
    single_fps = pipe.fps()
    pipe.process_key("h")
    pipe.process_key("t")
    t0 = time.perf_counter()
    threaded = pipe.process_video_threaded(SyntheticDevice(cam, seed=1), max_frames=100)
    threaded_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pipe_launches = dict(counts)
    if not (pipe.hand == HAND_RIGHT and pipe.tracking):
        raise AssertionError("the 'h'/'t' keys did not take")
    for res in (single, threaded):
        if not res or not all(np.isfinite(r["joints3d"]).all() and r["joints3d"].shape == (14, 3)
                              for r in res):
            raise AssertionError(f"pipeline results: {len(res)}, non-finite or misshaped")
    if min(pipe_launches.values()) == 0:
        raise AssertionError(f"pipeline launched {pipe_launches}")
    log(f"[15 pipeline] {len(single)} of 100 frames single-loop ('i': INIT -> RUN, "
        f"cube {tuple(round(float(c), 2) for c in pipe.config['cube'])}), {len(threaded)} "
        f"threaded ('h' right hand, 't' tracking), ScaleNet hidden 1024 f32 refiner, "
        f"estimator resize='linear': launches {pipe_launches}")
    # device detection against the host HandCropper path on the same frames
    dev_pipe = RealtimeHandposePipeline(est, dict(cfg))
    host_pipe = RealtimeHandposePipeline(est, dict(cfg), use_device_detect=False)
    camdev = SyntheticDevice(cam, seed=2)
    camdev.start()
    host_err, det_ms, host_ms, pose_ms = 0.0, [], [], []
    for i in range(20):
        dev_pipe.tracking = host_pipe.tracking = i >= 10
        frame = camdev.getDepth()[1]
        t0 = time.perf_counter()
        cd, _ = dev_pipe.detect(frame)
        det_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ch, _ = host_pipe.detect(frame)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pipe.estimate_pose(frame, cd)
        pose_ms.append((time.perf_counter() - t0) * 1e3)
        host_err = max(host_err, float(np.abs(cd - ch).max()))
    if host_err > 0.5:
        raise AssertionError(f"device detection vs host HandCropper: {host_err}")
    log(f"[15 pipeline] device detection vs the host HandCropper path, 20 frames "
        f"(10 detect, 10 tracking): max |d| {host_err} px/mm (bound 0.5)")
    demo = subprocess.run(
        [sys.executable, "-m", "deepprior_tpu_torch.mains.demo_realtime",
         "--frames", "50", "--comref"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))),
    )
    if demo.returncode != 0 or " frames on cuda" not in demo.stdout:
        raise AssertionError(f"demo_realtime failed ({demo.returncode}):\n"
                             f"{demo.stdout}\n{demo.stderr[-3000:]}")
    log(f"[15 demo] python -m deepprior_tpu_torch.mains.demo_realtime --frames 50 "
        f"--comref: {demo.stdout.strip().splitlines()[-1]}")

    # ----------------------------------------------------------- timing
    launch_args = hopper_crop.crop_args(depth_d, com_d, cube, cam.fx, cam.fy, fuse_clamp=True)
    plain_ms, ms = alternate(
        lambda: normalized_crop(clamp_depth(depth_d)[0], com_d, cube, cam.fx, cam.fy,
                                resize="linear"),
        lambda: hopper_crop.hopper_normalized_crop(depth_d, com_d, cube, cam.fx, cam.fy,
                                                   fuse_clamp=True, use_bilinear=True),
        20)
    k1_ms, k2_ms = alternate(
        lambda: hopper_crop.launch_crop(depth_d, launch_args),
        lambda: hopper_crop.launch_crop(depth_d, launch_args, linear=True), 50)
    # the nearest estimator in turns with the linear one: the two differ by
    # the kernel and its wrapper only, within one phase's host speed
    near_est = FusedEstimator(model, cam, prior=prior, device=dev)
    near_ms, est_ms = alternate(lambda: near_est(depth_d, com_d),
                                lambda: est(depth_d, com_d), 20)

    def host_ms_of(fn, n):
        runs = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(runs[2:]))

    det1 = host_ms_of(lambda: tcom.detect(depth_6[:1], cube, cam.fx, cam.fy), 12)
    det64 = host_ms_of(lambda: tcom.detect(depth_6, cube, cam.fx, cam.fy), 7)
    log(f"[16 timing] {tag} B={batch} NYU: K2 path {ms:.4f} ms vs plain clamp + "
        f"linear crop {plain_ms:.4f} ms; K2 alone {k2_ms:.4f} ms vs K1 alone "
        f"{k1_ms:.4f} ms; linear estimator {est_ms:.4f} ms/batch = "
        f"{batch / (est_ms / 1e3):.1f} frames/s vs nearest {near_ms:.4f} ms/batch = "
        f"{batch / (near_ms / 1e3):.1f} frames/s (in turns)")
    log(f"[16 timing] {tag} detect (slice scan + refine) B=1 {det1:.4f} ms, "
        f"B={b64} {det64:.4f} ms (median, host clock); pipeline single-loop "
        f"{len(single) / single_s:.1f} frames/s (running fps {single_fps:.1f}), "
        f"threaded {len(threaded) / threaded_s:.1f} frames/s; per frame (no "
        f"refiner): device detect {np.median(det_ms):.4f} ms, host HandCropper detect "
        f"{np.median(host_ms):.4f} ms, pose (batch 1, linear) {np.median(pose_ms):.4f} ms")
    return {"name": "normalized_crop_linear", "route": "cuda",
            "source": "deepprior_tpu_torch/csrc/crop.cu",
            "replaces": "deepprior_tpu/ops/pallas_crop.py:417",
            "launches": k2_launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "kernel_only_ms": k2_ms}


def probe_phases(dev, tag, log):
    """Phases 17-18: the measuring path, the probe scripts K6
    (deepprior_tpu_torch.prof.prof_bench) and K7 (prof_warp_bf16) driven as
    a user runs them, then each probe kernel against its plain version,
    the library call that computes the same function where there is one,
    and K7 in turns with K4.  Returns the probes' JSON records."""
    import torch
    import torch.nn.functional as F

    from deepprior_tpu_torch.ops import hopper_probes as hp
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.prof import prof_bench, prof_warp_bf16
    from deepprior_tpu_torch.utils.flops import roofline_ms

    # --------------------------------------------------------------- 17
    # the scripts time each probe alone from a CUDA graph; their kernel
    # times are the ones reported below
    hp.LAUNCHES.update(dict.fromkeys(hp.LAUNCHES, 0))
    k6_ms = prof_bench.main(log=lambda line: log(f"[17 prof_bench] {line}"))
    k7_alone = {split: alone for split, (_, alone) in prof_warp_bf16.main(
        log=lambda line: log(f"[18 prof_warp_bf16] {line}"))[0].items()}
    torch.cuda.synchronize()
    launches = dict(hp.LAUNCHES)
    if min(launches.values()) == 0:
        raise AssertionError(f"the probe scripts launched {launches}")
    log(f"[17 main path] python -m deepprior_tpu_torch.prof.prof_bench and "
        f"prof_warp_bf16: launches {launches}")

    dpt, zero = prof_bench.make_inputs(dev)
    band = (prof_bench.WH, prof_bench.WW)
    b, h, w = dpt.shape
    rng = np.random.default_rng(17)
    picked = np.stack([rng.integers(0, (h - band[0]) // hp.ROW_ALIGN + 1, b) * hp.ROW_ALIGN,
                       rng.integers(0, (w - band[1]) // hp.COL_ALIGN + 1, b) * hp.COL_ALIGN], 1)
    per_sample = torch.from_numpy(hp.check_offsets(picked, (h, w), band)).to(dev)
    err = {body: 0.0 for body in hp.BODIES}
    for label, offs in (("zero offsets", zero), ("aligned per-sample offsets", per_sample)):
        for body in hp.BODIES:
            got = hp.launch_band(dpt, offs, band, body)
            want = hp.band_plain(dpt, offs, body)
            torch.cuda.synchronize()
            err[body] = max(err[body], (got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"K6 {body}, {label}: kernel != plain on "
                                     f"{int((got != want).sum())} pixels")
    # the PyTorch calls that compute each body's function when every offset
    # is 0: copy_ broadcasts the selected (B, 1, 1) pixel over the tile; the
    # bf16 body needs two calls, the rounding and then the copy
    corner = torch.empty((b, hp.CORNER, hp.CORNER), device=dev)
    pixel = dpt[:, hp.SEL_ROW:hp.SEL_ROW + 1, hp.SEL_COL:hp.SEL_COL + 1]
    library = {
        "trivial": ("out.copy_(dpt[:, :128, :128])",
                    lambda: corner.copy_(dpt[:, :hp.CORNER, :hp.CORNER])),
        "select": ("out.copy_(dpt[:, 64:65, 32:33])", lambda: corner.copy_(pixel)),
        "select_bf16": ("out.copy_(dpt[:, 64:65, 32:33].to(torch.bfloat16))",
                        lambda: corner.copy_(pixel.to(torch.bfloat16))),
    }
    for body, (call, fn) in library.items():
        if not torch.equal(fn(), hp.launch_band(dpt, zero, band, body)):
            raise AssertionError(f"K6 {body} != {call} at zero offsets")
    log(f"[17 K6 vs plain] trivial, select and select_bf16 at B={b} {h}x{w}, band "
        f"{band[0]}x{band[1]}, zero and aligned per-sample offsets: bit-exact "
        f"(torch.equal); at zero offsets each equals its PyTorch call: "
        + "; ".join(f"{body} == {call}" for body, (call, _) in library.items()))
    replaces = {"trivial": "prof_bench.py:28", "select": "prof_bench.py:56",
                "select_bf16": "prof_bench.py:79"}
    records = []
    for body in hp.BODIES:
        name = f"band_{body}"
        ms = k6_ms[body]
        plain_ms = graph_ms(lambda body=body: hp.band_plain(dpt, zero, body), iters=50)
        call, fn = library[body]
        # the PyTorch call in turns with the kernel
        call_ms, turns_kernel = alternate(
            fn, lambda body=body: hp.launch_band(dpt, zero, band, body), 50, graph_ms)
        # select_bf16's call is two launches, so it is no one-call equivalent
        library_ms = None if body == "select_bf16" else call_ms
        need = hp.band_need_bytes(dpt.shape, body)
        bound, bound_by = roofline_ms(need, hp.FP32_OPS_PER_PIXEL[name] * b * hp.CORNER ** 2)
        log(f"[17 timing] {tag} K6 {body} B={b} (CUDA graphs): kernel {ms:.4f} ms "
            f"(prof_bench), plain {plain_ms:.4f} ms, {call} {call_ms:.4f} ms "
            f"({'one call' if library_ms is not None else 'two calls: no one-call equivalent'}) "
            f"in turns with the kernel's {turns_kernel:.4f} ms: kernel "
            f"{'no slower' if turns_kernel <= call_ms else 'SLOWER'}; moves {need} B "
            f"(the TPU band: {hp.band_read_bytes(dpt.shape, band)} B) = "
            f"{need / (ms * 1e-3) / 1e12:.4f} TB/s: bound {bound:.4f} ms by {bound_by}, "
            f"share {bound / ms:.4f}")
        records.append({
            "name": name, "route": "cuda", "source": "deepprior_tpu_torch/csrc/probes.cu",
            "replaces": replaces[body], "launches": launches[name],
            "max_abs_err": err[body], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms})

    # --------------------------------------------------------------- 18
    patch, m = prof_warp_bf16.make_inputs(dev)
    params = hw.warp_patch_params(m)
    b, h, w = patch.shape
    outs, err7 = {}, {}
    for split in (False, True):
        got = hp.launch_warp_general(patch, params, split)
        want = hp.warp_general_plain(patch, params, split)
        torch.cuda.synchronize()
        err7[split] = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"K7 split={split}: kernel != plain on "
                                 f"{int((got != want).sum())} pixels")
        outs[split] = got
    if not torch.equal(outs[False], outs[True]):
        raise AssertionError("K7 'split' != 'f32'")
    k4 = hw.launch_warp(patch, params, 0.0, None)
    if not torch.equal(k4, outs[False]):
        raise AssertionError("K4 without the NV mask != K7 'f32' (the same function)")
    # the library call: grid_sample, nearest, zeros, on a precomputed grid
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    c = [params[:, i, None, None] for i in range(6)]
    x = (c[0] * u + c[1] * v) + c[2]
    y = (c[3] * u + c[4] * v) + c[5]
    grid = torch.stack([x * (2.0 / (w - 1)) - 1.0, y * (2.0 / (h - 1)) - 1.0], dim=-1)

    def grid_sample():
        return F.grid_sample(patch[:, None], grid, mode="nearest", padding_mode="zeros",
                             align_corners=True)[:, 0]

    n_diff = int((grid_sample() != outs[False]).sum())
    log(f"[18 K7 vs plain] 'f32' and 'split' at B={b} {h}x{w}: bit-exact (torch.equal); "
        f"'split' == 'f32'; K4 (no NV mask) == K7 'f32'; grid_sample(nearest, zeros, "
        f"align_corners=True) differs on {n_diff} of {outs[False].numel()} pixels "
        f"(it rounds half to even, K7 half up)")
    lib7 = graph_ms(grid_sample, iters=50)
    k4_ms, k7_ms = alternate(lambda: hw.launch_warp(patch, params, 0.0, None),
                             lambda: hp.launch_warp_general(patch, params), 50, graph_ms)
    n_bytes = hw.warp_bytes(params, (h, w))
    for split in (False, True):
        name = "warp_general_split" if split else "warp_general"
        ms = k7_alone[split]
        plain_ms = graph_ms(lambda split=split: hp.warp_general_plain(patch, params, split),
                            iters=50)
        bound, bound_by = roofline_ms(n_bytes, hp.FP32_OPS_PER_PIXEL[name] * b * h * w)
        library_ms = lib7 if n_diff == 0 else None
        log(f"[18 timing] {tag} K7 {name} B={b} (CUDA graphs): kernel {ms:.4f} ms "
            f"(prof_warp_bf16), plain {plain_ms:.4f} "
            f"ms, grid_sample {lib7:.4f} ms ({'the same function' if n_diff == 0 else 'not the same function: %d pixels differ' % n_diff}); "
            f"needs {n_bytes} B = {n_bytes / (ms * 1e-3) / 1e12:.4f} TB/s: bound "
            f"{bound:.4f} ms by {bound_by}, share {bound / ms:.4f}")
        records.append({
            "name": name, "route": "cuda", "source": "deepprior_tpu_torch/csrc/probes.cu",
            "replaces": "prof_warp_bf16.py:63", "launches": launches[name],
            "max_abs_err": err7[split], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            "library_pixels_differ": n_diff})
    # the same at 4x the batch, where the patches no longer sit in L2 as easily
    big, big_params = patch.repeat(4, 1, 1), params.repeat(4, 1)
    k4_big, k7_big = alternate(lambda: hw.launch_warp(big, big_params, 0.0, None),
                               lambda: hp.launch_warp_general(big, big_params), 50, graph_ms)
    log(f"[18 staging] {tag} 128x128, CUDA graphs in turns: K4 (patch staged in shared "
        f"memory) vs K7 'f32' (loads straight from global), the same function bit for "
        f"bit: B={b} {k4_ms:.4f} vs {k7_ms:.4f} ms; B={4 * b} {k4_big:.4f} vs "
        f"{k7_big:.4f} ms")
    return records


def roofline_phases(dev, tag, log, model, prior, kernels, batch=512,
                    warp_batches=(128, 512)):
    """Phases 19-20: the ported kernels K1, K2, K4 and K5 alone, in turns,
    against their bounds from the byte models, with their launches per
    main-path call (one estimator call, one train step); then the profiling
    helpers on the card.  Adds the bound to each kernel's record in
    ``kernels``."""
    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame, make_sequence
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import NV_VAL, augment_geometry, sample_augment_params
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer
    from deepprior_tpu_torch.utils.flops import peak_hbm_tbps, roofline_ms
    from deepprior_tpu_torch.utils.profiling import device_loop_latency, time_batched_inference

    cam = NYU_CAMERA
    cube = (250.0, 250.0, 250.0)
    rng = np.random.default_rng(19)
    record = {k["name"]: k for k in kernels}
    none_why = {
        "normalized_crop": "none: per-sample windows of different sizes, the clamp, "
                           "the z-threshold and the normalization have no single call",
        "warp_patch": "none: grid_sample has no NV mask and rounds half to even",
        "warp_norm": "none: the fused un/renormalization, premax and recrop "
                     "threshold have no single call",
    }
    none_why["normalized_crop_linear"] = none_why["normalized_crop"]

    # --------------------------------------------------------------- 19
    pairs = [make_depth_frame(cam, rng) for _ in range(16)]
    depth = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev).repeat(batch // 16, 1, 1)
    com = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev).repeat(batch // 16, 1)
    b, h, w = depth.shape
    # the kernels alone, their geometry included; the plain geometry feeds
    # the byte model
    params, _ = hopper_crop.crop_params(depth, com, cube, cam.fx, cam.fy, fuse_clamp=True)
    launch_args = hopper_crop.crop_args(depth, com, cube, cam.fx, cam.fy, fuse_clamp=True)
    k1_ms, k2_ms = alternate(
        lambda: hopper_crop.launch_crop(depth, launch_args),
        lambda: hopper_crop.launch_crop(depth, launch_args, linear=True), 50, graph_ms)
    per_call = {}
    for resize, name in ((None, "normalized_crop"), ("linear", "normalized_crop_linear")):
        est = FusedEstimator(model, cam, prior=prior, resize=resize, device=dev)
        hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
        est(depth, com)
        torch.cuda.synchronize()
        per_call[name] = hopper_crop.LAUNCHES[name]
    rows = [("normalized_crop", b, k1_ms, hopper_crop.crop_bytes(params, (h, w)),
             hopper_crop.FP32_OPS_PER_PIXEL["normalized_crop"] * b * 128 * 128),
            ("normalized_crop_linear", b, k2_ms,
             hopper_crop.crop_bytes(params, (h, w), linear=True),
             hopper_crop.FP32_OPS_PER_PIXEL["normalized_crop_linear"] * b * 128 * 128)]

    seq = make_sequence(cam, warp_batches[0], seed=19)
    data = TrainData.from_sequence(seq).to(dev)
    gen = torch.Generator(dev).manual_seed(19)
    for bsz in warp_batches:
        rep = bsz // data.n
        batch = TrainData(*(t.repeat((rep,) + (1,) * (t.dim() - 1)) for t in data)).take(
            torch.arange(bsz, device=dev))
        geo = augment_geometry(sample_augment_params(gen, bsz, 3), batch["com"],
                               batch["cube"], batch["m"], cam, ("com", "rot", "none"),
                               (128, 128))
        img, _ = hw.unnormalize(batch["crops"], geo.norm)
        p6 = hw.warp_patch_params(geo.a_fwd)
        k5_params = hw.warp_norm_params(geo.a_fwd, geo.norm)
        k4_ms, k5_ms = alternate(
            lambda: hw.launch_warp(img, p6, 0.0, NV_VAL),
            lambda: hw.launch_warp(batch["crops"], k5_params, 0.0, NV_VAL, fused=True), 50,
            graph_ms)
        rows += [("warp_patch", bsz, k4_ms, hw.warp_bytes(p6, (128, 128)),
                  hw.FP32_OPS_PER_PIXEL["warp_patch"] * bsz * 128 * 128),
                 ("warp_norm", bsz, k5_ms, hw.warp_bytes(k5_params, (128, 128), fused=True),
                  hw.FP32_OPS_PER_PIXEL["warp_norm"] * bsz * 128 * 128)]
    full = data.take(torch.arange(data.n, device=dev))
    for fuse, name in ((None, "warp_patch"), (True, "warp_norm")):
        # no prior: the net regresses the 14 joints' 42 coordinates
        tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=1024)),
                     TrainConfig(batch_size=data.n, aug_fuse_norm=fuse), cam, device=dev)
        st = tr.init_state()
        hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
        tr._train_step_core(st, full, torch.Generator(dev).manual_seed(1),
                            torch.Generator(dev).manual_seed(2), 1e-4)
        torch.cuda.synchronize()
        per_call[name] = hw.LAUNCHES[name]
    if min(per_call.values()) < 1:
        raise AssertionError(f"launches per main-path call {per_call}")
    peak = peak_hbm_tbps()
    for name, bsz, ms, n_bytes, ops in rows:
        bound, bound_by = roofline_ms(n_bytes, ops)
        log(f"[19 roofline] {tag} {name} B={bsz}: kernel alone {ms:.4f} ms (CUDA graph, "
            f"in turns); "
            f"{n_bytes} B at {n_bytes / (ms * 1e-3) / 1e12:.4f} TB/s of {peak}; {ops} fp32 "
            f"ops; bound {bound:.4f} ms by {bound_by}, share {bound / ms:.4f}; "
            f"launches per main-path call {per_call[name]}; library {none_why[name]}")
        rec = record[name]
        if bsz == (warp_batches[0] if name.startswith("warp") else b):
            rec.update(bound_ms=bound, bound_by=bound_by, library_ms=None,
                       library=none_why[name], roofline_kernel_ms=ms,
                       launches_per_call=per_call[name])

    # --------------------------------------------------------------- 20
    est = FusedEstimator(model, cam, prior=prior, device=dev)
    d1, c1 = depth[:1].contiguous(), com[:1].contiguous()
    call_ms = time_batched_inference(est, (d1, c1), iters=50)
    # the whole call captures into a CUDA graph: its inputs are on the card,
    # nothing on the path reads a device value back, and the kernel
    # computes the geometry and launches on the current stream
    floor_ms = device_loop_latency(lambda c, d: est(d, c)[1] * 1e-32 + c, c1,
                                   iters=50, args=(d1,))
    # the replayed graph gives the eager call's outputs bit for bit
    for bsz in (1, b):
        dd, cc = depth[:bsz].contiguous(), com[:bsz].contiguous()
        replayed = graph_outputs(lambda: est(dd, cc))
        eager = est(dd, cc)
        torch.cuda.synchronize()
        if not all(torch.equal(g, e) for g, e in zip(replayed, eager)):
            raise AssertionError(f"B={bsz}: the estimator's CUDA-graph replay differs "
                                 f"from the eager call")
    log(f"[20 profiling] {tag} FusedEstimator B=1 NYU: time_batched_inference "
        f"{call_ms:.4f} ms/call (dispatch included, CUDA events); "
        f"device_loop_latency of FusedEstimator.__call__ (CUDA inputs) captured as "
        f"one CUDA graph of 50 calls: {floor_ms:.4f} ms/call, the device floor; "
        f"a graph of one call replays the eager call's joints, CoMs and crops bit "
        f"for bit at B=1 and B={b}")


if __name__ == "__main__":
    main()
