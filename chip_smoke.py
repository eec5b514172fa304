"""Smoke run of the PyTorch port (deepprior_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA crop kernel from deepprior_tpu_torch/csrc/crop.cu, holds it
bit for bit against its plain PyTorch version, drives the serving path
(FusedEstimator with a full-width PoseRegNet, then MicroBatchServer) at
B = 512 NYU frames, and times the kernel, the estimator and the server.
Every phase raises on failure, so the exit code is 0 only when all passed.
The last line is {"ok": true, "device": {...}}; the line before it
carries the kernel's launches, error and times as JSON.

Needs one CUDA card; without one it exits non-zero before any result.
Imports nothing of jax or of the JAX package.
"""

import json
import subprocess
import sys
import threading
import time

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


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; this script "
            "runs the port on a CUDA card and has no CPU fallback"
        )

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops import hopper_crop
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
    hopper_crop.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in BUILD_LOG.get("crop.cu", "").splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[2 build] crop.cu built and loaded in {build_s:.3f} s "
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

    hopper_crop.LAUNCHES = 0
    outs = [est(depth_d, com_d, **kw) for kw in calls]
    torch.cuda.synchronize()
    launches = hopper_crop.LAUNCHES
    if launches != len(calls):
        raise AssertionError(f"main path launched the kernel {launches} times")

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
    def kernel_crop():
        return hopper_crop.hopper_normalized_crop(
            depth_d, com_d, cube, cam.fx, cam.fy, fuse_clamp=True)

    def plain_crop():
        return normalized_crop(clamp_depth(depth_d)[0], com_d, cube, cam.fx, cam.fy)

    params, _ = hopper_crop.crop_params(depth_d, com_d, cube, cam.fx, cam.fy,
                                        fuse_clamp=True)
    # alternate plain, kernel, kernel, plain within this one call
    t_plain, t_kernel = [], []
    for fn, acc in ((plain_crop, t_plain), (kernel_crop, t_kernel),
                    (kernel_crop, t_kernel), (plain_crop, t_plain)):
        acc.append(time_ms(fn, iters=20))
    ms, plain_ms = float(np.mean(t_kernel)), float(np.mean(t_plain))
    launch_ms = time_ms(lambda: hopper_crop.launch_crop(
        depth_d, params, fuse_clamp=True), iters=50)
    params_ms = time_ms(lambda: hopper_crop.crop_params(
        depth_d, com_d, cube, cam.fx, cam.fy, fuse_clamp=True), iters=50)
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
        f"(runs {', '.join(f'{t:.4f}' for t in t_kernel)}) = params+limits "
        f"{params_ms:.4f} ms + kernel alone {launch_ms:.4f} ms; plain clamp+crop "
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

    print(json.dumps({"kernels": [{
        "name": "normalized_crop",
        "route": "cuda",
        "source": "deepprior_tpu_torch/csrc/crop.cu",
        "replaces": "deepprior_tpu/ops/pallas_crop.py:417",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "kernel_only_ms": launch_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
