"""Smoke run of the PyTorch port (deepprior_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--order-probe SECONDS] [--deadline SECONDS]

Builds the CUDA kernels from deepprior_tpu_torch/csrc/ (crop.cu: the
nearest crop K1 and the cv2-linear crop K2; warp.cu: the augmentation
warps K4 and K5; probes.cu: the band-read probes K6a-c and the general
warp K7; label.cu: the slice scan's connected-component labels K8) and holds each bit for bit against its plain PyTorch version
(the crops K1/K2 and the fused warp K5 compute their geometry in the
kernel: crops and M, and K5's patches and the per-sample fields it writes
for the labels, are held to the plain geometry and warp).  Then it drives
the main paths: serving (FusedEstimator with a full-width PoseRegNet, then
MicroBatchServer; phase 4 also runs the estimator with TF32 on for the
process and requires the TF32-off joints bit for bit, the PCA decode
being float32 whatever the switch says; phase 6 counts the crop wrapper's
device operations per estimator call with torch.profiler and fails above
5, and times the float32 PCA decode against a float32 matmul at B = 1)
at B = 512 NYU frames, training (the port's main_nyu_posereg_embedding:
12 steps at B = 128 through the default route, K5, then an epoch through
K4 with --no-aug-fuse-norm) with a training step on the card against the
CPU, and realtime serving (phases 12-15: the 'linear' estimator through
K2 at B = 512, detection and CoM refinement on the card at B = 64, the
RealtimeHandposePipeline with a full-width ScaleNet CoM refiner over a
synthetic camera, and the demo main; phase 16 times them).  Phase 10
times the train step and augment_batch through K4 and through K5 in turns
at B = 128 and 512 (the measurement behind fuse_norm=None taking K5),
requires K5 bit-equal to K4's unfused path on the same draws, and counts
device operations per call with torch.profiler (augment_batch via K5
fails above AUGMENT_K5_OPS).  Phases 17-18 drive the measuring path, the
probe scripts deepprior_tpu_torch.prof.prof_bench (K6) and prof_warp_bf16
(K7), then hold each probe against its plain version and its library call
(K6 in turns with its call) and time K7 in turns with K4 at B = 128 and
512; phase 19 times K1, K2, K4 and K5 alone against their bounds from the
byte models, with their launches per estimator call and train step;
phase 20 runs the profiling helpers on the estimator at B = 1 (dispatch
included, and its CUDA graph: the device floor), holds a replayed CUDA
graph of the estimator to the eager call bit for bit.  Phases 21-26 (run
after phase 16) drive the graph-replaying serving path: the registered
crop operator against launch_crop (K1 and K2, B = 512, and opcheck);
FusedEstimator.aot_compile at B = 1 and 512 against the eager _pipeline
on two input batches in turn, its B = 1 call timed in turns with the
dispatched __call__; MicroBatchServer replaying the graph from pinned
memory against graph=False on the same 64 requests, then both timed in
turns (requests/s from a burst, p50/p99 latency at 1, 16 and 64
closed-loop clients); the training main's network_prior.ckpt through
load_serving_net, its float32 estimator, eager and replayed, bit-equal
with TF32 on for the process; both artifact kinds of that estimator at
batch 64, loaded with TF32 on, against _pipeline and through the
fixed-config server (export, load and first-call times); and serve_http --checkpoint as a subprocess
answering /healthz and /predict.  Phases 27-30 (run after phase 26, before
the probe scripts) drive ResNet-47: the estimator at B = 512 and 1 in
float32 (against a CPU copy) and bf16 (frames/s and MFU, replayed and
dispatched), K1 == the plain gather; its aot_compile graphs, server and
both artifact kinds against the eager _pipeline; training steps at B = 128
in float32 and bf16 through K5 (K5 == its plain version, a card step
against a CPU step, ms, busy share, peak memory); and the training main
with --model resnet through load_serving_net, serve_http --model resnet
and --ref-pickle.  Phases 31-34 (run after phase 30) train on an
imported dataset: a seeded MSRA15 tree in the real .bin format (9
subjects x 256 frames of 320x240) imported on the host and batched on the
card, and with a ScaleNet refiner (comref, K1 once per chunk of 256
frames); with Pillow, an NYU 640x480 leg; the MSRA15 cross-validation
main at full width on the P8 fold at B = 128, --streamed and resident
under deterministic algorithms (K5 once per step, equal loss traces,
samples/s, busy share, the prefetcher's staging time); both runs cut
after epoch 0 and resumed with --resume, bit-equal to the uninterrupted
runs; main_msra15_com_refine --streamed (K5 per step) and its
net_P0_COM.ckpt through load_refine_net_lazy into a comref import (K1).
Phases 35-41 (run after phase 34) drive the scale-out path on the one
card: an NCCL group of one rank and a DistributedTrainer at full width,
B = 128, 12 steps through K5 (deterministic: bit-equal to the plain
Trainer; the two steps timed in turns), a sharded DCP snapshot resumed
bit for bit (its save and restore timed against train/checkpoint.py's),
the ResNet-47 leg (3 steps), a ShardedEstimator of two replicas on the
card against FusedEstimator on each replica's block, eager and replayed,
with detect=True too, aot_compile's detect/refine_iters/'nd_bilinear'
replays against the eager pipeline at B = 1 and 64, serve_http's server
with --dp 2 against --dp 1 and serve_http --dp 2 as a subprocess, the dry
run (python -m deepprior_tpu_torch.mains.dryrun) at world size 1, and two
processes in one 'cpu:gloo,cuda:gloo' group on the one card training
dp = 2 against one device (phase 41).
Phases 42-45 (run after phase 34, before phase 35) drive the evaluation
and capture surfaces: the randomized differential sweeps of
deepprior_tpu_torch/prof/sweeps.py on the card (K1 and K2 on random crop
scenes at 640x480 and 320x240, K5 through augment_batch(params=) at B =
512 and 128, each == its plain version, the plain crops and K5 against the
numpy twins, the detection layer against the host HandCropper), the
native capture shim (cpp/capture.cpp, built with g++) -> the realtime
pipeline -> K1 with every getter checked, demo_realtime --device capture
--save-view (the canvas and its status light; a PNG only with
matplotlib), and main_nyu_posereg_embedding --synthetic --accept at B =
128 (the acceptance record, a non-zero exit on a miss).
Phases 46-48 (run after phase 41) drive the last two modules: two
processes in one 'cpu:gloo,cuda:gloo' group on the one card split the crop
height over sp = 2 (parallel/spatial.py: halo exchanges around the
convolutions, the last map gathered before the head, K5 on every rank at
the whole batch), training full-width PoseRegNet at B = 128 (46), ResNet-47
(float32 and float64) and ScaleNet (ADAM and sgd_momentum) at B = 32 (47)
against the plain Trainer on the same batches;
then the JAX package's checkpoint format on a machine without jax (48):
PoseRegNet's and ResNet-47's network_prior.ckpt written in it
(``write_jax_checkpoint``) through load_serving_net at B = 512, K1 once a
call, joints bit-equal to the port's format, serve_http --checkpoint on
the JAX file, and a JAX-format ScaleNet through load_refine_net_lazy into
a comref import.
Phase 49 (run after phase 16) holds K8 to the plain label scan on the card
bit for bit (ops/hopper_label.py::hard_masks with int32, int64 and uint8
regions, 64 rendered NYU and 32 ICVL frames with the slice index as region
at B = 1 and 8), counts one launch a labeling call, replays a CUDA graph of
label_components against the eager call, holds detect through K8 to detect
through the plain scan (equal) and to the CPU (phase 14's bound), and times
K8 alone from a CUDA graph beside its byte bound, the plain scan and
detect at B = 1 through each.
Phase 50 (run after phase 49) holds V2V-PoseNet's train step (RMSProp, B =
8, the published 88^3 grid, He weights) to tests/plain_v2v.py on the card
over three steps, read as the cell v2v_nyu.train_b8 reads them and held to
its limits, and times the step (host clock and device busy), its memory
peak, and voxelize and heatmap_targets alone from CUDA graphs beside their
byte bounds.
Phase 51 (run after phase 50) counts one launch of K9, the stem's weight
gradient over the occupied voxels, in each of phase 50's steps, holds K9
to the plain gather on the card (voxelized grids at B = 8 and 88^3, a
random 5% grid, empty and full grids; float32 and bfloat16) within float32
round-off, exactly on a full grid of ones, and times it alone from CUDA
graphs beside its bound, cuDNN's dense weight gradient and the plain
gather.
Phase 52 (run after phase 51) counts 14 launches of K10, the weight
gradient of V2V's dense convolutions with few channels, in each of phase
50's steps, holds K10 to the plain version on the card at the five distinct
shapes of those 14 layers (float32 and bfloat16) within float32 round-off,
two launches and a CUDA graph's replay bit for bit, and times each shape
alone from CUDA graphs beside its bound and cuDNN's weight gradient.
Phase 53 (run after phase 52) serves V2V-PoseNet: a network_prior.ckpt
of it through load_serving_net("v2v"), the estimator's aot_compile replay
at B = 8 and 480x640 bit-equal to the eager pipeline in joints, crops,
grids and heatmaps, its voxel and row counters against the grids,
MicroBatchServer over the graph answering 64 requests bit-equal to eager
calls at the rows each batch was computed at, the artifact export and
ShardedEstimator refusing the family, and serve_http --model v2v
--checkpoint as a subprocess; then the replay's time a batch and the
capture's memory peak.
Phase 54 (run after phase 53) holds MicroBatchServer's graphs, one for
each row count up to max_batch over one set of static buffers and outputs
in one memory pool, to the eager pipeline at that row count bit for bit,
for a float32 PoseRegNet at max_batch 64 and phase 53's V2V-PoseNet at 8
and at 64; serves batches of sizes up to max_batch bit-equal to eager
calls at the rows computed, with each server.launch span's rows equal to
its batch's frames; and logs the seconds and memory of the captures and
each checked row count's replay time.
Phase 55 (run after phase 54) holds A2J's train step (Adam with weight
decay 1e-4, B = 64, 176x176 crops of a [220, 220, 300] mm cube, com / rot /
sc / none augmentation through K5, He weights, TF32 off) to the
benchmark's plain reference bench_torch/reference/a2j.py on the card over
three steps, read as the cell a2j_nyu.train_b64 reads them and held to its
limits; holds K5 at 176x176 to its plain version bit for bit, patches and
side outputs, and counts one launch a step; times the step (host clock,
device busy, model TFLOP/s) and its memory peak; and runs --model a2j
through the NYU main for one epoch.
Every phase raises on failure, so the
exit code is 0 only when all passed.  The last line is {"ok": true, "device": {...}}; the
line before it carries each kernel's launches, error, times and bound as
JSON.

--profile adds phase 11: torch.profiler over the train step (via K4 and
via K5) and its stages (augment via K4 and via K5, forward + backward,
optimizer) at B = 128 and 512, printing host ms, device busy ms, busy
share and launches per call, and the kernels that take the most device
time and the most launches.

After each group of phases a "[time] phases ..." line gives its wall and
CPU seconds, on stdout and on stderr.  Past --deadline (1100 s) the run
prints the last line it logged and every thread's stack to stderr, ends
its child processes and exits with code 3, printing no result.

Needs one CUDA card; without one it exits non-zero before any result.
Imports nothing of jax or of the JAX package.
"""

import argparse
import contextlib
import copy
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np


# a collective or a subprocess that waits longer raises, naming itself, well
# inside the run's deadline
GROUP_TIMEOUT_S = 300
SUBPROCESS_TIMEOUT_S = 300
_LAST_LOGGED = ["(nothing logged yet)"]
_STARTED = time.monotonic()
_EXPIRED = threading.Event()  # set by the watchdog: the run prints no result


def log(msg):
    """Prints ``msg`` with the run's seconds so far."""
    _LAST_LOGGED[0] = str(msg)[:300]
    print(f"{msg} @{time.monotonic() - _STARTED:.1f}s", flush=True)


def _cpu_seconds():
    """CPU seconds of this process and of its children waited for so far."""
    t = os.times()
    return t.user + t.system + t.children_user + t.children_system


def host_info():
    """The host's CPUs as this process sees them, and its load."""
    import torch

    quota = "none"
    with contextlib.suppress(OSError):
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    return (f"cpus {os.cpu_count()}, affinity {len(os.sched_getaffinity(0))}, cgroup "
            f"cpu.max {quota}, torch threads {torch.get_num_threads()}, load "
            f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}")


@contextlib.contextmanager
def stage(label):
    """Logs the seconds phases ``label`` took, the CPU seconds this process and
    its children spent in them, the host's load, and the run's seconds so far,
    on stdout and stderr (so that the end of stderr shows how far a run got)."""
    t, c = time.monotonic(), _cpu_seconds()
    yield
    report(label, t, c)


def report(label, t, c):
    """The line of ``stage``, for phases ``label`` begun at monotonic time
    ``t`` with ``c`` CPU seconds spent."""
    line = (f"[time] phases {label}: {time.monotonic() - t:.1f} s, "
            f"{_cpu_seconds() - c:.1f} CPU s, load {os.getloadavg()[0]:.2f} "
            f"({time.monotonic() - _STARTED:.1f} s since the start)")
    log(line)
    sys.stderr.write(line + "\n")
    sys.stderr.flush()


def _descendants():
    """The pids of every process under this one (from /proc)."""
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    parent[int(entry)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    found, frontier = [], [os.getpid()]
    while frontier:
        kids = [p for p, pp in parent.items() if pp in frontier]
        found += kids
        frontier = kids
    return found


def start_watchdog(seconds):
    """Ends a run that outlasts ``seconds``, so that a hang shows where it
    is instead of outliving the run's time limit: a daemon thread prints the
    last line logged and every thread's stack to stderr, sends SIGABRT to
    every process under this one (Python processes print their threads'
    stacks then, PYTHONFAULTHANDLER being set for them here), SIGKILL two
    seconds later, and exits with code 3.  faulthandler's own timer exits 30
    s later still, should that thread never get the interpreter."""
    import faulthandler

    os.environ["PYTHONFAULTHANDLER"] = "1"
    faulthandler.enable()
    faulthandler.dump_traceback_later(seconds + 30, exit=True)

    def watch():
        time.sleep(seconds)
        _EXPIRED.set()
        sys.stderr.write(f"chip_smoke: still running after {seconds:.0f} s; the last line "
                         f"logged: {_LAST_LOGGED[0]}\n")
        sys.stderr.flush()
        faulthandler.dump_traceback(all_threads=True)
        kids = _descendants()
        for sig in (signal.SIGABRT, signal.SIGKILL):
            for pid in kids:
                try:
                    os.kill(pid, sig)
                except OSError:
                    pass
            time.sleep(2)
        os._exit(3)

    threading.Thread(target=watch, name="chip_smoke watchdog", daemon=True).start()


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


def profile_stage(label, fn, iters, log, phase="11 profile"):
    """torch.profiler over iters calls of fn() after 3 warm-up calls.

    Logs the host ms per call (the profiler inflates it), the device busy
    ms per call (the union of the intervals of the kernels and copies on
    the card, so that nothing counts twice), its share of the host time,
    the launches per call, and the kernels that take the most device time
    and the most launches.  Returns (host ms, busy ms, launches) per call."""
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
    log(f"[{phase}] {label}: host {host_ms:.4f} ms/call (profiled), device "
        f"busy {busy_ms:.4f} ms/call, busy share {busy_ms / host_ms:.3f}, "
        f"launches/call {len(evs) / iters:.1f}")
    for key, what in ((lambda kv: -kv[1][1], "time"), (lambda kv: -kv[1][0], "launches")):
        for name, (c, t) in sorted(by.items(), key=key)[:8]:
            log(f"    by {what}: {t / iters:.4f} ms/call x{c / iters:.1f} {name[:100]}")
    return host_ms, busy_ms, len(evs) / iters


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the train step and its stages (phase 11)")
    ap.add_argument("--order-probe", type=float, default=None, metavar="SECONDS",
                    help="diagnose the phase order that hung once instead of the smoke "
                         "run: after the build, phase 41 first and then phases 35-40 in "
                         "this process; past SECONDS every thread's stack is dumped to "
                         "stderr and the process exits")
    ap.add_argument("--deadline", type=float, default=1100.0, metavar="SECONDS",
                    help="end the run past SECONDS (default 1100, under the 1200 s a "
                         "smoke run is given), printing every thread's stack and the "
                         "last line logged to stderr; exit code 3")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; this script "
            "runs the port on a CUDA card and has no CPU fallback"
        )
    start_watchdog(args.deadline)

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops import (hopper_crop, hopper_label, hopper_probes, hopper_stem,
                                         hopper_warp)
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
    print(card, flush=True)  # as nvidia-smi gives it
    log(f"[1 host] {host_info()}")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    builds = (hopper_crop.build, hopper_warp.build, hopper_probes.build, hopper_label.build,
              hopper_stem.build)
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, in parallel
        for fut in [pool.submit(b) for b in builds]:
            fut.result()
    build_s = time.perf_counter() - t0
    for src in ("crop.cu", "warp.cu", "probes.cu", "label.cu", "stem_wgrad.cu"):
        ptxas = [ln.strip() for ln in BUILD_LOG.get(src, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[2 build] {src} built and loaded ({build_s:.3f} s for all) "
            f"({'cached' if not ptxas else '; '.join(ptxas)})")

    if args.order_probe is not None:
        order_probe(dev, tag, args.order_probe)
        return

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
    # the PCA decode is float32 whatever the process's TF32 switch says:
    # with TF32 on for the process the estimator (its bf16 model untouched
    # by the switch) gives the TF32-off joints bit for bit; a decode through
    # a float32 matmul under the switch shows what that guards against
    backends = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = [bk.allow_tf32 for bk in backends]
    for bk in backends:
        bk.allow_tf32 = True
    try:
        tf32_outs = [est(depth_d, com_d, **kw) for kw in calls]
        with torch.inference_mode():
            emb = est.model(outs[0][2][:, None]).float()
            leak = emb @ est.prior.components + est.prior.mean
        torch.cuda.synchronize()
    finally:
        for bk, value in zip(backends, saved):
            bk.allow_tf32 = value
    for (joints, _, _), (tf32_joints, _, _) in zip(outs, tf32_outs):
        if not torch.equal(joints, tf32_joints):
            raise AssertionError("joints with TF32 on for the process differ from TF32 off "
                                 f"by {(joints - tf32_joints).abs().max().item()} mm")
    leak_mm = (leak - est.prior.inverse_transform(emb)).abs().max().item() * cube[2] / 2.0
    log(f"[4 TF32] estimator with TF32 on for the process (cuDNN and cuBLAS): joints "
        f"== TF32 off bit for bit in both calls; a decode through a float32 matmul "
        f"under TF32 would move them by up to {leak_mm:.6f} mm")

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
        for f in futs:
            f.result(timeout=300)
        return futs

    with MicroBatchServer(est, max_batch=max_batch, max_wait_ms=2) as srv:
        seen = record_batches(srv)
        futs = serve(srv, n_req)
        got = np.stack([f.result(timeout=300) for f in futs])
        stats, occ = dict(srv.stats), srv.occupancy()
    if stats["frames"] != n_req or stats["errors"]:
        raise AssertionError(f"server stats {stats}")
    # direct calls on each batch's requests at the rows the server computed
    serr = float(np.abs(got - eager_batches(est, seen, futs, request)).max())
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
    # what the float32 PCA decode costs a B=1 call: its products against a
    # float32 matmul (TF32 off) on the same embedding, in turns
    pca = est.prior
    emb = torch.randn((1, pca.components.shape[0]), generator=torch.Generator(dev).manual_seed(6),
                      device=dev)
    decodes = (lambda: emb @ pca.components + pca.mean, lambda: pca.inverse_transform(emb))
    mm_ms, prod_ms = alternate(*decodes, 50, graph_ms)
    mm_ops, prod_ops = (len(device_ops(fn)) for fn in decodes)
    log(f"[6 decode] {tag} the B=1 PCA decode (CUDA graphs, in turns): float32 products "
        f"{prod_ms:.4f} ms in {prod_ops} device operations, a float32 matmul {mm_ms:.4f} ms "
        f"in {mm_ops}")
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
    figures = {"poseregnet": {"est_ms": est_ms, "fps": fps, "b1_ms": b1_ms}}

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
    report("1-6", _STARTED, 0.0)
    trained = {}
    with stage("7-11"):
        kernels += training_phases(dev, tag, log, profile=args.profile, trained=trained)
    with stage("12-16"):
        kernels.insert(1, realtime_phases(dev, tag, log, model, prior))
    with stage("49"):
        kernels.append(label_phase(dev, tag, log))
    with stage("50-52"):
        v2v = v2v_phase(dev, tag, log)
        kernels.append(stem_phase(dev, tag, log, v2v["train_steps"]))
        kernels.append(wgrad_phase(dev, tag, log, v2v["train_steps"]))
    with stage("53-54"):
        v2v_serving = v2v_serving_phase(dev, tag, log)
        row_graphs_phase(dev, tag, log, v2v_serving)
        del v2v_serving
    with stage("55"):
        a2j_phase(dev, tag, log)
    with stage("21-26"):
        serving_phases(dev, tag, log, model, prior, trained, figures)
    # before the probe scripts: after them torch.profiler saw no device events
    with stage("27-30"):
        resnet_phases(dev, tag, log, kernels, figures)
    with stage("31-34"):
        dataset_phases(dev, tag, log, kernels)
    with stage("42-45"):
        evaluation_phases(dev, tag, log, kernels, model, prior)
    with stage("35-37"):
        scaleout_phases(dev, tag, log, kernels)
    with stage("38-40"):
        sharded_serving_phases(dev, tag, log, kernels)
    with stage("41"):
        gloo_card_phase(dev, tag, log, kernels)
    with stage("46-47"):
        spatial_card_phases(dev, tag, log, kernels)
    with stage("48"):
        jax_checkpoint_phase(dev, tag, log, kernels)
    with stage("17-18"):
        kernels += probe_phases(dev, tag, log)
    with stage("19-20"):
        roofline_phases(dev, tag, log, model, prior, kernels)
    if _EXPIRED.is_set():
        raise SystemExit(3)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


def order_probe(dev, tag, seconds):
    """Phase 41 (two gloo processes on the card) and then phases 35-40 in one
    process, the order that once hung after phase 37, under
    ``faulthandler.dump_traceback_later``: a hang prints every thread's
    stack and exits non-zero."""
    import faulthandler

    kernels = [{"name": name, "max_abs_err": 0.0} for name in ("normalized_crop", "warp_norm")]
    faulthandler.dump_traceback_later(seconds, exit=True)
    t = time.perf_counter()
    try:
        gloo_card_phase(dev, tag, log, kernels)
        scaleout_phases(dev, tag, log, kernels)
        sharded_serving_phases(dev, tag, log, kernels)
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"[order probe] {tag} phase 41, then phases 35-40, in one process: no hang, "
        f"{time.perf_counter() - t:.1f} s; launches {json.dumps(kernels)}")


# device operations of one augment_batch call via K5, at most (phase 10
# counts them with torch.profiler: 53-54 at B = 128 and 512 on an H100,
# where the call via K4 runs 416-417)
AUGMENT_K5_OPS = 56


def alternate(plain_fn, kernel_fn, iters, timer=time_ms):
    """Mean ms of each, timed in the order plain, kernel, kernel, plain."""
    t_plain, t_kernel = [], []
    for fn, acc in ((plain_fn, t_plain), (kernel_fn, t_kernel),
                    (kernel_fn, t_kernel), (plain_fn, t_plain)):
        acc.append(timer(fn, iters=iters))
    return float(np.mean(t_plain)), float(np.mean(t_kernel))


def device_ops(fn):
    """The names of the device operations (kernels, copies, memsets) of one
    fn() call, from torch.profiler, after one warm-up call; a profile that
    saw none is taken again, up to 3 times, then it raises, so that no
    count reads 0 by default."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the card's CUPTI tracing now and then delivers nothing
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if is_device_op(e)]
        if names:
            return names
    raise AssertionError("torch.profiler saw no device operation in 3 profiles")


def graph_outputs(fn):
    """fn()'s outputs from one replay of a CUDA graph that captured one
    fn() call (warmed up on a side stream first, as capture requires)."""
    import torch

    from deepprior_tpu_torch.utils.profiling import graph_capture

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        out = fn()
    graph.replay()
    out = [t.clone() for t in out]  # out of the graph's memory pool
    torch.cuda.synchronize()
    return out


def record_batches(srv):
    """The batches ``srv`` (a MicroBatchServer) resolves from now on, in a
    list: each batch's Futures and the rows its joints came back with, the
    rows the device computed (padding included).  Wraps ``srv._resolve`` on
    the instance."""
    seen, resolve = [], srv._resolve

    def logged(items, joints):
        seen.append(([r.future for r in items], len(joints)))
        resolve(items, joints)

    srv._resolve = logged
    return seen


def eager_batches(est, seen, futs, request):
    """What each of ``futs`` must resolve to: the eager pipeline on its
    batch's requests (``request(i)`` -> (depth, com[, cube or None,
    mirror]) for ``futs[i]``), tail-padded to the rows the server computed
    the batch at (``record_batches``); the joints (len(futs), J, 3) on the
    host, in the order of ``futs``."""
    index = {id(f): i for i, f in enumerate(futs)}
    want = [None] * len(futs)
    default = est.cube.cpu().numpy()
    for batch, rows in seen:
        ids = [index[id(f)] for f in batch if id(f) in index]
        if not ids:  # a warm-up batch
            continue
        reqs = [tuple(request(i)) + (None, False) for i in ids]
        reqs += [reqs[-1]] * (rows - len(reqs))
        joints = est(np.stack([r[0] for r in reqs]), np.stack([r[1] for r in reqs]),
                     cube=np.stack([default if r[2] is None else r[2] for r in reqs]),
                     mirror=np.array([r[3] for r in reqs]))[0].cpu().numpy()
        for k, i in enumerate(ids):
            want[i] = joints[k]
    missing = [i for i, w in enumerate(want) if w is None]
    if missing:
        raise AssertionError(f"no batch resolved requests {missing[:8]}")
    return np.stack(want)


def graph_ms(fn, iters):
    """Device ms of one fn() from a CUDA graph of iters calls: no host
    enqueue between the launches, so a kernel shorter than its Python
    wrapper's dispatch is timed by the card and not by the host."""
    import torch

    from deepprior_tpu_torch.utils.profiling import device_loop_latency

    return device_loop_latency(lambda c: (fn(), c)[1],
                               torch.zeros(1, device="cuda"), iters=iters)


def training_phases(dev, tag, log, profile=False, trained=None):
    """Phases 7-10: the warp kernels K4 and K5 against their plain
    versions, the training main path, a training step on the card against
    the CPU, and the training timings; with ``profile``, phase 11.  Returns
    the kernels' JSON records.  ``trained`` (a dict) receives the last
    training main's state, the PCA prior it fitted and its
    network_prior.ckpt (phase 24 serves it)."""
    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.geometry import rotation_matrix_2d
    from deepprior_tpu_torch.mains import main_nyu_posereg_embedding
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch import prior as tprior
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.crop import crop_transform
    from deepprior_tpu_torch.ops.augment import (
        NV_VAL, augment_batch, augment_geometry, sample_augment_params)
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
    def check5(label, crops, prm, com, cube, m, aug_modes, z1):
        """K5, its geometry computed in the kernel, against augment_geometry
        + warp_norm_plain on identical GPU inputs: the patches and the
        fields it writes for the labels, bit for bit."""
        geo = augment_geometry(prm, com, cube, m, cam, aug_modes, crops.shape[1:], z1)
        want = hw.warp_norm_plain(crops, hw.warp_norm_params(geo.a_fwd, geo.norm), 0.0,
                                  NV_VAL)
        side = dict(new_com=geo.new_com, new_cube=geo.new_cube, m_out=geo.m_out,
                    com3d=geo.com3d, new_com3d_c=geo.new_com3d_c, rot=geo.rot,
                    is_mode=torch.stack([geo.is_mode[k] for k in hw.MODES], 1))
        args = hw.warp_norm_args(crops, prm, com, cube, m, cam, aug_modes, z1)
        got = hw.launch_warp_norm(crops, args, 0.0, NV_VAL)
        torch.cuda.synchronize()
        err["warp_norm"] = max(err["warp_norm"], (got.out - want).abs().max().item())
        bad = [k for k, v in side.items() if not torch.equal(getattr(got, k), v)]
        if not torch.equal(got.out, want) or bad:
            raise AssertionError(
                f"K5 {label}: kernel != plain on {int((got.out != want).sum())} "
                f"pixels; side outputs differ: {bad}")
        cases.append(f"K5 {label}")
        return want

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
        want = check5(f"B={b} synthetic crops, modes {'/'.join(modes)}, "
                      f"norm_zero_one={z1}", d.crops, params, d.com, d.cube, d.m, modes, z1)
        if not torch.equal(want, hw.warp_norm_epilogue(ref, premax, geo.norm)):
            raise AssertionError(f"K5 norm_zero_one={z1} differs from the unfused "
                                 f"pipeline with K4")
    # rotations at +-90/180/270 deg, sc draws, com and sc samples whose CoMs
    # lie within 20 px of each border of the frame
    mi, off, rot, sc = (t.clone() for t in params)
    mi[:8] = modes.index("rot")
    rot[:8] = torch.tensor([90.0, 180.0, -90.0, -180.0, 270.0, 0.0, 45.0, -135.0],
                           device=dev)
    mi[8:16] = modes.index("sc")
    sc[8:16] = torch.linspace(0.9, 1.1, 8, device=dev)
    mi[16:32] = torch.tensor([modes.index("com"), modes.index("sc")] * 8, device=dev)
    com_b = data[False].com.clone()
    edge = torch.rand(16, generator=gen, device=dev) * 20.0
    com_b[16:20, 0] = edge[:4]
    com_b[20:24, 0] = cam.width - 1 - edge[4:8]
    com_b[24:28, 1] = edge[8:12]
    com_b[28:32, 1] = cam.height - 1 - edge[12:]
    for z1 in (False, True):
        d = data[z1]
        check5(f"rot +-90/180/270 deg, sc 0.9-1.1, com/sc CoMs within 20 px of the "
               f"borders, norm_zero_one={z1}", d.crops, (mi, off, rot, sc), com_b, d.cube,
               d.m, modes, z1)
    check5("one (3,) cube read at stride 0, aug_modes com/com/rot", data[False].crops,
           (mi % 3, off, rot, sc), data[False].com, data[False].cube[0], data[False].m,
           ("com", "com", "rot"), False)
    # 62x66 patches: rows of 66 floats take the kernel's 4-byte staging and
    # stores, not its 16-byte ones
    m_odd = crop_transform(data[True].com, data[True].cube, cam.fx, cam.fy,
                           (cam.height, cam.width), (66, 62))
    odd = torch.rand((b, 62, 66), generator=gen, device=dev)
    odd[torch.rand(odd.shape, generator=gen, device=dev) < 0.25] = 1.0
    check5("62x66 patches (4-byte staging), modes com/rot/sc/none, norm_zero_one=True",
           odd, params, data[True].com, data[True].cube, m_odd, modes, True)
    log(f"[7 warp kernels] {len(cases)} cases bit-exact (torch.equal): "
        f"{'; '.join(cases)}; K5 one block per sample with its geometry in the "
        f"kernel, its side outputs == augment_geometry's, and == the unfused "
        f"pipeline with K4; max |kernel - plain| K4 {err['warp_patch']}, K5 "
        f"{err['warp_norm']}")

    # ---------------------------------------------------------------- 8
    def train_main(extra, epochs):
        """The port's flagship entry point, as a user runs it."""
        fitted = []

        def fit(*a, **kw):  # keeps the prior the main fits
            fitted.append(real_fit(*a, **kw))
            return fitted[-1]

        real_fit, tprior.fit_pose_prior = tprior.fit_pose_prior, fit
        hw.LAUNCHES.update(warp_patch=0, warp_norm=0)
        t0 = time.perf_counter()
        try:
            state, results, hist = main_nyu_posereg_embedding.main([
                "--synthetic", "--epochs", str(epochs), "--batch-size", "128",
                "--nmax", "512", "--out", "eval/chip_smoke", "--device",
                str(dev)] + extra)
        finally:
            tprior.fit_pose_prior = real_fit
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if trained is not None:
            trained.update(state=state, prior=fitted[-1],
                           ckpt="eval/chip_smoke/train_EMB_PCA30/network_prior.ckpt")
        counts = dict(hw.LAUNCHES)
        costs = np.asarray(hist["train_cost"])
        if costs.shape != (4 * epochs,) or not np.isfinite(costs).all():
            raise AssertionError(f"training costs {costs}")
        for name, hpe in results.items():
            if not (np.isfinite(hpe.getMeanError()) and np.isfinite(hpe.getMaxError())):
                raise AssertionError(f"{name}: non-finite test error")
        return counts, costs, results, wall

    # the default route (fuse_norm=None: K5) for 3 epochs, then one epoch
    # of K4 through the main's flag
    default, other, flag = "warp_norm", "warp_patch", "--no-aug-fuse-norm"
    counts, costs, results, wall = train_main([], 3)
    steps = costs.size
    if counts != {default: steps, other: 0}:
        raise AssertionError(f"{steps} steps of the default route launched {counts}")
    main_launches = {default: counts[default]}
    log(f"[8 train main] main_nyu_posereg_embedding, synthetic NYU 640x480, nmax 512, "
        f"B=128, {steps} steps, PoseRegNet hidden 1024 f32 + dropout, PCA 30 of "
        f"50k sampled poses, reference ADAM, aug com/rot/none, the default "
        f"fuse_norm=None ({default}): launches {counts}, "
        f"costs {costs[0]:.4f} -> {costs[-1]:.4f} (all finite), "
        + ", ".join(f"{k} mean {v.getMeanError():.3f} mm max {v.getMaxError():.3f} mm"
                    for k, v in results.items())
        + f"; {wall:.1f} s with data and prior")
    counts, costs, results, wall = train_main([flag], 1)
    if counts != {default: 0, other: costs.size}:
        raise AssertionError(f"one epoch with {flag} launched {counts}")
    main_launches[other] = counts[other]
    log(f"[8 train main] one epoch with {flag}: launches {counts}, "
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
    modes3 = ("com", "rot", "none")
    for bsz in (128, 512):
        rep = bsz // b
        dd = TrainData(*(t.repeat((rep,) + (1,) * (t.dim() - 1)) for t in data[False]))
        trainers = {}
        for fuse in (False, True):
            tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=1024)),
                         TrainConfig(batch_size=bsz, aug_fuse_norm=fuse), cam, prior=pri,
                         device=dev)
            trainers[fuse] = (tr, tr.init_state())
        idx = torch.randperm(dd.n, generator=gen, device=dev)[:bsz]
        batch = dd.take(idx)
        aug_gen = torch.Generator(dev).manual_seed(1)
        drop_gen = torch.Generator(dev).manual_seed(2)
        aug = lambda **kw: augment_batch(  # noqa: E731
            aug_gen, batch["crops"], batch["gt3d_crop"], batch["com"], batch["cube"],
            batch["m"], cam, **kw)

        def step(fuse):
            tr, st = trainers[fuse]
            return tr._train_step_core(st, dd.take(idx), aug_gen, drop_gen, 1e-4)

        # the measurement behind fuse_norm=None: the train step and augment
        # through K4 and through K5 in turns, and K5 bit-equal to K4's
        # unfused pipeline on the same draws
        step4, step5 = alternate(lambda: step(False), lambda: step(True), 20)
        aug4, aug5 = alternate(lambda: aug(use_pallas=True, fuse_norm=False),
                               lambda: aug(use_pallas=True, fuse_norm=True), 20)
        aug_gather = time_ms(lambda: aug(use_pallas=False), iters=20)
        drawn = sample_augment_params(gen, bsz, len(modes3))
        via4 = aug(use_pallas=True, fuse_norm=False, params=drawn)
        via5 = aug(use_pallas=True, fuse_norm=True, params=drawn)
        if not all(torch.equal(x, y) for x, y in zip(via4, via5)):
            raise AssertionError(f"B={bsz}: augment_batch via K5 != via K4 on the same draws")
        # device operations per call, counted by torch.profiler
        ops = {name: len(device_ops(fn)) for name, fn in (
            ("augment via K4", lambda: aug(use_pallas=True, fuse_norm=False)),
            ("augment via K5", lambda: aug(use_pallas=True, fuse_norm=True)),
            ("step via K4", lambda: step(False)), ("step via K5", lambda: step(True)))}
        if ops["augment via K5"] > AUGMENT_K5_OPS:
            raise AssertionError(f"augment_batch via K5 ran {ops['augment via K5']} device "
                                 f"operations, above its ceiling {AUGMENT_K5_OPS}")
        # the kernels alone (events, dispatch included) and with their
        # arguments, against their plain versions
        geo = augment_geometry(drawn, batch["com"], batch["cube"], batch["m"], cam, modes3,
                               (128, 128))
        img, _ = hw.unnormalize(batch["crops"], geo.norm)
        p6 = hw.warp_patch_params(geo.a_fwd)
        k4_plain, k4 = alternate(lambda: hw.warp_patch_plain(img, p6, 0.0, NV_VAL),
                                 lambda: hw.launch_warp(img, p6, 0.0, NV_VAL), 50)
        wrap_plain, wrap_k4 = alternate(
            lambda: hw.warp_patch_plain(img, hw.warp_patch_params(geo.a_fwd), 0.0, NV_VAL),
            lambda: hw.hopper_warp_patch(img, geo.a_fwd, nv_val=NV_VAL), 50)
        k5_in = (batch["crops"], drawn, batch["com"], batch["cube"], batch["m"], cam, modes3)
        args5 = hw.warp_norm_args(*k5_in)

        def plain5():
            g = augment_geometry(drawn, batch["com"], batch["cube"], batch["m"], cam, modes3,
                                 (128, 128))
            return hw.warp_norm_plain(batch["crops"], hw.warp_norm_params(g.a_fwd, g.norm),
                                      0.0, NV_VAL)

        k5 = time_ms(lambda: hw.launch_warp_norm(batch["crops"], args5, 0.0, NV_VAL), iters=50)
        wrap5_plain, wrap_k5 = alternate(
            plain5, lambda: hw.launch_warp_norm(batch["crops"], hw.warp_norm_args(*k5_in),
                                                0.0, NV_VAL), 50)
        crops, labels = aug()[:2]
        tr, st = trainers[True]
        y = tr.family.targets(labels)
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
                            wrap_k5=wrap_k5, wrap5_plain=wrap5_plain, k5=k5,
                            faster=aug5 < aug4)
        log(f"[10 timing] {tag} train step B={bsz} (in turns): via K4 {step4:.4f} ms = "
            f"{bsz / (step4 / 1e3):.1f} samples/s, via K5 {step5:.4f} ms = "
            f"{bsz / (step5 / 1e3):.1f} samples/s; augment_batch (in turns) via K4 "
            f"{aug4:.4f} ms, via K5 {aug5:.4f} ms ({aug4 / aug5:.2f}x), via the gather "
            f"warp {aug_gather:.4f} ms; K5 == K4's unfused path on the same draws (all 5 "
            f"outputs, torch.equal); device operations per call: "
            + ", ".join(f"{k} {v}" for k, v in ops.items())
            + f"; K4 alone {k4:.4f} ms vs plain {k4_plain:.4f} ms (with params: "
            f"{wrap_k4:.4f} vs {wrap_plain:.4f} ms); K5 alone {k5:.4f} ms, with its args "
            f"{wrap_k5:.4f} ms vs plain augment_geometry + warp_norm_plain "
            f"{wrap5_plain:.4f} ms; forward + backward {fb_ms:.4f} ms; optimizer "
            f"{opt_ms:.4f} ms")
        if profile:
            for label, fn in (
                    ("train step via K4", lambda: step(False)),
                    ("train step via K5", lambda: step(True)),
                    ("augment via K4", lambda: aug(use_pallas=True, fuse_norm=False)),
                    ("augment via K5", lambda: aug(use_pallas=True, fuse_norm=True)),
                    ("forward + backward", fwd_bwd),
                    ("optimizer", opt.step)):
                profile_stage(f"{tag} {label} B={bsz}", fn, 10, log)
    held = all(t["faster"] for t in timings.values())
    log(f"[10 default] fuse_norm=None takes K5; this run: augment via K5 "
        f"{'faster' if held else 'NOT faster'} than via K4 at B=128 and 512 and "
        f"bit-equal to it: the default {'holds' if held else 'is contradicted'}")

    t = timings[128]
    return [
        {"name": "warp_patch", "route": "cuda",
         "source": "deepprior_tpu_torch/csrc/warp.cu",
         "replaces": "deepprior_tpu/ops/pallas_warp.py:293",
         "launches": main_launches["warp_patch"], "max_abs_err": err["warp_patch"],
         "ms": t["wrap_k4"], "plain_ms": t["wrap_plain"], "kernel_only_ms": t["k4"]},
        {"name": "warp_norm", "route": "cuda",
         "source": "deepprior_tpu_torch/csrc/warp.cu",
         "replaces": "deepprior_tpu/ops/pallas_warp.py:150",
         "launches": main_launches["warp_norm"], "max_abs_err": err["warp_norm"],
         "ms": t["wrap_k5"], "plain_ms": t["wrap5_plain"], "kernel_only_ms": t["k5"]},
    ]


def realtime_phases(dev, tag, log, model, prior, batch=512, n_det=64, n_cpu=16):
    """Phases 12-16: K2 against its plain version, the 'linear' estimator
    through K2 at B = 512, detection and refinement on the card at B =
    ``n_det`` (the first ``n_cpu`` frames also on the CPU, the slow side of
    the comparison), the realtime pipeline and the demo main, and their
    timings.  ``model``
    is the full-width bf16 PoseRegNet of phase 4.  Returns K2's JSON
    record."""
    import os

    import torch

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data.detector_np import HandCropper
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.device import float32_compute
    from deepprior_tpu_torch.models import PoseRegNet, ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.ops import com as tcom
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops.crop import clamp_depth, normalized_crop
    from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
    from deepprior_tpu_torch.realtime.camera import SyntheticDevice
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.realtime.pipeline import (
        HAND_RIGHT, STATE_RUN, RealtimeHandposePipeline)

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
    # b64 distinct frames on the card, the first n_cpu also detected on the
    # CPU (each frame's detection is its own: clamp limits per image)
    depth_6, com_6 = frames(cam, b64)
    cpu_6 = depth_6[:n_cpu].cpu()
    dc6, dmin6, dmax6 = clamp_depth(depth_6)
    det_dev = tcom.detect_closest(dc6, cube, cam.fx, cam.fy, min_depth=dmin6,
                                  max_depth=dmax6)
    dcc, dminc, dmaxc = clamp_depth(cpu_6)
    det_cpu = tcom.detect_closest(dcc, cube, cam.fx, cam.fy, min_depth=dminc,
                                  max_depth=dmaxc)
    full_dev = tcom.detect(depth_6, cube, cam.fx, cam.fy)
    full_cpu = tcom.detect(cpu_6, cube, cam.fx, cam.fy)
    com_err = max((det_dev[:n_cpu].cpu() - det_cpu).abs().max().item(),
                  (full_dev[:n_cpu].cpu() - full_cpu).abs().max().item())
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
        cerr = (c3[:n_cpu].cpu() - ce(cpu_6, com_6[:n_cpu].cpu())[1]).abs().max().item()
        if cerr > 0.5 or not torch.isfinite(joints).all():
            raise AssertionError(f"{label}: CoM vs CPU {cerr} mm")
        com_err = max(com_err, cerr)
        log(f"[14 detection] {label} B={b64}: launches {got}, crops and CoMs == "
            f"plain path, com3d vs CPU (first {n_cpu}) max |d| {cerr} mm")
    log(f"[14 detection] detect_closest and detect (slice scan) on the card at "
        f"B={b64} distinct frames vs the CPU on the first {n_cpu}: max |d| {com_err} "
        f"px/mm (bound 0.5)")

    # --------------------------------------------------------------- 15
    scalenet = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3, hidden=1024),
                        generator=torch.Generator().manual_seed(3)).to(dev)
    refiner = CNNComRefiner(scalenet, cam)
    # the f32 refiner on the card against a CPU copy, on phase 14's frames
    # and detected CoMs; a TF32 run of the same net shows what a leak of
    # TF32 into the refiner would cost
    cpu_scalenet = copy.deepcopy(scalenet).cpu()
    ref_err = (refiner(dc6, det_dev, cube)[:n_cpu].cpu()
               - CNNComRefiner(cpu_scalenet, cam)(dcc, det_dev[:n_cpu].cpu(), cube)
               ).abs().max().item()
    crops6 = hopper_crop.hopper_normalized_crop(dc6, det_dev, cube, cam.fx, cam.fy)[0]
    with torch.inference_mode():
        off_cpu = cpu_scalenet(crops6[:n_cpu].cpu()[:, None])
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
    f32_mm = (off_f32[:n_cpu] - off_cpu).abs().max().item() * cube[2] / 2.0
    tf32_mm = (off_tf32[:n_cpu] - off_cpu).abs().max().item() * cube[2] / 2.0
    if ref_err > 0.5 or not f32_mm < tf32_mm:
        raise AssertionError(f"ScaleNet refiner on the card vs CPU: {ref_err} px/mm, "
                             f"offset {f32_mm} mm (TF32 run: {tf32_mm} mm)")
    log(f"[15 refiner] CNNComRefiner (ScaleNet hidden 1024 f32) on the card vs a CPU "
        f"copy, B={b64} (the first {n_cpu} on the CPU): refined CoMs max |d| {ref_err} "
        f"px/mm (bound 0.5); offsets "
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
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
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


def label_phase(dev, tag, log, nyu_frames=64, icvl_frames=32, batch=8, cpu_frames=8):
    """Phase 49, run after phase 16: the label kernel K8 (csrc/label.cu) on
    the card.  Its labels equal the plain scan's (``ops.com.label_scan``, on
    the card) bit for bit on ``hopper_label.hard_masks`` (their regions also
    as int64 and uint8) and on ``nyu_frames`` rendered NYU and
    ``icvl_frames`` ICVL frames with detect's slice index as region, at B =
    1 and B = ``batch``; one launch is counted a labeling call; a CUDA graph
    of ``label_components`` replays the eager labels; ``detect`` through K8
    equals ``detect`` through the plain scan on the card and the CPU's on
    the first ``cpu_frames`` NYU frames within phase 14's bound.  Then K8
    alone from a CUDA graph at 640x480 B = 1 and B = ``batch`` beside its
    byte bound and the plain scan, and ``detect`` at B = 1 through each, in
    turns.  Returns K8's JSON record."""
    import torch

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.ops import com as tcom
    from deepprior_tpu_torch.ops import hopper_label
    from deepprior_tpu_torch.ops.crop import _div, clamp_depth
    from deepprior_tpu_torch.utils import profiling
    from deepprior_tpu_torch.utils.flops import roofline_ms

    rng = np.random.default_rng(49)
    cam = NYU_CAMERA
    cube = (250.0, 250.0, 250.0)
    launches = hopper_label.LAUNCHES

    def frames(c, n):
        raw = np.stack([make_depth_frame(c, rng)[0] for _ in range(n)])
        return torch.from_numpy(raw).to(dev)

    def slices(raw, num_slices):
        """detect's foreground and slice index (ops/com.py::detect)."""
        dc, dmin, dmax = clamp_depth(raw)
        dz = torch.clamp(_div(dmax - dmin, float(num_slices)), min=1e-6)
        q = torch.floor((dc - dmin[:, None, None]) / dz[:, None, None])
        return dc > 0.0, q.clamp(0, num_slices - 1).to(torch.int32)

    def scan(mask, region):
        """The plain scan's labels and the passes it took."""
        with profiling.recording(), profiling.span("label_scan"):
            lab = tcom.label_scan(mask, region)
        return lab, profiling.spans()[-1].attrs["passes"]

    cases, passes = [], {}

    def check(label, mask, region=None):
        before = launches["label"]
        got = tcom.label_components(mask, region)
        if launches["label"] != before + 1:
            raise AssertionError(f"K8 {label}: {launches['label'] - before} launches "
                                 f"counted for one call")
        want, n_passes = scan(mask, region)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K8 {label}: labels != the plain scan's on "
                                 f"{int((got != want).sum())} of {got.numel()} pixels")
        cases.append(label)
        passes.setdefault(label.split(" #")[0], []).append(n_passes)

    def with_plain_scan(fn):
        """fn() with detect labelling through the plain scan."""
        kernel = tcom.label_components
        tcom.label_components = tcom.label_scan
        try:
            return fn()
        finally:
            tcom.label_components = kernel

    for name, mask, region in hopper_label.hard_masks():
        m = torch.from_numpy(mask).to(dev)
        if region is None:
            check(name, m)
            continue
        for dtype in (torch.int32, torch.int64, torch.uint8):
            check(f"{name}, {dtype} regions", m, torch.from_numpy(region).to(dev, dtype))
    n_hard = len(cases)
    nyu, icvl = frames(cam, nyu_frames), frames(ICVL_CAMERA, icvl_frames)
    split = {}
    for label, raw, num_slices in (("NYU 640x480", nyu, 20), ("ICVL 320x240", icvl, 10)):
        mask, q = split[label] = slices(raw, num_slices)
        for i in range(len(raw)):
            check(f"{label} {num_slices} slices B=1 #{i}", mask[i:i + 1], q[i:i + 1])
        for i in range(0, len(raw), batch):
            check(f"{label} {num_slices} slices B={batch} #{i}", mask[i:i + batch],
                  q[i:i + batch])
    log(f"[49 K8 vs plain] {len(cases)} cases bit-exact (torch.equal): {n_hard} hard masks "
        f"and their region dtypes, {nyu_frames} NYU and {icvl_frames} ICVL frames at B=1 "
        f"and B={batch}; one launch counted a call; plain scan passes "
        + "; ".join(f"{k}: mean {np.mean(v):.2f}, max {max(v)}" for k, v in passes.items()
                    if "B=" in k))

    # the labeling captures into a CUDA graph: nothing on it reads back
    mask, q = split["NYU 640x480"]
    for bsz in (1, batch):
        m, r = mask[:bsz], q[:bsz]
        replayed = graph_outputs(lambda: (tcom.label_components(m, r),))[0]
        eager = tcom.label_components(m, r)
        torch.cuda.synchronize()
        if not torch.equal(replayed, eager):
            raise AssertionError(f"K8 B={bsz}: the CUDA-graph replay differs from eager")
    # detect through K8 against detect through the plain scan (the card) and
    # the CPU's (the reductions' order differs: phase 14's bound)
    for label, raw, c in (("NYU", nyu, cam), ("ICVL", icvl, ICVL_CAMERA)):
        for i in range(0, len(raw), batch):
            chunk = raw[i:i + batch]
            got = tcom.detect(chunk, cube, c.fx, c.fy)
            want = with_plain_scan(lambda: tcom.detect(chunk, cube, c.fx, c.fy))
            if not torch.equal(got, want):
                raise AssertionError(f"detect {label} #{i}: K8 route != plain scan route by "
                                     f"{(got - want).abs().max().item()}")
    on_card = tcom.detect(nyu[:cpu_frames], cube, cam.fx, cam.fy).cpu()
    on_cpu = tcom.detect(nyu[:cpu_frames].cpu(), cube, cam.fx, cam.fy)
    det_err = (on_card - on_cpu).abs().max().item()
    if det_err > 0.5:
        raise AssertionError(f"detect on the card differs from the CPU's by {det_err}")
    launches["label"] = 0
    tcom.detect(nyu[:1], cube, cam.fx, cam.fy)
    per_detect = launches["label"]
    if per_detect != 1:
        raise AssertionError(f"detect at B=1 counted {per_detect} label launches")
    log(f"[49 K8 graph, detect] a CUDA graph of label_components replays the eager labels "
        f"at B=1 and B={batch}; detect through K8 == detect through the plain scan on "
        f"{nyu_frames} NYU and {icvl_frames} ICVL frames (B={batch}); card vs CPU on "
        f"{cpu_frames} NYU frames max |d| {det_err} px/mm (bound 0.5); {per_detect} "
        f"launch per detect call")

    # ----------------------------------------------------------- timing
    kernel_ms = {}
    for bsz in (1, batch):
        args = hopper_label.label_args(mask[:bsz], q[:bsz])
        kernel_ms[bsz] = graph_ms(lambda: hopper_label.launch_label(args), iters=50)
    m1, q1 = mask[:1], q[:1]
    plain_ms = time_ms(lambda: tcom.label_scan(m1, q1), iters=10)

    def host_ms(fn, iters):
        runs = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(runs))

    d1 = nyu[:1]
    plain_det_ms, det_ms = alternate(
        lambda: with_plain_scan(lambda: tcom.detect(d1, cube, cam.fx, cam.fy)),
        lambda: tcom.detect(d1, cube, cam.fx, cam.fy), 15, host_ms)
    # one read of the mask (1 B) and the region (4 B), one write of the labels (4 B)
    n_bytes = {b: mask[:b].numel() * (1 + 4 + 4) for b in kernel_ms}
    bound, bound_by = roofline_ms(n_bytes[1])
    for bsz, ms in kernel_ms.items():
        b_ms = roofline_ms(n_bytes[bsz])[0]
        log(f"[49 timing] {tag} K8 640x480 B={bsz}: {ms:.4f} ms alone (CUDA graph of 50); "
            f"{n_bytes[bsz]} B, bound {b_ms:.6f} ms by bytes, share {b_ms / ms:.4f}")
    log(f"[49 timing] {tag} plain scan 640x480 B=1 {plain_ms:.4f} ms (CUDA events, its host "
        f"syncs included); detect B=1 through K8 {det_ms:.4f} ms vs through the plain scan "
        f"{plain_det_ms:.4f} ms (median, host clock, in turns)")
    return {"name": "label", "route": "cuda", "source": "deepprior_tpu_torch/csrc/label.cu",
            "replaces": "none: deepprior_tpu/ops/com.py:244 label_components is a "
                        "lax.while_loop of segmented scans, plain XLA",
            "launches": len(cases), "max_abs_err": 0.0, "kernel_only_ms": kernel_ms[1],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library": "none: PyTorch has no connected-components call",
            "launches_per_call": per_detect, "detect_ms": det_ms,
            "detect_plain_ms": plain_det_ms}


def v2v_phase(dev, tag, log, batch=8, frames=24, steps=3, timed_steps=10, grid=88):
    """Phase 50, run after phase 49: V2V-PoseNet's train step (models/v2v.py,
    ops/voxel.py) on the card at B = ``batch`` and the published 88^3 grid,
    with random He weights, on ``frames`` synthetic NYU crops (no
    augmentation, so the reference gets the same inputs).  ``steps`` steps
    of the port's Trainer (RMSProp) against ``tests/plain_v2v.py`` on the
    card from the same weights and rows: each step's loss, the first
    step's gradients and the parameters' change over the steps, read as the
    cell ``v2v_nyu.train_b8`` reads them and held to its limits
    (bench_torch/workloads/v2v_nyu.train_b8.json).  Then the step's time
    (host clock around ``timed_steps`` synchronised steps), its device time
    (torch.profiler, the union of the device's operations; K9's share and
    that of cuDNN's ``wgrad2d_grouped_direct_kernel``), its memory
    peak, and ``voxelize`` and ``heatmap_targets`` alone from CUDA graphs
    beside their byte bounds.  ``grid`` (with the published margin of 4
    voxels a side) is for a rehearsal on the CPU.  Returns the phase's
    figures, with ``train_steps``, the port's steps it ran (phase 51 holds
    K9's launch count to it)."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.models import V2VConfig, V2VPoseNet
    from deepprior_tpu_torch.ops import hopper_conv3d, hopper_stem, voxel
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer
    from deepprior_tpu_torch.utils.flops import roofline_ms

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "plain_v2v", os.path.join(here, "tests", "plain_v2v.py"))
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)
    with open(os.path.join(here, "bench_torch", "workloads", "v2v_nyu.train_b8.json")) as fh:
        limits = json.load(fh)["limits"]

    cam = NYU_CAMERA
    pin = (cam.fx, cam.fy, cam.ux, cam.uy, cam.flip_y)
    seq = make_sequence(cam, frames, num_joints=14, cube=(300.0, 300.0, 300.0), seed=50)
    data = TrainData.from_sequence(seq).to(dev)
    gen = torch.Generator().manual_seed(50)
    vcfg = V2VConfig(grid=grid, cube_voxels=grid + 8)
    net = V2VPoseNet(vcfg)
    with torch.no_grad():  # He-normal kernels, as the benchmark draws them
        for p in net.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, float(np.sqrt(2.0 / (p.numel() // p.shape[0]))), generator=gen)
    start = {k: v.detach().clone().to(dev) for k, v in net.state_dict().items()}
    trainer = Trainer(net.to(dev), TrainConfig(batch_size=batch, optimizer="rmsprop",
                                               aug_modes=None, seed=50), cam, device=dev)
    state = trainer.init_state(state_dict=start)
    lr = 2.5e-5  # lr_of_ep(0) of V2V's 2.5e-4
    rows = [torch.arange(s * batch, (s + 1) * batch, device=dev) % data.n for s in range(steps)]
    hopper_stem.LAUNCHES["stem_wgrad"] = 0
    hopper_conv3d.LAUNCHES["conv3d_wgrad"] = 0
    losses, grad1 = [], None
    for s in range(steps):
        state, loss = trainer.train_step(state, data.take(rows[s]), None, None, lr)
        losses.append(float(loss))
        if grad1 is None:
            grad1 = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
    delta = {k: p.detach() - start[k] for k, p in state.model.named_parameters()}

    params = {k: start[k].clone().requires_grad_(True) for k in delta}
    w = dict(start, **params)
    opt = plain.RMSProp(params)
    ref_losses, ref_g1 = [], None
    for s in range(steps):
        b = data.take(rows[s])
        x = plain.voxelize(b["crops"], b["com"], b["cube"], b["m"], pin, grid, grid + 8)
        y = plain.heatmap_targets(b["gt3d_crop"] / (b["cube"][:, 2] / 2.0)[:, None, None],
                                  grid, grid + 8)
        with plain.plain_float32():
            value = plain.loss(plain.net(w, x[:, None], train=True), y)
            grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        if ref_g1 is None:
            ref_g1 = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads, lr)
        ref_losses.append(float(value.detach()))
    ref_delta = {k: params[k].detach() - start[k] for k in params}

    def gaps(prog, ref, names):
        rn = {k: float(ref[k].double().norm()) for k in names}
        med = float(np.median(list(rn.values())))
        return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med) for k in names}

    g_norms = {k: float(v.double().norm()) for k, v in ref_g1.items()}
    med = float(np.median(list(g_norms.values())))
    moving = [k for k, v in g_norms.items() if v >= 1e-3 * med]
    readings = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                "grad_norm_gap": max(gaps(grad1, ref_g1, list(ref_g1)).values()),
                "step_norm_gap": max(gaps(delta, ref_delta, moving).values())}
    log(f"[50 v2v] {tag} B={batch} {grid}^3, {steps} steps against tests/plain_v2v.py: losses "
        f"{[f'{v:.6g}' for v in losses]} (reference {[f'{v:.6g}' for v in ref_losses]}); "
        + ", ".join(f"{k} {v:.3g} (limit {limits[k]:g})" for k, v in readings.items()))
    for k, v in readings.items():
        if not v <= limits[k]:
            raise AssertionError(f"phase 50: {k} {v:.3g} above the cell's limit {limits[k]:g}")

    b = data.take(rows[0])

    def one_step():
        nonlocal state
        state, _ = trainer.train_step(state, b, None, None, lr)

    one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if is_device_op(e))
    busy, end = 0, None
    for s0, s1 in spans:
        if end is None or s0 > end:
            busy, end = busy + (s1 - s0), s1
        elif s1 > end:
            busy, end = busy + (s1 - end), s1
    device_ms = busy / 3 / 1e3  # the profiler's times are in us
    # a step's device ms in K9's and K10's kernels and in cuDNN's dense
    # weight gradient that they took the stem's and the 44^3 layers' shares of
    by_name = Counter()
    for e in prof.events():
        if is_device_op(e):
            name = "K9" if "stem_wgrad" in e.name else "K10" if "conv3d_wgrad" in e.name else (
                "wgrad2d_grouped_direct_kernel" if "wgrad2d_grouped_direct" in e.name else None)
            if name:
                by_name[name] += (e.time_range.end - e.time_range.start) / 3 / 1e3
    # the step's dense model flops, forward and weight gradients, from the
    # reference on the meta device (the port's stem gathers its weight
    # gradient over the set voxels, which a meta tensor does not have)
    meta_w = {k: torch.empty(v.shape, device="meta", requires_grad=v.dim() >= 1
                             and k in delta) for k, v in start.items()}
    counter = FlopCounterMode(display=False)
    with counter:
        plain.net(meta_w, torch.empty((batch, 1, grid, grid, grid), device="meta")).sum().backward()
    flops = counter.get_total_flops()
    labels = b["gt3d_crop"] / (b["cube"][:, 2] / 2.0)[:, None, None]
    vox_ms = graph_ms(lambda: voxel.voxelize(b["crops"], b["com"], b["cube"], b["m"], cam,
                                             grid, grid + 8), iters=50)
    heat_ms = graph_ms(lambda: voxel.heatmap_targets(labels, grid, grid + 8), iters=50)
    vox_bytes = b["crops"].numel() * 4 + batch * (grid ** 3 + 1) * 4
    heat_bytes = batch * 14 * (grid // 2) ** 3 * 4
    vox_bound = roofline_ms(vox_bytes, device=dev)[0]
    heat_bound = roofline_ms(heat_bytes, device=dev)[0]
    log(f"[50 v2v] {tag} train step B={batch}: {step_ms:.3f} ms (host clock, {timed_steps} "
        f"synchronised steps), device busy {device_ms:.3f} ms a step "
        f"({100 * device_ms / step_ms:.1f}%), {flops / step_ms / 1e9:.2f} TFLOP/s of "
        f"{flops / 1e12:.4g} TFLOP a step (K9 {by_name['K9']:.4f} ms a step, K10 "
        f"{by_name['K10']:.3f} ms, wgrad2d_grouped_direct_kernel "
        f"{by_name['wgrad2d_grouped_direct_kernel']:.3f} ms); "
        f"memory peak {peak / 1e9:.3f} GB; voxelize alone {vox_ms:.4f} ms "
        f"({100 * vox_bound / vox_ms:.1f}% of its {vox_bound:.4f} ms byte bound), "
        f"heatmap_targets {heat_ms:.4f} ms ({100 * heat_bound / heat_ms:.1f}% of "
        f"{heat_bound:.4f} ms)")
    return {"readings": readings, "step_ms": step_ms, "device_ms": device_ms,
            "peak_bytes": peak, "voxelize_ms": vox_ms, "heatmap_ms": heat_ms,
            "train_steps": steps + 1 + timed_steps + 3, "k9_ms_a_step": by_name["K9"],
            "k10_ms_a_step": by_name["K10"]}


def stem_phase(dev, tag, log, train_steps, batch=8, frames=24, grid=88, dense_iters=3):
    """Phase 51, run after phase 50: the stem's weight-gradient kernel K9
    (csrc/stem_wgrad.cu) on the card.  Phase 50's ``train_steps`` steps
    each launched it once (``hopper_stem.LAUNCHES``).  On ``frames``
    synthetic NYU crops voxelized at B = ``batch`` and the published grid,
    on a random 5% grid of values in [0.5, 1.5), on an empty grid and on a
    full one of such values, against a random dy, K9 equals the plain
    gather (``hopper_stem.stem_wgrad_plain``, on the card) within float32
    round-off of a sum taken in another order: |K9 - plain| <= 1e-5 of
    sum |x dy| for each weight (the random signs of dy keep the round-off
    near 2^-24 of that sum), 0 where that sum is 0; bfloat16 the same plus
    one bfloat16 ulp of the result (both round their float32 sums).  A full
    grid of ones against dy = 1 gives each weight the exact count of its
    (voxel, tap) pairs inside the grid (under 2^24, so float32 holds every
    partial sum): a brick skipped or taken twice shows.  Two launches and a
    CUDA graph's replay are equal bit for bit.  Then K9 alone from CUDA
    graphs on the voxelized grids, the empty and the full one beside its
    bound (x read once, the dy values within the set voxels' 7^3 windows
    and dW written once; 2 x 16 operations a (set voxel, tap) pair inside
    the grid), cuDNN's ``torch.nn.grad.conv3d_weight`` (its yardstick;
    ``dense_iters`` calls a graph, it takes about 140 ms) and the plain
    gather.  Returns K9's JSON record."""
    import torch
    import torch.nn.functional as F

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.ops import hopper_stem, voxel
    from deepprior_tpu_torch.train.trainer import TrainData
    from deepprior_tpu_torch.utils.flops import roofline_ms

    launches = hopper_stem.LAUNCHES
    per_step = launches["stem_wgrad"]
    if per_step != train_steps:
        raise AssertionError(f"phase 50's {train_steps} train steps launched K9 {per_step} times")
    cam = NYU_CAMERA
    seq = make_sequence(cam, frames, num_joints=14, cube=(300.0, 300.0, 300.0), seed=51)
    data = TrainData.from_sequence(seq).to(dev)
    shape = (batch, 1, grid, grid, grid)
    grids = []
    for i in range(0, frames, batch):
        b = data.take(torch.arange(i, i + batch, device=dev))
        grids.append(voxel.voxelize(b["crops"], b["com"], b["cube"], b["m"], cam, grid,
                                    grid + 8)[:, None].contiguous())
    gen = torch.Generator(dev).manual_seed(51)
    dy = torch.randn((batch, hopper_stem.CHANNELS, grid, grid, grid), generator=gen, device=dev)
    values = torch.rand(shape, generator=gen, device=dev) + 0.5
    sparse = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.05, values, 0.0)
    cases = [(f"voxelized #{i}", g) for i, g in enumerate(grids)] + [
        ("random 5%", sparse), ("empty", torch.zeros(shape, device=dev)), ("full", values)]
    occupancy = [float((g != 0).float().mean()) for g in grids]

    def kernel(x, d):
        return hopper_stem.launch_stem_wgrad(hopper_stem.stem_wgrad_args(x, d))

    worst = {}
    for label, x in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and not label.startswith("voxelized"):
                continue
            xc, dc = x.to(dtype), dy.to(dtype)
            before = launches["stem_wgrad"]
            got = kernel(xc, dc).float()
            if launches["stem_wgrad"] != before + 1:
                raise AssertionError(f"K9 {label}: {launches['stem_wgrad'] - before} launches "
                                     f"counted for one call")
            want = hopper_stem.stem_wgrad_plain(xc, dc).float()
            scale = hopper_stem.stem_wgrad_plain(xc.float().abs(), dc.float().abs())
            tol = 1e-5 * scale
            if dtype == torch.bfloat16:
                tol = tol + want.abs() * 2.0 ** -8
            err = (got - want).abs()
            if not torch.all(err <= tol):
                raise AssertionError(f"K9 {label} {dtype}: {int((err > tol).sum())} of 5488 "
                                     f"weights off the plain gather, worst "
                                     f"{float((err / scale.clamp_min(1e-30)).max()):.3g} of "
                                     f"sum |x dy|")
            worst[f"{label} {dtype}"] = float((err / scale.clamp_min(1e-30)).max())
    # a full grid of ones against dy = 1: exact counts
    ones = torch.ones(shape, device=dev)
    got = kernel(ones, torch.ones_like(dy))
    inside = torch.tensor([grid - abs(k - hopper_stem.PAD) for k in range(hopper_stem.SIDE)],
                          dtype=torch.float64)
    count = batch * inside[:, None, None] * inside[None, :, None] * inside[None, None, :]
    if not torch.equal(got.cpu().double(), count.expand(hopper_stem.CHANNELS, 1, -1, -1, -1)):
        raise AssertionError("K9 on a full grid of ones against dy = 1 misses the exact counts")
    x0 = grids[0]
    first, second = kernel(x0, dy), kernel(x0, dy)
    replayed = graph_outputs(lambda: (kernel(x0, dy),))[0]
    torch.cuda.synchronize()
    if not (torch.equal(first, second) and torch.equal(first, replayed)):
        raise AssertionError("K9: two launches or a CUDA graph's replay differ")
    checked = launches["stem_wgrad"] - per_step
    log(f"[51 K9 vs plain] {len(worst)} cases within float32 round-off of the plain gather "
        f"(worst |K9 - plain| / sum |x dy| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"); the full grid of ones exact; two launches and a graph replay equal; "
          f"{per_step} launches in phase 50's {train_steps} train steps; voxelized occupancy "
          f"{', '.join(f'{100 * o:.4f}%' for o in occupancy)}")

    # ----------------------------------------------------------- timing
    def cost(x):
        """(bytes, float32 operations) the weight gradient needs on x."""
        set_ = (x != 0).float()
        near = F.max_pool3d(set_, hopper_stem.SIDE, 1, hopper_stem.PAD)  # within a window
        n_bytes = x.numel() * 4 + int(near.sum()) * hopper_stem.CHANNELS * 4 \
            + hopper_stem.CHANNELS * hopper_stem.SIDE ** 3 * 4
        q = torch.arange(grid, device=dev)
        taps = (torch.clamp(q + hopper_stem.PAD, max=hopper_stem.SIDE - 1)
                - torch.clamp(q + hopper_stem.PAD - grid + 1, min=0) + 1).float()
        pairs = (set_[:, 0] * taps[:, None, None] * taps[None, :, None]
                 * taps[None, None, :]).sum()
        return n_bytes, 2 * hopper_stem.CHANNELS * float(pairs)

    timed = {"voxelized": grids[0], "empty": cases[-2][1], "full": values}
    kernel_ms, bounds = {}, {}
    for label, x in timed.items():
        args = hopper_stem.stem_wgrad_args(x, dy)
        kernel_ms[label] = graph_ms(lambda: hopper_stem.launch_stem_wgrad(args),
                                    iters=dense_iters if label == "full" else 50)
        n_bytes, ops = cost(x)
        bounds[label] = (n_bytes, ops, *roofline_ms(n_bytes, ops, device=dev))
    library_ms = {label: graph_ms(lambda: torch.nn.grad.conv3d_weight(
        timed[label], hopper_stem.WEIGHT_SHAPE, dy, padding=hopper_stem.PAD), iters=dense_iters)
        for label in ("voxelized", "full")}
    plain_ms = time_ms(lambda: hopper_stem.stem_wgrad_plain(grids[0], dy), iters=3, warmup=1)
    for label, ms in kernel_ms.items():
        n_bytes, ops, b_ms, by = bounds[label]
        log(f"[51 timing] {tag} K9 B={batch} {grid}^3 {label}: {ms:.4f} ms alone (CUDA graph); "
            f"{n_bytes} B, {ops:.4g} operations, bound {b_ms:.6f} ms by {by}, share "
            f"{b_ms / ms:.4f}")
    log(f"[51 timing] {tag} cuDNN conv3d_weight (library) voxelized {library_ms['voxelized']:.3f} "
        f"ms, full {library_ms['full']:.3f} ms (CUDA graphs of {dense_iters}); K9 full "
        f"{kernel_ms['full']:.3f} ms beside it; plain gather {plain_ms:.3f} ms (CUDA events, its "
        f"host syncs included)")
    return {"name": "stem_wgrad", "route": "cuda", "source": "deepprior_tpu_torch/csrc/stem_wgrad.cu",
            "replaces": "none: the JAX package has no V2V-PoseNet; cuDNN's dense weight gradient",
            "launches": checked, "max_rel_err": max(worst.values()),
            "kernel_only_ms": kernel_ms["voxelized"], "empty_ms": kernel_ms["empty"],
            "full_ms": kernel_ms["full"], "plain_ms": plain_ms,
            "bound_ms": bounds["voxelized"][2], "bound_by": bounds["voxelized"][3],
            "bytes": bounds["voxelized"][0], "library_ms": library_ms["voxelized"],
            "library_full_ms": library_ms["full"], "launches_per_call": 1,
            "phase_50_launches": per_step}


def wgrad_phase(dev, tag, log, train_steps, batch=8, side=44, library_iters=3):
    """Phase 52, run after phase 51: K10 (csrc/conv3d_wgrad.cu), the weight
    gradient of V2V-PoseNet's convolutions that ``hopper_conv3d.takes``, on
    the card.  Phase 50's ``train_steps`` steps each launched it 14 times
    (``hopper_conv3d.LAUNCHES``).  At the five distinct shapes of those 14
    layers (B = ``batch``, a ``side``^3 volume; x a ReLU's output, dy of
    either sign) K10 equals the plain version (``conv3d_wgrad_plain`` in
    float64 on the card) within float32 round-off of a sum taken in another
    order: |K10 - plain| <= 1e-5 of sum |x dy| for each weight (a block sums
    about 5,000 products in turn, then 132 or 264 rows are added: the random
    signs of dy keep the round-off near 2^-24 x sqrt(5,000) of that sum);
    bfloat16 inputs the same plus one bfloat16 ulp of the result (K10 rounds
    its float32 sum once).  Two launches and a CUDA graph's replay are equal
    bit for bit.  Then each shape alone from CUDA graphs beside its bound
    (operations for 3^3, bytes for 1^3: x and dy read once) and cuDNN's
    ``torch.nn.grad.conv3d_weight`` with TF32 off (the yardstick, never
    called by the port), and the plain version in float32.  Returns K10's
    JSON record."""
    import torch

    from deepprior_tpu_torch.device import float32_compute
    from deepprior_tpu_torch.ops import hopper_conv3d as hc
    from deepprior_tpu_torch.utils.flops import roofline_ms

    launches = hc.LAUNCHES
    per_step = launches["conv3d_wgrad"]
    if per_step != 14 * train_steps:
        raise AssertionError(f"phase 50's {train_steps} train steps launched K10 {per_step} "
                             f"times, not 14 a step")
    # (layers of V2V at 44^3 of this shape, input channels, output channels, side)
    shapes = [(1, 16, 32, 3), (9, 32, 32, 3), (1, 16, 32, 1), (2, 32, 32, 1), (1, 32, 14, 1)]
    gen = torch.Generator(dev).manual_seed(52)
    worst, timing = {}, []
    for count, cin, cout, k in shapes:
        x = torch.relu(torch.randn((batch, cin, side, side, side), generator=gen, device=dev))
        dy = torch.randn((batch, cout, side, side, side), generator=gen, device=dev)
        label = f"{cin}->{cout} {k}^3"
        for dtype in (torch.float32, torch.bfloat16):
            xc, dc = x.to(dtype), dy.to(dtype)
            before = launches["conv3d_wgrad"]
            got = hc.conv3d_weight_grad(xc, dc, k).double()
            if launches["conv3d_wgrad"] != before + 1:
                raise AssertionError(f"K10 {label}: {launches['conv3d_wgrad'] - before} "
                                     f"launches counted for one call")
            want = hc.conv3d_wgrad_plain(xc.double(), dc.double(), k)
            scale = hc.conv3d_wgrad_plain(xc.double().abs(), dc.double().abs(), k)
            tol = 1e-5 * scale
            if dtype == torch.bfloat16:
                tol = tol + want.abs() * 2.0 ** -8
            err = (got - want).abs()
            if not torch.all(err <= tol):
                raise AssertionError(f"K10 {label} {dtype}: {int((err > tol).sum())} of "
                                     f"{err.numel()} weights off the plain version, worst "
                                     f"{float((err / scale.clamp_min(1e-30)).max()):.3g} of "
                                     f"sum |x dy|")
            worst[f"{label} {dtype}"] = float((err / scale.clamp_min(1e-30)).max())
        args = hc.conv3d_wgrad_args(x, dy, k)
        first = hc.launch_conv3d_wgrad(args).clone()
        second = hc.launch_conv3d_wgrad(args).clone()
        replayed = graph_outputs(lambda: (hc.launch_conv3d_wgrad(args),))[0]
        torch.cuda.synchronize()
        if not (torch.equal(first, second) and torch.equal(first, replayed)):
            raise AssertionError(f"K10 {label}: two launches or a CUDA graph's replay differ")
        kernel_ms = graph_ms(lambda: hc.launch_conv3d_wgrad(args), iters=20)
        ops = 2.0 * x.numel() * cout * k ** 3
        n_bytes = (x.numel() + dy.numel()) * 4 + cout * cin * k ** 3 * 4
        bound_ms, by = roofline_ms(n_bytes, ops, device=dev)
        with float32_compute():
            library_ms = graph_ms(lambda: torch.nn.grad.conv3d_weight(
                x, (cout, cin, k, k, k), dy, padding=(k - 1) // 2), iters=library_iters)
            plain_ms = time_ms(lambda: hc.conv3d_wgrad_plain(x, dy, k), iters=3, warmup=1)
        timing.append(dict(shape=label, layers=count, kernel_ms=kernel_ms, ops=ops,
                           bytes=n_bytes, bound_ms=bound_ms, bound_by=by,
                           library_ms=library_ms, plain_ms=plain_ms))
        log(f"[52 timing] {tag} K10 B={batch} {side}^3 {label} (x{count} a step): "
            f"{kernel_ms:.4f} ms alone (CUDA graph), {ops / kernel_ms / 1e9:.2f} TFLOP/s; "
            f"{n_bytes} B, {ops:.4g} operations, bound {bound_ms:.4f} ms by {by}, share "
            f"{bound_ms / kernel_ms:.4f}; cuDNN conv3d_weight {library_ms:.3f} ms (TF32 off); "
            f"plain {plain_ms:.3f} ms")
    checked = launches["conv3d_wgrad"] - per_step
    step_ms = sum(t["layers"] * t["kernel_ms"] for t in timing)
    step_library = sum(t["layers"] * t["library_ms"] for t in timing)
    step_bound = sum(t["layers"] * t["bound_ms"] for t in timing)
    log(f"[52 K10 vs plain] {len(worst)} cases within float32 round-off of the plain version "
        f"(worst |K10 - plain| / sum |x dy| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"); two launches and a graph replay equal; {per_step} launches in phase 50's "
          f"{train_steps} train steps; the 14 layers of a step {step_ms:.3f} ms alone "
          f"(bound {step_bound:.3f} ms, share {step_bound / step_ms:.4f}; cuDNN "
          f"{step_library:.3f} ms)")
    main = timing[1]  # a 3^3 32 -> 32 layer, nine of the fourteen
    return {"name": "conv3d_wgrad", "route": "cuda",
            "source": "deepprior_tpu_torch/csrc/conv3d_wgrad.cu",
            "replaces": "none: the JAX package has no V2V-PoseNet; cuDNN's dense weight "
                        "gradients of the 14 convolutions at 44^3",
            "launches": checked, "max_rel_err": max(worst.values()),
            "kernel_only_ms": main["kernel_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "plain_ms": main["plain_ms"], "step_ms": step_ms, "step_bound_ms": step_bound,
            "step_library_ms": step_library, "shapes": timing, "launches_per_call": 1,
            "phase_50_launches": per_step}


def v2v_serving_phase(dev, tag, log, batch=8, n_req=64, grid=88, frames=16, replays=20,
                      out="eval/chip_smoke_v2v_serve"):
    """Phase 53, run after phase 52: V2V-PoseNet on the serving path.  A
    network_prior.ckpt of a V2V-PoseNet (He weights, BatchNorm statistics
    from training-mode passes over the frames' grids), written in the
    training main's format, through ``load_serving_net("v2v",
    checkpoint=)``; its ``FusedEstimator``'s ``aot_compile`` at (``batch``,
    480, 640) replayed against the eager pipeline bit for bit in every
    output (joints, com3d, crops, grids, heatmaps), its counters against the
    grids; ``MicroBatchServer`` over it answering ``n_req`` requests
    (``frames`` distinct frames) equal to the eager call at the rows each
    batch was computed at; the refusals of
    the artifact export and ShardedEstimator; ``serve_http --model v2v
    --checkpoint`` as a subprocess answering 4 concurrent posts with the
    eager joints; then the replay's time (CUDA events over ``replays``
    replays) and the memory peak.  ``grid`` (with the published margin of 4
    voxels a side) is for a rehearsal on the CPU.  Returns the estimator and
    its frames too, for phase 54."""
    import io
    from concurrent.futures import wait

    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models import V2VConfig, V2VPoseNet
    from deepprior_tpu_torch.parallel.serve import ShardedEstimator
    from deepprior_tpu_torch.realtime import export
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint

    cam, hw = NYU_CAMERA, (480, 640)
    rng = np.random.default_rng(53)
    made = [make_depth_frame(cam, rng, num_joints=14) for _ in range(frames)]
    depth_np = np.stack([d for d, _ in made]).astype(np.float32)
    com_np = np.stack([c for _, c in made]).astype(np.float32)
    cube = (300.0, 300.0, 300.0)
    vcfg = dict(num_joints=14, grid=grid, cube_voxels=grid + 8, sigma=1.7)
    net = V2VPoseNet(V2VConfig(**vcfg))
    gen = torch.Generator().manual_seed(53)
    with torch.no_grad():  # He-normal kernels, as the benchmark draws them
        for p in net.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, float(np.sqrt(2.0 / (p.numel() // p.shape[0]))), generator=gen)
    net = net.to(dev)
    # BatchNorm statistics at a trained network's scale: training-mode
    # passes over the frames' grids (momentum 0.9, 20 passes)
    est = FusedEstimator(net, cam, cube=cube, device=dev)
    depth, com = torch.from_numpy(depth_np).to(dev), torch.from_numpy(com_np).to(dev)
    grids = torch.cat([est(depth[s:s + batch], com[s:s + batch])[3]
                       for s in range(0, frames, batch)])
    net.train()
    with torch.no_grad():
        for k in range(20):
            net(grids[(torch.arange(batch, device=dev) + k * batch) % frames][:, None])
    os.makedirs(out, exist_ok=True)
    ckpt = os.path.join(out, "network_prior.ckpt")
    save_checkpoint(ckpt, {"params": {k: v.cpu() for k, v in net.state_dict().items()}},
                    config=dict(model="v2v", **vcfg))
    del est, net

    served, prior = load_serving_net("v2v", checkpoint=ckpt, device=dev)
    if prior is not None or not isinstance(served, V2VPoseNet) or served.cfg.grid != grid:
        raise AssertionError(f"load_serving_net('v2v') gave {type(served).__name__}, {prior}")
    est = FusedEstimator(served, cam, cube=cube, device=dev)
    rows = np.arange(batch) % frames
    eager = est(depth[rows], com[rows])
    fn = est.aot_compile(batch, hw)
    for k in est.stats:
        est.stats[k].zero_()
    replayed = fn(depth_np[rows], com_np[rows])
    torch.cuda.synchronize()
    names = ("joints", "com3d", "crops", "grids", "heatmaps")
    unequal = [n for n, a, b in zip(names, replayed, eager) if not torch.equal(a, b)]
    if len(replayed) != 5 or unequal:
        raise AssertionError(f"phase 53: the replay differs from the eager pipeline in {unequal}")
    counted = {k: int(v) for k, v in est.stats.items()}
    want = {"rows": batch, "voxels_set": int(torch.count_nonzero(replayed[3])),
            "voxels_seen": batch * grid ** 3}
    if counted != want:
        raise AssertionError(f"phase 53: counters {counted}, want {want}")
    occupancy = 100.0 * want["voxels_set"] / want["voxels_seen"]

    # the server over the same estimator: a graph for each row count, each
    # batch's answers equal to the eager call at the rows it was computed at
    want_joints = {}
    for s in range(0, frames, batch):
        r = np.arange(s, s + batch) % frames
        for i, j in zip(r, est(depth[r], com[r])[0].cpu().numpy()):
            want_joints.setdefault(int(i), j)

    def request(i):
        return depth_np[i % frames], com_np[i % frames]

    server = MicroBatchServer(est, max_batch=batch, max_wait_ms=2.0)
    try:
        if not server.graph:
            raise AssertionError("phase 53: the server does not replay a graph")
        resolved = record_batches(server)
        futs = [server.submit(*request(i)) for i in range(n_req)]
        wait(futs, timeout=300)
        got = np.stack([f.result() for f in futs])
        stats = dict(server.stats)
    finally:
        server.close()
    want = eager_batches(est, resolved, futs, request)
    off = [i for i in range(n_req) if not np.array_equal(got[i], want[i])]
    sizes = Counter(rows for _, rows in resolved)
    if off or stats["frames"] != n_req or stats["rows"] != n_req:
        raise AssertionError(f"phase 53: server answers {off} differ from eager at the rows "
                             f"computed; {stats}")

    refused = []
    for what, call in (("export", lambda: export.export_serving(
            est, batch, hw, os.path.join(out, "v2v.dpx"))),
                       ("--dp", lambda: ShardedEstimator(est, devices=[dev, dev]))):
        try:
            call()
        except ValueError as e:
            if "V2VPoseNet" not in str(e):
                raise
            refused.append(what)
    if refused != ["export", "--dp"]:
        raise AssertionError(f"phase 53: only {refused} refused V2V")

    proc, port, seen = http_server(["deepprior_tpu_torch.mains.serve_http", "--model", "v2v",
                                    "--checkpoint", ckpt, "--port", "0", "--device", str(dev),
                                    "--max-batch", str(batch), "--max-wait-ms", "20"])
    try:
        def npz(i):  # the server's default cube is 250 mm: each post carries ours
            buf = io.BytesIO()
            np.savez(buf, depth=depth_np[i], com=com_np[i], cube=np.float32(cube))
            return buf.getvalue()

        results = {}
        posts = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, http_call(port, "POST", "/predict", npz(i)))) for i in range(4)]
        for th in posts:
            th.start()
        for th in posts:
            th.join(timeout=300)
        health = http_call(port, "GET", "/healthz")
    finally:
        stop(proc)
    errs = []
    for i in range(4):
        status, body = results.get(i, (None, None))
        if status != 200:
            raise AssertionError(f"phase 53: POST {i}: {status} {body}")
        errs.append(float(np.abs(np.asarray(body["joints"], np.float32)
                              - want_joints[i]).max()))
    if max(errs) > 1e-3 or health[1]["stats"]["frames"] < 4:
        raise AssertionError(f"phase 53: serve_http joints off by {errs} mm, {health}")

    # the replay's time at max_batch, and the memory peak of a fresh capture
    del fn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cap = est._capture(batch, hw)
    with torch.inference_mode():
        cap.depth.copy_(depth[rows])
        cap.com.copy_(com[rows])
    ms = []
    for _ in range(3):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(replays):
            cap.graph.replay()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1) / replays)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[53 v2v serving] {tag} V2V-PoseNet {grid}^3 from network_prior.ckpt through "
        f"load_serving_net: aot_compile at B={batch} 480x640 == eager in all 5 outputs bit "
        f"for bit; counters {counted} (occupancy {occupancy:.4f}%); MicroBatchServer "
        f"(graph) answered {n_req} requests == eager at the rows each batch was computed at "
        f"({stats['batches']} batches, rows {dict(sorted(sizes.items()))}); export "
        f"and ShardedEstimator refuse V2VPoseNet; serve_http --model v2v: {seen[-1]}, 4 "
        f"posts within {max(errs)} mm of eager; replay {min(ms):.3f} ms a batch of {batch} "
        f"({min(ms) / batch:.3f} ms a frame; all {[f'{v:.3f}' for v in ms]}), memory peak "
        f"of a capture {peak / 2**30:.3f} GiB")
    return {"replay_ms": min(ms), "peak_bytes": int(peak), "occupancy_pct": occupancy,
            "est": est, "depth": depth_np, "com": com_np}


def _counts(ns):
    """Row counts for a log line: a range as 'a-b', else the list."""
    ns = list(ns)
    return f"{ns[0]}-{ns[-1]}" if ns == list(range(ns[0], ns[-1] + 1)) else str(ns)


def row_graphs_phase(dev, tag, log, v2v, max_batch=64, v2v_batch=8, replays=20,
                     pose_frames=16, hidden=1024, wide_replays=3):
    """Phase 54, after phase 53: ``MicroBatchServer``'s graphs, one for each
    row count from 1 to max_batch over one set of static buffers and
    outputs in one memory pool, for a float32 PoseRegNet (``hidden``, a
    drawn PCA prior) at ``max_batch`` and phase 53's V2V-PoseNet (``v2v``,
    its return) at ``v2v_batch`` and at ``max_batch`` (``serve_http``'s
    default).  For each: the seconds the server's construction spends
    capturing them all, the memory that construction reserves and what the
    graphs still hold once the allocator's cache is emptied; each row
    count's replay (every count, but a spread of them for V2V-PoseNet at
    ``max_batch``) equal to the eager pipeline at that row
    count in every output, bit for bit (the static rows past it NaN);
    batches of sizes up to max_batch answered equal to the eager call at the
    rows each was computed at, each ``server.launch`` span's ``rows`` its
    ``server.batch``'s ``frames``, ``stats['rows']`` the frames served; and
    the device ms of each checked row count's replay (CUDA events over
    ``replays`` replays, ``wide_replays`` for V2V-PoseNet at max_batch),
    T(n)."""
    import gc

    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.utils import profiling

    cam = NYU_CAMERA
    rng = np.random.default_rng(54)
    made = [make_depth_frame(cam, rng) for _ in range(pose_frames)]
    net = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=hidden),
                     generator=torch.Generator().manual_seed(54))
    prior = PCAPrior(rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
                     np.zeros(42, np.float32))
    pose_est = FusedEstimator(net, cam, cube=(300.0,) * 3, prior=prior, device=dev)
    half = max_batch // 2
    spread = sorted({1, 2, 3, max_batch // 8, max_batch // 4, half - 1, half, half + 1,
                     max_batch - 2, max_batch - 1, max_batch})
    cases = [("PoseRegNet f32", pose_est, np.stack([d for d, _ in made]),
              np.stack([c for _, c in made]), max_batch, range(1, max_batch + 1), replays),
             ("V2V-PoseNet", v2v["est"], v2v["depth"], v2v["com"], v2v_batch,
              range(1, v2v_batch + 1), replays),
             ("V2V-PoseNet", v2v["est"], v2v["depth"], v2v["com"], max_batch, spread,
              wide_replays)]
    for label, est, depth_np, com_np, mb, checked, reps in cases:
        shape, k = depth_np.shape[1:], len(depth_np)

        def request(i):
            return depth_np[i % k], com_np[i % k]

        torch.cuda.synchronize()
        gc.collect()  # earlier phases' graphs in reference cycles give their pools back
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        server = MicroBatchServer(est, max_batch=mb, max_wait_ms=20.0)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        graphs_bytes = torch.cuda.memory_reserved(dev) - before
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()  # the warm-up calls' cache: what stays is the graphs'
        held_bytes = torch.cuda.memory_reserved(dev) - before
        try:
            staged = server._stage(shape)
            counts = [g.depth.shape[0] for g in staged.graphs]
            if not server.graph or counts != list(range(1, mb + 1)) \
                    or staged[0] is not staged.graphs[-1]:
                raise AssertionError(f"phase 54: {label} server staged graphs at {counts}")
            # every row count's replay against the eager pipeline at that count
            rows_all = np.arange(mb) % k
            d_all = torch.from_numpy(depth_np[rows_all]).to(dev)
            c_all = torch.from_numpy(com_np[rows_all]).to(dev)
            t_n = {}
            for n in checked:
                cap = staged.graphs[n - 1]
                with torch.inference_mode():
                    staged.full.depth.fill_(float("nan"))
                    staged.full.com.fill_(float("nan"))
                    cap.depth.copy_(d_all[:n])
                    cap.com.copy_(c_all[:n])
                    cap.cube.copy_(est.cube.expand(n, 3))
                    cap.mirror.zero_()
                    cap.graph.replay()
                    got = [t.clone() for t in cap.outputs]
                    want = est._pipeline(d_all[:n], c_all[:n])
                torch.cuda.synchronize()
                unequal = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
                if unequal or len(got) != len(want):
                    raise AssertionError(f"phase 54: {label} the {n}-row replay differs from "
                                         f"the eager pipeline in outputs {unequal}")
                outputs = len(got)
                ms = []
                for _ in range(2):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(reps):
                        cap.graph.replay()
                    e1.record()
                    torch.cuda.synchronize()
                    ms.append(e0.elapsed_time(e1) / reps)
                t_n[n] = min(ms)
            # batches of sizes up to max_batch, one thread submitting each
            # group and waiting for its answers
            sizes = [n for n in range(1, mb + 1) if mb <= 8 or n < 4 or n % 7 == 0 or n == mb]
            futs = []
            seen = record_batches(server)
            frames0, rows0 = server.stats["frames"], server.stats["rows"]
            profiling.clear()
            with profiling.recording():
                for n in sizes:
                    group = [server.submit(*request(len(futs) + i)) for i in range(n)]
                    for f in group:
                        f.result(timeout=300)
                    futs += group
            spans = profiling.spans()
            profiling.clear()
            got = np.stack([f.result() for f in futs])
            frames = server.stats["frames"] - frames0
            rows = server.stats["rows"] - rows0
        finally:
            server.close()
        want = eager_batches(est, seen, futs, request)
        off = [i for i in range(len(futs)) if not np.array_equal(got[i], want[i])]
        batches = {s.id: s.attrs for s in spans if s.name == "server.batch"}
        launches = {s.id: s.attrs["rows"] for s in spans if s.name == "server.launch"}
        bad = {b: (a, launches.get(b)) for b, a in batches.items()
               if a["padded"] or launches.get(b) != a["frames"]}
        if off or bad or not batches or not rows == frames == len(futs):
            raise AssertionError(f"phase 54: {label} answers {off[:8]} differ from eager at "
                                 f"the rows computed; spans {bad}; rows {rows}, frames {frames}")
        computed = Counter(r for _, r in seen)
        log(f"[54 row graphs] {tag} {label} at max_batch {mb} 480x640: {mb} graphs captured "
            f"in {capture_s:.3f} s at the server's construction, {graphs_bytes / 2**30:.3f} GiB "
            f"reserved, allocation peak {peak / 2**30:.3f} GiB, {held_bytes / 2**30:.3f} GiB "
            f"held by the graphs with the cache emptied; the replay at row counts "
            f"{_counts(checked)} == eager at that count in all {outputs} outputs bit for bit; {len(futs)} "
            f"requests in {len(batches)} batches (rows {dict(sorted(computed.items()))}) == "
            f"eager at the rows computed, launch rows == frames, stats rows {rows} == frames")
        log(f"[54 row graphs] {tag} {label} at max_batch {mb} T(n), device ms a replay "
            f"(best of 2 x {reps}): "
            + ", ".join(f"{n}: {t:.4f}" for n, t in t_n.items()))
        del server, staged


def a2j_phase(dev, tag, log, batch=64, frames=64, steps=3, timed_steps=10, hw=176,
              main_nmax=128, out="eval/chip_smoke"):
    """Phase 55, run after phase 54: A2J (models/a2j.py) on the card.  K5 at
    ``hw`` x ``hw`` against ``augment_geometry`` + ``warp_norm_plain`` on one
    batch's draws, bit for bit in the patches and the side outputs; then
    ``steps`` steps of the port's Trainer (Adam, weight decay 1e-4, A2J's
    augmentation through K5, He weights on ``frames`` synthetic NYU crops
    of the [220, 220, 300] mm cube) against the benchmark's plain reference
    (bench_torch/reference/a2j.py ``follow``) from the same weights, rows
    and augmentation generator state: each step's loss, the first step's
    gradient as Adam got it, the decay it added and the parameters' change,
    read as the cell a2j_nyu.train_b64 reads them and held to its limits
    (bench_torch/workloads/a2j_nyu.train_b64.json).  One K5 launch a step.  Then the step's time
    (host clock around ``timed_steps`` synchronised steps), its device time
    (torch.profiler, the union of the device's operations), the model
    TFLOP/s (bench_torch/models/a2j_flops.py) and its memory peak; and
    ``--model a2j`` through the NYU main for one epoch on ``main_nmax``
    synthetic frames.  ``hw`` (a multiple of 16) is for a rehearsal on the
    CPU.  Returns the phase's figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_torch.models import a2j_flops
    from bench_torch.reference import a2j as plain
    from bench_torch.reference import train as train_ref
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.mains import main_nyu_posereg_embedding
    from deepprior_tpu_torch.models.a2j import A2J, A2JConfig
    from deepprior_tpu_torch.ops import hopper_warp as hw_mod
    from deepprior_tpu_torch.ops.augment import (NV_VAL, augment_geometry,
                                                 sample_augment_params)
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench_torch", "configs", "a2j_nyu.json")) as fh:
        cfg = dict(json.load(fh), input_hw=hw)
    with open(os.path.join(here, "bench_torch", "workloads", "a2j_nyu.train_b64.json")) as fh:
        limits = json.load(fh)["limits"]
    tr_cfg = cfg["train"]
    modes = tuple(tr_cfg["aug_modes"])
    cam = NYU_CAMERA
    seq = make_sequence(cam, frames, num_joints=cfg["num_joints"],
                        cube=tuple(cfg["cube_mm"]), seed=55, dsize=(hw, hw))
    data = TrainData.from_sequence(seq).to(dev)
    rows = [torch.arange(s * batch, (s + 1) * batch, device=dev) % data.n for s in range(steps)]

    # K5 at hw x hw against its plain version
    b0 = data.take(rows[0])
    gen = torch.Generator(dev).manual_seed(55)
    drawn = sample_augment_params(gen, batch, len(modes), tr_cfg["sigma_com"],
                                  tr_cfg["sigma_sc"], tr_cfg["rot_range"])
    geo = augment_geometry(drawn, b0["com"], b0["cube"], b0["m"], cam, modes, (hw, hw))
    want = hw_mod.warp_norm_plain(b0["crops"], hw_mod.warp_norm_params(geo.a_fwd, geo.norm),
                                  0.0, NV_VAL)
    got = hw_mod.launch_warp_norm(b0["crops"], hw_mod.warp_norm_args(
        b0["crops"], drawn, b0["com"], b0["cube"], b0["m"], cam, modes), 0.0, NV_VAL)
    side = dict(new_com=geo.new_com, new_cube=geo.new_cube, m_out=geo.m_out)
    bad = [k for k, v in side.items() if not torch.equal(getattr(got, k), v)]
    if not torch.equal(got.out, want) or bad:
        raise AssertionError(f"phase 55: K5 at {hw}x{hw} != plain on "
                             f"{int((got.out != want).sum())} pixels; side outputs {bad}")

    # three steps against the reference
    net = A2J(A2JConfig(num_joints=cfg["num_joints"], input_hw=hw),
              generator=torch.Generator().manual_seed(55))
    start = {k: v.detach().clone().to(dev) for k, v in net.state_dict().items()}
    tc = TrainConfig(batch_size=batch, optimizer="adam", aug_modes=modes,
                     sigma_com=tr_cfg["sigma_com"], sigma_sc=tr_cfg["sigma_sc"],
                     rot_range=tr_cfg["rot_range"], model_has_dropout=False, seed=55)
    trainer = Trainer(net.to(dev), tc, cam, device=dev, weight_decay=tr_cfg["weight_decay"])
    state = trainer.init_state(state_dict=start)
    lr = tr_cfg["learning_rate"] / 10.0  # lr_of_ep(0)
    aug_gen = torch.Generator(dev).manual_seed(56)
    aug_state = aug_gen.get_state()
    hw_mod.LAUNCHES.update(dict.fromkeys(hw_mod.LAUNCHES, 0))
    names = [k for k, _ in state.model.named_parameters()]

    def moments():
        return {k: state.optimizer.state[p]["mu"].clone()
                for k, p in zip(names, state.model.parameters())}

    losses, mu0 = [], moments()
    for s in range(steps):
        state, loss = trainer.train_step(state, data.take(rows[s]), aug_gen, None, lr)
        losses.append(float(loss))
        if s == 0:  # the gradient as Adam got it, and the loss's own
            grad1 = train_ref.gradient_from_moments(mu0, moments())
            raw1 = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
    launches = dict(hw_mod.LAUNCHES)
    if launches.get("warp_norm") != steps:
        raise AssertionError(f"phase 55: {steps} steps launched {launches}")
    delta = {k: p.detach() - start[k] for k, p in state.model.named_parameters()}
    ref_gen = torch.Generator(dev)
    ref_gen.set_state(aug_state)
    readings = train_ref.compare(losses, grad1, delta, *plain.follow(
        cfg, start, data._asdict(), rows, lr, ref_gen, steps=steps))
    readings["decay_gap"] = plain.decay_gap(grad1, raw1, start, tr_cfg["weight_decay"])
    held = [k for k in ("loss_rel", "grad_norm_gap", "step_norm_gap", "decay_gap")
            if k in limits]
    log(f"[55 a2j] {tag} B={batch} {hw}x{hw}, {steps} steps against "
        f"bench_torch/reference/a2j.py: losses {[f'{v:.6g}' for v in losses]}; "
        + ", ".join(f"{k} {readings[k]:.3g} (limit {limits[k]:g})" for k in held)
        + f"; grad_sign_flip_share {readings['grad_sign_flip_share']:.3g}; K5 at {hw}x{hw} "
        f"== plain (patches, new_com, new_cube, m_out), one launch a step")
    for k in held:
        if not readings[k] <= limits[k]:
            raise AssertionError(f"phase 55: {k} {readings[k]:.3g} above the cell's limit "
                                 f"{limits[k]:g}")

    b = data.take(rows[0])

    def one_step():
        nonlocal state
        state, _ = trainer.train_step(state, b, aug_gen, None, lr)

    one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if is_device_op(e))
    busy, end = 0, None
    for s0, s1 in spans:
        if end is None or s0 > end:
            busy, end = busy + (s1 - s0), s1
        elif s1 > end:
            busy, end = busy + (s1 - end), s1
    device_ms = busy / 3 / 1e3  # the profiler's times are in us
    top = Counter()
    for e in prof.events():
        if is_device_op(e):
            top[e.name[:60]] += (e.time_range.end - e.time_range.start) / 3 / 1e3
    with torch.device("meta"):
        layout = A2J(A2JConfig(num_joints=cfg["num_joints"], input_hw=hw)).state_dict()
    flops = a2j_flops.train_step_flops(layout, batch, cfg["num_joints"], hw)
    log(f"[55 a2j] {tag} train step B={batch}: {step_ms:.3f} ms (host clock, {timed_steps} "
        f"synchronised steps), device busy {device_ms:.3f} ms a step "
        f"({100 * device_ms / step_ms:.1f}%), {flops / step_ms / 1e9:.2f} TFLOP/s of "
        f"{flops / 1e12:.4g} TFLOP a step ({100 * flops / step_ms / 1e9 / 67:.1f}% of 67); "
        f"memory peak {peak / 1e9:.3f} GB; device ms a step by kernel: "
        + "; ".join(f"{k} {v:.3f}" for k, v in top.most_common(8)))
    del trainer, state, net, data
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    st, results, hist = main_nyu_posereg_embedding.main(
        ["--synthetic", "--model", "a2j", "--epochs", "1", "--nmax", str(main_nmax),
         "--out", out, "--device", str(dev)], a2j=dict(input_hw=hw))
    if not (np.isfinite(hist["train_cost"]).all() and st.step == -(-main_nmax // 64)):
        raise AssertionError(f"phase 55: the main's costs {hist['train_cost']}, step {st.step}")
    log(f"[55 a2j] {tag} main_nyu_posereg_embedding --model a2j --nmax {main_nmax}: "
        f"{st.step} steps, costs {[f'{v:.4g}' for v in hist['train_cost']]}, test mean "
        + ", ".join(f"{k} {v.getMeanError():.1f} mm" for k, v in results.items())
        + f", {time.perf_counter() - t0:.1f} s")
    del st
    torch.cuda.empty_cache()
    return {"readings": readings, "step_ms": step_ms, "device_ms": device_ms,
            "peak_bytes": peak, "flops": flops}


def serving_phases(dev, tag, log, model, prior, trained, figures, batch=512, max_batch=64):
    """Phases 21-26, the graph-replaying serving path, run after phase 16:
    (21) the registered crop operator against ``launch_crop`` for K1 and K2
    at B = 512, and ``torch.library.opcheck`` on the card; (22)
    ``FusedEstimator.aot_compile`` at B = 1 and B = 512 against the eager
    ``_pipeline`` on two input batches in turn, and the B = 1 call in turns
    with the dispatched ``__call__``; (23) ``MicroBatchServer`` replaying the
    graph from pinned memory against ``graph=False`` on the same 64 requests,
    then both in turns: requests/s from a burst, and latency at a fixed load
    of 1, 16 and 64 closed-loop clients; (24) the training main's
    network_prior.ckpt through ``load_serving_net``, its float32 estimator
    bit-equal with TF32 on for the process; (25) both artifact kinds of
    that estimator at batch 64, loaded and called with TF32 on, against
    ``_pipeline`` and through the fixed-config server; (26) ``serve_http
    --checkpoint`` as a subprocess against the float32 reference.  ``model`` and ``prior`` are
    phase 4's, ``trained`` phase 8's; ``figures["poseregnet"]`` receives the B = 1
    medians of phase 22 and the 16-client latency of phase 23."""
    import http.client
    import io
    import os
    import queue

    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.device import _tf32_switches, float32_compute
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.realtime import export as xp
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    cam = NYU_CAMERA
    hw = (cam.height, cam.width)
    rng = np.random.default_rng(41)
    n_unique = 32
    pairs = [make_depth_frame(cam, rng) for _ in range(n_unique)]
    depth_np = np.stack([p[0] for p in pairs])
    com_np = np.stack([p[1] for p in pairs])
    depth = torch.from_numpy(depth_np).to(dev).repeat(batch // n_unique, 1, 1)
    com = torch.from_numpy(com_np).to(dev).repeat(batch // n_unique, 1)
    # a second input batch: the same frames shifted by one sample
    depth2, com2 = depth.roll(1, 0).contiguous(), com.roll(1, 0).contiguous()
    counts = hopper_crop.LAUNCHES

    def reset():
        counts.update(dict.fromkeys(counts, 0))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def scribble():
        """Fill freed device memory with NaN: a graph that reads memory it
        does not hold then gives NaN in its next replay."""
        junk = [torch.full((n,), float("nan"), device=dev)
                for n in (1, 3, 12, 128, 4096, 1 << 20) for _ in range(8)]
        del junk
        torch.cuda.synchronize()

    def eager(est, d, c):
        with torch.inference_mode():
            out = est._pipeline(d, c)
        torch.cuda.synchronize()
        return out

    @contextlib.contextmanager
    def tf32_on():
        """TF32 on for the process's convs and matmuls inside the block."""
        switches, _ = _tf32_switches()
        on = "tf32" if switches[0][1] == "fp32_precision" else True
        saved = [getattr(obj, attr) for obj, attr in switches]
        try:
            for obj, attr in switches:
                setattr(obj, attr, on)
            yield
        finally:
            for (obj, attr), value in zip(switches, saved):
                setattr(obj, attr, value)

    # --------------------------------------------------------------- 21
    op = torch.ops.deepprior_tpu_torch.normalized_crop
    cubes = {"one cube": torch.tensor([250.0] * 3, device=dev),
             "per-sample cubes": torch.from_numpy(
                 rng.uniform(150.0, 450.0, (batch, 3)).astype(np.float32)).to(dev)}
    for linear in (False, True):
        for label, cube in cubes.items():
            reset()
            got = op(depth, com, cube, float(cam.fx), float(cam.fy), 128, 128, False,
                     True, linear)
            want = hopper_crop.launch_crop(
                depth, hopper_crop.crop_args(depth, com, cube, cam.fx, cam.fy,
                                             fuse_clamp=True), linear=linear)
            torch.cuda.synchronize()
            name = "normalized_crop_linear" if linear else "normalized_crop"
            if counts[name] != 2 or not same(got, want):
                raise AssertionError(f"op {name} {label}: launches {dict(counts)}, "
                                     f"equal {[torch.equal(a, b) for a, b in zip(got, want)]}")
        torch.library.opcheck(hopper_crop.normalized_crop_op,
                              (depth[:4], com[:4], cubes["one cube"], float(cam.fx),
                               float(cam.fy), 128, 128, False, True, linear))
    log(f"[21 op] B={batch} NYU: torch.ops.deepprior_tpu_torch.normalized_crop == "
        f"launch_crop bit for bit (crops and M) for K1 and K2, one cube and per-sample "
        f"cubes, one launch each; torch.library.opcheck passes on the card (torch "
        f"{torch.__version__})")

    # --------------------------------------------------------------- 22
    # every capture of the port goes through graph_capture, which holds the
    # cyclic collector off: a dead graph it destroyed mid-capture once
    # invalidated phase 38's capture (prof_graph_gc shows the mechanism)
    from deepprior_tpu_torch.prof.prof_graph_gc import capture_with_garbage
    from deepprior_tpu_torch.utils.profiling import graph_capture

    for trial in range(3):
        err = capture_with_garbage(graph_capture, dev)
        if err:
            raise AssertionError(f"graph_capture with a dead graph pending, trial {trial}: "
                                 f"{err}")
    log("[22 capture] graph_capture with a dead CUDA graph in a reference cycle and the "
        "collector's threshold at 1: 3 of 3 captures replay == eager")
    est = FusedEstimator(model, cam, prior=prior, device=dev)
    if not est.captures:
        raise AssertionError("the serving estimator does not capture")
    compiled, capture_s = {}, {}
    for b in (1, batch):
        reset()
        t0 = time.perf_counter()
        fn = est.aot_compile(b, hw)
        torch.cuda.synchronize()
        capture_s[b] = time.perf_counter() - t0
        at_capture = counts["normalized_crop"]
        reset()
        outs = []
        for d, c in ((depth, com), (depth2, com2)):
            scribble()
            outs.append(fn(d[:b], c[:b]))
        torch.cuda.synchronize()
        replayed = dict(counts)
        want = [eager(est, d[:b], c[:b]) for d, c in ((depth, com), (depth2, com2))]
        if at_capture < 1 or any(replayed.values()):
            raise AssertionError(f"B={b}: kernel launches at capture {at_capture}, "
                                 f"in replays {replayed}")
        if not (same(outs[0], want[0]) and same(outs[1], want[1])):
            raise AssertionError(f"B={b}: aot_compile's replay != the eager _pipeline")
        if same(outs[0], outs[1]):
            raise AssertionError(f"B={b}: two input batches gave one output")
        compiled[b] = fn
    d1, c1 = depth_np[:1], com_np[:1]

    def host_ms(call, n=200):
        runs = []
        for _ in range(n):
            t0 = time.perf_counter()
            call()[0].cpu()
            runs.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(runs[5:])

    turns = {"dispatched": [], "aot": []}
    for key in ("dispatched", "aot", "aot", "dispatched"):
        call = ((lambda: est(d1, c1)) if key == "dispatched"
                else (lambda: compiled[1](d1, c1)))
        turns[key].append(host_ms(call))
    stat = {k: (float(np.median(np.concatenate(v))), float(np.mean(np.concatenate(v))),
                float(np.percentile(np.concatenate(v), 99))) for k, v in turns.items()}
    log(f"[22 aot_compile] {tag} B=1 and B={batch} NYU: the replayed graph == the eager "
        f"_pipeline bit for bit on two input batches in turn (joints, CoMs, crops; the "
        f"first result kept after the second call; freed memory filled with NaN "
        f"before each call); the crop wrapper ran "
        f"{at_capture} times at capture (warm-up and capture) and 0 times in replays; "
        f"capture {capture_s[1]:.3f} s (B=1), {capture_s[batch]:.3f} s (B={batch})")
    log(f"[22 aot_compile] {tag} B=1 host clock, numpy frame in, joints on the host out "
        f"(195 calls x2, in turns): aot_compile median {stat['aot'][0]:.4f} ms mean "
        f"{stat['aot'][1]:.4f} p99 {stat['aot'][2]:.4f}; dispatched __call__ median "
        f"{stat['dispatched'][0]:.4f} ms mean {stat['dispatched'][1]:.4f} p99 "
        f"{stat['dispatched'][2]:.4f}; speed-up {stat['dispatched'][0] / stat['aot'][0]:.2f}x")
    figures["poseregnet"].update(aot_b1_ms=stat["aot"][0],
                                 dispatched_b1_ms=stat["dispatched"][0])
    del compiled, fn, outs, want

    # --------------------------------------------------------------- 23
    def request(i):
        cube_i = np.full(3, 300.0, np.float32) if i % 3 == 0 else None
        return depth_np[i % n_unique], com_np[i % n_unique], cube_i, i % 4 == 1

    def serve(graph, n, threads=4, wait_ms=2.0):
        """n requests from ``threads`` threads at once; returns (joints
        (n, J, 3), requests/s, stats, kernel launches)."""
        reset()
        with MicroBatchServer(est, max_batch=max_batch, max_wait_ms=wait_ms,
                              graph=graph) as srv:
            if srv.graph != graph:
                raise AssertionError(f"graph={graph} resolved to {srv.graph}")
            srv.submit(*request(0)[:2]).result(timeout=300)  # warm
            futs = [None] * n

            def worker(t):
                for i in range(t, n, threads):
                    d, c, cb, mr = request(i)
                    futs[i] = srv.submit(d, c, cube=cb, mirror=mr)

            t0 = time.perf_counter()
            pool = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=300)
                if th.is_alive():
                    raise AssertionError("a submitting thread hung")
            got = np.stack([f.result(timeout=300) for f in futs])
            wall = time.perf_counter() - t0
            stats = dict(srv.stats)
        if stats["errors"]:
            raise AssertionError(f"server stats {stats}")
        return got, n / wall, stats, dict(counts)

    graph_j, _, graph_stats, graph_launches = serve(True, max_batch, 1, 200.0)
    eager_j, _, eager_stats, eager_launches = serve(False, max_batch, 1, 200.0)
    if not np.array_equal(graph_j, eager_j):
        raise AssertionError(f"server: graph != eager joints by "
                             f"{np.abs(graph_j - eager_j).max()} mm")
    if graph_launches["normalized_crop"] < 1 or eager_launches["normalized_crop"] < 2:
        raise AssertionError(f"server launches: graph {graph_launches}, "
                             f"eager {eager_launches}")
    log(f"[23 server] {max_batch} requests with mixed cube/mirror: graph + pinned "
        f"joints == graph=False joints bit for bit (graph: {graph_stats}, crop wrapper "
        f"{graph_launches['normalized_crop']} launches, all at capture; eager: "
        f"{eager_stats}, {eager_launches['normalized_crop']} launches)")
    # throughput: a burst of 2048 requests drains through full batches
    n_req, runs = 2048, {True: [], False: []}
    for graph in (False, True, True, False):
        _, rate, stats, _ = serve(graph, n_req)
        runs[graph].append((rate, stats))
    for graph, label in ((True, "graph + pinned"), (False, "eager")):
        rates = [r for r, _ in runs[graph]]
        occ = [s["frames"] / (s["batches"] * max_batch) for _, s in runs[graph]]
        log(f"[23 server] {tag} {label}: a burst of {n_req} requests from 4 threads at "
            f"max_batch {max_batch}, max_wait 2 ms (x2, in turns): "
            f"{min(rates):.1f}-{max(rates):.1f} requests/s, occupancy "
            f"{min(occ):.3f}-{max(occ):.3f}")

    # latency at a fixed load: ``clients`` closed-loop clients, each with one
    # request in flight (submit, wait for the joints, submit the next)
    def closed_loop(graph, clients, per_client, wait_ms=2.0):
        with MicroBatchServer(est, max_batch=max_batch, max_wait_ms=wait_ms,
                              graph=graph) as srv:
            srv.submit(*request(0)[:2]).result(timeout=300)  # warm
            lat = np.zeros((clients, per_client))

            def client(k):
                for j in range(per_client):
                    d, c, cb, mr = request(k * per_client + j)
                    t0 = time.perf_counter()
                    srv.submit(d, c, cube=cb, mirror=mr).result(timeout=300)
                    lat[k, j] = (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            pool = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=300)
                if th.is_alive():
                    raise AssertionError("a closed-loop client hung")
            wall = time.perf_counter() - t0
            stats = dict(srv.stats)
        if stats["errors"]:
            raise AssertionError(f"server stats {stats}")
        return clients * per_client / wall, lat.ravel(), stats

    for clients, per_client in ((1, 40), (16, 20), (64, 20)):
        loads = {True: [], False: []}
        for graph in (True, False, False, True):
            loads[graph].append(closed_loop(graph, clients, per_client))
        for graph, label in ((True, "graph + pinned"), (False, "eager")):
            lat = np.concatenate([x for _, x, _ in loads[graph]])
            rates = [r for r, _, _ in loads[graph]]
            occ = [s["frames"] / (s["batches"] * max_batch) for _, _, s in loads[graph]]
            log(f"[23 server] {tag} {label}: {clients} closed-loop clients x {per_client} "
                f"requests, one in flight each, max_batch {max_batch}, max_wait 2 ms (x2, "
                f"in turns): latency p50 {np.percentile(lat, 50):.3f} ms p99 "
                f"{np.percentile(lat, 99):.3f} ms over {lat.size} requests, "
                f"{min(rates):.1f}-{max(rates):.1f} requests/s, occupancy "
                f"{min(occ):.3f}-{max(occ):.3f}")
            if graph and clients == 16:
                figures["poseregnet"].update(p50_16=np.percentile(lat, 50),
                                             p99_16=np.percentile(lat, 99))

    # --------------------------------------------------------------- 24
    state, fitted, ckpt = trained["state"], trained["prior"], trained["ckpt"]
    loaded_model, loaded_prior = load_serving_net(checkpoint=ckpt, device=dev)
    want_sd = state.model.state_dict()
    if (set(loaded_model.state_dict()) != set(want_sd) or not all(
            torch.equal(v, want_sd[k]) for k, v in loaded_model.state_dict().items())
            or not torch.equal(loaded_prior.components.cpu(), fitted.components.cpu())
            or not torch.equal(loaded_prior.mean.cpu(), fitted.mean.cpu())):
        raise AssertionError("load_serving_net did not restore the trained weights and prior")
    served = FusedEstimator(loaded_model, cam, prior=loaded_prior, device=dev)
    direct = FusedEstimator(state.model, cam, prior=fitted, device=dev)
    a, b = served(depth[:max_batch], com[:max_batch]), direct(depth[:max_batch], com[:max_batch])
    torch.cuda.synchronize()
    if not same(a, b) or not torch.isfinite(a[0]).all():
        raise AssertionError("the checkpoint's estimator != the trained model's")
    # the float32 model computes in float32 whatever the process's TF32
    # switches say: with TF32 on for the process the eager call and a graph
    # captured then give the TF32-off joints; the same net run with TF32
    # allowed shows what a leak would cost
    with tf32_on():
        tf32_eager = eager(served, depth[:max_batch], com[:max_batch])
        tf32_graph = served.aot_compile(max_batch, hw)(depth[:max_batch], com[:max_batch])
        with torch.inference_mode():
            leak = served.prior.inverse_transform(served.model(a[2][:, None]))
    with torch.inference_mode(), float32_compute():
        exact = served.prior.inverse_transform(served.model(a[2][:, None]))
    leak_mm = (leak - exact).abs().max().item() * float(served.cube[2]) / 2.0
    if not (same(tf32_eager, a) and same(tf32_graph, a)):
        raise AssertionError("the float32 estimator with TF32 on for the process != TF32 off")
    log(f"[24 checkpoint] {ckpt}: load_serving_net restores the trained f32 PoseRegNet "
        f"(hidden 1024) and the fitted PCA (30, 42) exactly; its estimator's joints == "
        f"the trained model's bit for bit at B={max_batch}; with TF32 on for the process "
        f"its eager call and a graph captured then == TF32 off bit for bit (TF32 convs "
        f"would move the joints by up to {leak_mm:.6f} mm)")

    # --------------------------------------------------------------- 25
    # the deployment's artifacts: the trained float32 checkpoint's estimator,
    # loaded and called with TF32 on for the process (the program runs in
    # float32 all the same)
    ref = eager(served, depth[:max_batch], com[:max_batch])
    ref2 = eager(served, depth2[:max_batch], com2[:max_batch])
    # the first call takes host frames, as a server hands them over
    host_in = (depth_np[np.arange(max_batch) % n_unique], com_np[np.arange(max_batch) % n_unique])
    os.makedirs("eval/chip_smoke", exist_ok=True)
    for kind, write in (("stablehlo", xp.export_serving), ("compiled", xp.precompile_serving)):
        path = f"eval/chip_smoke/serve_{kind}.dpx"
        t0 = time.perf_counter()
        write(served, max_batch, hw, path)
        export_s = time.perf_counter() - t0
        reset()
        with tf32_on():
            t0 = time.perf_counter()
            art = xp.ArtifactEstimator(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            at_load = counts["normalized_crop"]
            scribble()
            reset()
            t0 = time.perf_counter()
            got = art(*host_in)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            first_launches = counts["normalized_crop"]
            scribble()
            got2 = art(depth2[:max_batch], com2[:max_batch])
            torch.cuda.synchronize()
        joint_err = max((g[0] - r[0]).abs().max().item() for g, r in ((got, ref), (got2, ref2)))
        exact = same(got, ref) and same(got2, ref2)
        if not exact:
            # an op that torch.export rewrites may round otherwise: the crops
            # (the kernel) and CoMs stay exact, the joints within the 1e-3 mm gate
            diff = [n for n, g, r in zip(("joints", "com3d", "crops"), got, ref)
                    if not torch.equal(g, r)]
            if "crops" in diff or "com3d" in diff or joint_err > 1e-3:
                raise AssertionError(f"{kind} artifact != _pipeline in {diff}, "
                                     f"joints by {joint_err} mm")
            log(f"[25 artifacts] {kind}: differs from _pipeline in {diff} by at most "
                f"{joint_err} mm")
        # on the card either kind loads into a replayed graph: K1 runs at the
        # capture, and a replay runs no Python
        if not (at_load >= 1 and first_launches == 0):
            raise AssertionError(f"{kind}: crop launches at load {at_load}, first call "
                                 f"{first_launches}")
        with MicroBatchServer(art, max_batch=art.batch, max_wait_ms=200.0,
                              frame_shape=art.hw) as srv:
            futs = [srv.submit(depth_np[i % n_unique], com_np[i % n_unique])
                    for i in range(max_batch)]
            served_j = np.stack([f.result(timeout=300) for f in futs])
            try:
                srv.submit(depth_np[0], com_np[0], cube=np.full(3, 300.0, np.float32))
                raise AssertionError("a fixed-config server took a per-request cube")
            except ValueError as e:
                if "fixed-config" not in str(e):
                    raise
        if not np.array_equal(served_j, got[0].cpu().numpy()):
            raise AssertionError(f"{kind}: the fixed-config server != the artifact's call")
        moved = ""
        if kind == "stablehlo":
            # the exported program moved to the CPU runs the plain crop there:
            # the same crops as the card's kernel
            t0 = time.perf_counter()
            cpu_fn, _ = xp.load_serving(path, device="cpu")
            cpu_out = cpu_fn(*host_in)
            cpu_s = time.perf_counter() - t0
            if not (torch.equal(cpu_out[2], ref[2].cpu())
                    and torch.isfinite(cpu_out[0]).all()):
                raise AssertionError("the artifact moved to the CPU gives other crops")
            moved = (f"; moved to the CPU (move_to_device_pass) it gives the card's crops "
                     f"bit for bit, joints within "
                     f"{(cpu_out[0] - ref[0].cpu()).abs().max().item():.6f} mm (float32 "
                     f"on the CPU), {cpu_s:.3f} s to load and run")
        log(f"[25 artifacts] {tag} {kind} of the trained f32 checkpoint at batch "
            f"{max_batch} NYU, loaded and called with TF32 on: == _pipeline "
            f"{'bit for bit' if exact else f'within {joint_err} mm'} on two input "
            f"batches; K1 launched {at_load} times at load and {first_launches} in the "
            f"first call; fixed-config MicroBatchServer serves it bit for bit and "
            f"refuses a per-request cube; export {export_s:.3f} s, load {load_s:.3f} s, "
            f"first call {first_s * 1e3:.3f} ms ({os.path.getsize(path)} bytes){moved}")
        del art

    # --------------------------------------------------------------- 26
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepprior_tpu_torch.mains.serve_http", "--checkpoint",
         ckpt, "--port", "0", "--device", str(dev), "--max-wait-ms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    try:
        port, seen = None, []
        deadline = time.monotonic() + 240
        while port is None:
            try:
                ln = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"serve_http did not start (exit "
                                         f"{proc.poll()}): {seen}")
                continue
            seen.append(ln.rstrip())
            if ln.startswith("serving on http://"):
                port = int(ln.split()[2].rsplit(":", 1)[1])

        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        def npz(i):
            buf = io.BytesIO()
            np.savez(buf, depth=depth_np[i], com=com_np[i])
            return buf.getvalue()

        results = {}
        posts = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, call("POST", "/predict", npz(i)))) for i in range(4)]
        for th in posts:
            th.start()
        for th in posts:
            th.join(timeout=300)
        health = call("GET", "/healthz")
        bad = call("POST", "/predict", b"not an npz")[0]
        # the subprocess runs torch's default TF32 settings; its float32
        # model computes in float32 all the same, as the reference does
        want = [eager(served, torch.from_numpy(depth_np[[i] * max_batch]).to(dev),
                      torch.from_numpy(com_np[[i] * max_batch]).to(dev))[0][0].cpu().numpy()
                for i in range(4)]
        errs = []
        for i in range(4):
            status, out = results.get(i, (None, None))
            if status != 200:
                raise AssertionError(f"POST {i}: {status} {out}")
            errs.append(float(np.abs(np.asarray(out["joints"], np.float32) - want[i]).max()))
        if max(errs) > 1e-3 or health[0] != 200 or health[1]["stats"]["frames"] < 4 \
                or bad != 400:
            raise AssertionError(f"serve_http: joints off by {errs} mm, healthz {health}, "
                                 f"bad body {bad}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    log(f"[26 serve_http] python -m deepprior_tpu_torch.mains.serve_http --checkpoint "
        f"{ckpt} --device {dev}: {seen[-1]}; /healthz {health[1]}; 4 concurrent "
        f"/predict posts answered with the checkpoint estimator's joints (max |d| "
        f"{max(errs)} mm against the float32 reference, the subprocess under torch's "
        f"default TF32 settings); a bad body 400; stopped with SIGINT, exit {proc.returncode}")
    del est, served, direct
    torch.cuda.empty_cache()


def calibrated_resnet(dev, cam, depth, com):
    """load_serving_net('resnet') (random weights, float32) with its
    BatchNorm statistics calibrated on the crops of ``depth``/``com``
    (``calibrate_batchnorm``): with its initial 0 / 1 statistics the random
    net's pose lands thousands of mm off, and float32's rounding grows with
    it.  Returns (model, prior)."""
    import torch

    from deepprior_tpu_torch.device import float32_compute
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models.layers import calibrate_batchnorm
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    model, prior = load_serving_net("resnet", device=dev)
    crops = FusedEstimator(model, cam, prior=prior, device=dev)(depth, com)[2]
    with float32_compute():
        calibrate_batchnorm(model, crops[:, None])
    torch.cuda.synchronize()
    return model, prior


def resnet_phases(dev, tag, log, kernels, figures, batch=512, max_batch=64, train_batch=128,
                  n_req=1024, clients=16, per_client=20, b1_calls=100):
    """Phases 27-30, ResNet-47 (the paper's model) on the serving and the
    training path, run after phase 26: (27) load_serving_net('resnet') in
    float32 and a bf16 copy with FusedEstimator at B = 512 and 1 (K1 ==
    the plain gather, the float32 joints against a CPU copy, frames/s
    dispatched and replayed with MFU, the B = 1 aot_compile call against
    dispatched; PoseRegNet's figures beside them); (28) the deployment:
    aot_compile replays at B = 1 and 512 == eager, MicroBatchServer with the
    graph (a burst's requests/s, p50/p99 at 16 closed-loop clients), both
    artifact kinds == _pipeline; (29) ResNet-47 type 2 training steps at B =
    128 in float32 and bf16 through K5 (K5 == its plain version on the
    step's batch, a type-0 card step against a CPU step, ms/step, samples/s,
    busy share, peak memory); (30) the training main with --model resnet,
    its checkpoint through load_serving_net and serve_http, and a reference
    pickle of the same weights through --ref-pickle.  Adds the ResNet
    paths' launches per call to K1's and K5's records in ``kernels``;
    ``figures`` holds PoseRegNet's from phases 6, 22 and 23."""
    import http.client
    import io
    import os
    import pickle
    import queue

    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame, make_sequence
    from deepprior_tpu_torch.mains import main_nyu_posereg_embedding
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models import ResNet, ResNetConfig
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import (NV_VAL, augment_geometry,
                                                 sample_augment_params)
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.realtime import export as xp
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer
    from deepprior_tpu_torch.utils.flops import mfu_pct, model_flops, peak_tflops
    from deepprior_tpu_torch.utils.refweights import (load_reference_pickle,
                                                      reference_pickle_from_state_dict)

    cam = NYU_CAMERA
    hwf = (cam.height, cam.width)
    rng = np.random.default_rng(27)
    n_unique = 16
    pairs = [make_depth_frame(cam, rng) for _ in range(n_unique)]
    depth_np = np.stack([p[0] for p in pairs])
    com_np = np.stack([p[1] for p in pairs])
    depth_u, com_u = torch.from_numpy(depth_np).to(dev), torch.from_numpy(com_np).to(dev)
    depth = depth_u.repeat(batch // n_unique, 1, 1)
    com = com_u.repeat(batch // n_unique, 1)
    record = {k["name"]: k for k in kernels}

    def crop_launches(fn):
        """fn() with K1's counts set to 0 just before; returns (out, K1 launches)."""
        hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
        out = fn()
        torch.cuda.synchronize()
        return out, hopper_crop.LAUNCHES["normalized_crop"]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # --------------------------------------------------------------- 27
    model32, prior = calibrated_resnet(dev, cam, depth_u, com_u)
    model16 = ResNet(model32.cfg._replace(dtype=torch.bfloat16)).to(dev)
    model16.load_state_dict(model32.state_dict())
    est32 = FusedEstimator(model32, cam, prior=prior, device=dev)
    est16 = FusedEstimator(model16, cam, prior=prior, device=dev)
    plain16 = FusedEstimator(model16, cam, prior=prior, crop_method="gather", device=dev)
    with torch.inference_mode():
        out16, k1_16 = crop_launches(lambda: est16(depth, com))
        out32, k1_32 = crop_launches(lambda: est32(depth, com))
        plain = plain16(depth, com)
    if (k1_16, k1_32) != (1, 1):
        raise AssertionError(f"ResNet estimator calls launched K1 {k1_16} / {k1_32} times")
    if not torch.equal(out16[2], plain[2]) or not torch.equal(out32[2], plain[2]):
        raise AssertionError("ResNet estimator crops: K1 != the plain gather")
    if not (torch.isfinite(out16[0]).all() and torch.isfinite(out32[0]).all()):
        raise AssertionError("ResNet joints not finite")
    cpu_model = ResNet(model32.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model32.state_dict().items()})
    cpu_est = FusedEstimator(cpu_model, cam, prior=prior.to("cpu"), device="cpu")
    cj = cpu_est(depth_u.cpu(), com_u.cpu())
    gj = est32(depth_u, com_u)
    f32_gap = (gj[0].cpu() - cj[0]).abs().max().item()
    if not torch.equal(gj[2].cpu(), cj[2]) or f32_gap > 0.01:
        raise AssertionError(f"ResNet f32 card vs CPU: joints by {f32_gap} mm, crops "
                             f"equal {torch.equal(gj[2].cpu(), cj[2])}")
    rel = (out32[0] - out32[1][:, None]).abs().max().item()
    bf16_gap = (out16[0] - out32[0]).abs().max().item()
    flops = model_flops(lambda: model16(out16[2][:1, None]))
    with torch.inference_mode():
        disp_ms = {16: [], 32: []}
        rep_ms = []
        cap = est16._capture(batch, hwf)
        cap.depth.copy_(depth)
        cap.com.copy_(com)
        for _ in range(2):  # in turns: dispatched bf16, f32, replayed bf16
            disp_ms[16].append(time_ms(lambda: est16(depth, com), iters=10))
            disp_ms[32].append(time_ms(lambda: est32(depth, com), iters=10))
            rep_ms.append(time_ms(cap.graph.replay, iters=10))
        del cap
    peak = peak_tflops(dev)
    fig = {}
    for label, ms in (("bf16 dispatched", min(disp_ms[16])), ("bf16 replayed", min(rep_ms)),
                      ("f32 dispatched", min(disp_ms[32]))):
        fps = batch / (ms / 1e3)
        mfu = mfu_pct(flops * batch, ms / 1e3, peak)
        fig[label] = (ms, fps, mfu)
    # B=1: aot_compile's replay against the dispatched call, host clock
    d1, c1 = depth_np[:1], com_np[:1]
    fn1 = est16.aot_compile(1, hwf)
    turns = {"dispatched": [], "aot": []}
    for key in ("dispatched", "aot", "aot", "dispatched"):
        call = (lambda: est16(d1, c1)) if key == "dispatched" else (lambda: fn1(d1, c1))
        for i in range(b1_calls + 5):
            t0 = time.perf_counter()
            call()[0].cpu()
            if i >= 5:
                turns[key].append((time.perf_counter() - t0) * 1e3)
    b1 = {k: float(np.median(v)) for k, v in turns.items()}
    pr = figures.get("poseregnet", {})
    log(f"[27 resnet serving] B={batch} NYU 640x480, ResNet-47 type 0 (30 outputs, "
        f"hidden 1024, random weights seed 0, BatchNorm statistics calibrated on 16 "
        f"frames' crops), PCA (30, 42): K1 launched once per estimator call (bf16 "
        f"{k1_16}, f32 {k1_32}); crops == plain gather (torch.equal); f32 joints card vs "
        f"CPU f32 copy max |d| {f32_gap:.6f} mm (<= 0.01; pose extent {rel:.1f} mm); "
        f"bf16 vs f32 joints max |d| {bf16_gap:.4f} mm")
    log(f"[27 resnet timing] {tag} B={batch}: "
        + "; ".join(f"{k} {ms:.4f} ms = {fps:.1f} frames/s, MFU {mfu:.2f}%"
                    if mfu is not None else f"{k} {ms:.4f} ms = {fps:.1f} frames/s"
                    for k, (ms, fps, mfu) in fig.items())
        + f" (best of 2 runs of 10 calls, CUDA events, in turns); "
        f"{flops / 1:.0f} flops per frame (FlopCounterMode), bf16 peak {peak} TFLOP/s; "
        f"B=1 host clock ({b1_calls} calls x2, in turns): aot_compile median {b1['aot']:.4f} ms, "
        f"dispatched {b1['dispatched']:.4f} ms ({b1['dispatched'] / b1['aot']:.2f}x)")
    if pr:
        log(f"[27 resnet timing] {tag} beside PoseRegNet bf16 (phases 6, 22): B={batch} "
            f"{pr['est_ms']:.4f} ms = {pr['fps']:.1f} frames/s; B=1 aot_compile "
            f"{pr.get('aot_b1_ms', float('nan')):.4f} ms, dispatched "
            f"{pr.get('dispatched_b1_ms', float('nan')):.4f} ms; ResNet-47 / PoseRegNet "
            f"at B={batch}: {fig['bf16 dispatched'][0] / pr['est_ms']:.2f}x the time")
    record["normalized_crop"]["resnet_launches_per_call"] = k1_16

    # --------------------------------------------------------------- 28
    for b in (1, batch):
        fn = est16.aot_compile(b, hwf)
        for d, c in ((depth, com), (depth.roll(1, 0), com.roll(1, 0))):
            (got, n_k1) = crop_launches(lambda: fn(d[:b].contiguous(), c[:b].contiguous()))
            with torch.inference_mode():
                want = est16._pipeline(d[:b].contiguous(), c[:b].contiguous())
            torch.cuda.synchronize()
            if n_k1 or not same(got, want):
                raise AssertionError(f"ResNet aot_compile B={b}: replay != eager "
                                     f"(K1 in the replay {n_k1})")
        del fn

    def request(i):
        return depth_np[i % n_unique], com_np[i % n_unique]

    with MicroBatchServer(est16, max_batch=max_batch, max_wait_ms=2.0) as srv:
        if not srv.graph:
            raise AssertionError("the ResNet server does not replay a graph")
        srv.submit(*request(0)).result(timeout=300)  # warm: captures
        seen = record_batches(srv)
        t0 = time.perf_counter()
        futs = [srv.submit(*request(i)) for i in range(n_req)]
        burst = np.stack([f.result(timeout=300) for f in futs])
        burst_rps = n_req / (time.perf_counter() - t0)
        lat = np.zeros((clients, per_client))

        def client(k):
            for j in range(per_client):
                t = time.perf_counter()
                srv.submit(*request(k * per_client + j)).result(timeout=300)
                lat[k, j] = (time.perf_counter() - t) * 1e3

        t0 = time.perf_counter()
        pool = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=300)
            if th.is_alive():
                raise AssertionError("a closed-loop client hung")
        loop_rps = lat.size / (time.perf_counter() - t0)
        stats = dict(srv.stats)
    if stats["errors"] or not np.isfinite(burst).all():
        raise AssertionError(f"ResNet server stats {stats}")
    # eager calls on the burst's batches at the rows the server computed
    srv_gap = float(np.abs(burst - eager_batches(est16, seen, futs, request)).max())
    if srv_gap > 1e-3:
        raise AssertionError(f"ResNet server joints off the eager call's by {srv_gap} mm")
    art_s = {}
    for kind, write in (("stablehlo", xp.export_serving), ("compiled", xp.precompile_serving)):
        path = f"eval/chip_smoke_resnet/serve_{kind}.dpx"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        write(est16, max_batch, hwf, path)
        t1 = time.perf_counter()
        art = xp.ArtifactEstimator(path)
        t2 = time.perf_counter()
        exact, gap = True, 0.0
        for d, c in ((depth, com), (depth.roll(1, 0), com.roll(1, 0))):
            got = art(d[:max_batch].contiguous(), c[:max_batch].contiguous())
            with torch.inference_mode():
                want_a = est16._pipeline(d[:max_batch].contiguous(), c[:max_batch].contiguous())
            torch.cuda.synchronize()
            if not same(got, want_a):
                # an op torch.export rewrites may round otherwise: the crops and
                # CoMs stay exact, the joints within the 1e-3 mm gate
                exact = False
                gap = max(gap, (got[0] - want_a[0]).abs().max().item())
                if not same(got[1:], want_a[1:]) or gap > 1e-3:
                    raise AssertionError(f"ResNet {kind} artifact != _pipeline (joints by "
                                         f"{gap} mm)")
        art_s[kind] = (t1 - t0, t2 - t1, os.path.getsize(path),
                       "bit for bit" if exact else f"within {gap} mm")
        del art
    log(f"[28 resnet deployment] {tag} ResNet-47 bf16: aot_compile replays at B=1 and "
        f"B={batch} == the eager _pipeline bit for bit on two input batches (K1 not "
        f"launched in replays); MicroBatchServer (graph + pinned, max_batch {max_batch}, "
        f"max_wait 2 ms): a burst of {n_req} requests from one thread "
        f"{burst_rps:.1f} requests/s (joints within {srv_gap} mm of eager calls on "
        f"the same batches at the rows computed), {clients} closed-loop clients x {per_client} requests: p50 "
        f"{np.percentile(lat, 50):.3f} ms "
        f"p99 {np.percentile(lat, 99):.3f} ms, {loop_rps:.1f} requests/s; artifacts at "
        f"batch {max_batch} against _pipeline: "
        + ", ".join(f"{k} {eq}, export {e:.3f} s load {ld:.3f} s ({n} bytes)"
                    for k, (e, ld, n, eq) in art_s.items()))
    pr = figures.get("poseregnet", {})
    if "p50_16" in pr:
        log(f"[28 resnet deployment] {tag} beside PoseRegNet bf16 (phase 23, graph + "
            f"pinned, 16 clients): p50 {pr['p50_16']:.3f} ms p99 {pr['p99_16']:.3f} ms")
    del est32, plain16, cpu_est
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 29
    seq = make_sequence(cam, train_batch, seed=29)
    host = TrainData.from_sequence(seq)
    data = host.to(dev)
    pri = fit_pose_prior(cam, np.random.default_rng(0), host.gt3d_crop, host.com, host.cube,
                         num_poses=5000)
    modes = ("com", "rot", "none")
    gen = torch.Generator(dev).manual_seed(29)
    b = data.n
    batch_t = data.take(torch.arange(b, device=dev))
    drawn = sample_augment_params(gen, b, len(modes))
    geo = augment_geometry(drawn, batch_t["com"], batch_t["cube"], batch_t["m"], cam, modes,
                           (128, 128))
    want5 = hw.warp_norm_plain(batch_t["crops"], hw.warp_norm_params(geo.a_fwd, geo.norm),
                               0.0, NV_VAL)
    got5 = hw.launch_warp_norm(batch_t["crops"], hw.warp_norm_args(
        batch_t["crops"], drawn, batch_t["com"], batch_t["cube"], batch_t["m"], cam, modes),
        0.0, NV_VAL).out
    if not torch.equal(got5, want5):
        raise AssertionError(f"K5 on the ResNet step's batch != plain on "
                             f"{int((got5 != want5).sum())} pixels")
    train_fig = {}
    for dt in (torch.float32, torch.bfloat16):
        tr = Trainer(ResNet(ResNetConfig.from_reference_type(2, num_joints=1, n_dims=30)
                            ._replace(dtype=dt)),
                     TrainConfig(batch_size=b), cam, prior=pri, device=dev)
        st = tr.init_state()
        aug_gen = torch.Generator(dev).manual_seed(1)
        drop_gen = torch.Generator(dev).manual_seed(2)

        def step():
            return tr._train_step_core(st, batch_t, aug_gen, drop_gen, 1e-4)[1]

        hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
        loss = step()
        torch.cuda.synchronize()
        k5 = dict(hw.LAUNCHES)
        if k5 != {"warp_norm": 1, "warp_patch": 0} or not math.isfinite(float(loss)):
            raise AssertionError(f"ResNet step: launches {k5}, loss {float(loss)}")
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = time_ms(step, iters=10)
        peak_mem = torch.cuda.max_memory_allocated(dev)
        host_ms, busy_ms, _ = profile_stage(f"{tag} ResNet-47 {str(dt)[6:]} train step "
                                            f"B={b}", step, 5, log, phase="29 profile")
        train_fig[str(dt)[6:]] = (step_ms, busy_ms / host_ms, peak_mem)
        del tr, st
        torch.cuda.empty_cache()
    record["warp_norm"]["resnet_launches_per_call"] = k5["warp_norm"]
    # a type-0 copy at B=16: one card step and one CPU step from the same
    # weights and the same pre-drawn augmentation
    b16 = min(16, b)
    net0 = ResNetConfig.from_reference_type(0, num_joints=1, n_dims=30)
    sd = ResNet(net0, generator=torch.Generator().manual_seed(3)).state_dict()
    cpu_draw = sample_augment_params(torch.Generator().manual_seed(9), b16, len(modes))
    res = {}
    for where in ("cpu", dev):
        tr = Trainer(ResNet(net0), TrainConfig(batch_size=b16, aug_modes=modes,
                                               model_has_dropout=False),
                     cam, prior=pri, device=where)
        st = tr.init_state(state_dict=sd)
        bt = host.to(where).take(torch.arange(b16, device=where))
        st, loss = tr._train_step_core(st, bt, [t.to(where) for t in cpu_draw], None, 1e-4)
        res[str(where)] = (float(loss), {k: v.cpu() for k, v in st.model.state_dict().items()
                                         if k.endswith(("running_mean", "running_var"))})
    (l_cpu, s_cpu), (l_dev, s_dev) = res["cpu"], res[str(dev)]
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    stat_rel = max(((s_dev[k] - s_cpu[k]).abs() / s_cpu[k].abs().clamp_min(1e-6)).max().item()
                   for k in s_cpu)
    stats_ok = all(torch.allclose(s_dev[k], s_cpu[k], rtol=1e-4, atol=1e-6) for k in s_cpu)
    if loss_rel > 1e-3 or not stats_ok:
        raise AssertionError(f"ResNet card vs CPU step: loss {l_dev} vs {l_cpu}, "
                             f"statistics max rel {stat_rel}")
    log(f"[29 resnet training] {tag} ResNet-47 type 2 (dropout), PCA 30, B={b}, aug "
        f"{'/'.join(modes)} through K5 (1 launch per step; K5 == augment_geometry + "
        f"warp_norm_plain on the step's batch, torch.equal): "
        + "; ".join(f"{k} {ms:.4f} ms/step = {b / (ms / 1e3):.1f} samples/s, busy share "
                    f"{share:.3f}, peak memory {mem / 2**30:.3f} GiB"
                    for k, (ms, share, mem) in train_fig.items())
        + f"; type 0 at B={b16}, card vs CPU step from the same weights and draws: loss "
        f"{l_dev:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e} <= 1e-3), running statistics max "
        f"rel {stat_rel:.2e} (rtol 1e-4, atol 1e-6)")

    # --------------------------------------------------------------- 30
    out = "eval/chip_smoke_resnet"
    hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
    t0 = time.perf_counter()
    state, results, hist = main_nyu_posereg_embedding.main([
        "--model", "resnet", "--synthetic", "--epochs", "2", "--nmax", "256",
        "--batch-size", "64", "--out", out, "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    steps = len(hist["train_cost"])
    if dict(hw.LAUNCHES) != {"warp_norm": steps, "warp_patch": 0} or steps != 8:
        raise AssertionError(f"the ResNet main's {steps} steps launched {dict(hw.LAUNCHES)}")
    ckpt = f"{out}/train_EMB_PCA30/network_prior.ckpt"
    loaded, lprior = load_serving_net("resnet", checkpoint=ckpt, device=dev)
    want_sd = state.model.state_dict()
    if set(loaded.state_dict()) != set(want_sd) or not all(
            torch.equal(v, want_sd[k]) for k, v in loaded.state_dict().items()):
        raise AssertionError("load_serving_net('resnet') did not restore every tensor")
    served = FusedEstimator(loaded, cam, prior=lprior, device=dev)
    ref = served(depth[:max_batch], com[:max_batch])
    # the same weights as a reference pickle, the PCA decode appended
    pkl = f"{out}/network_prior.pkl"
    with open(pkl, "wb") as fh:
        pickle.dump(reference_pickle_from_state_dict(loaded.state_dict(), "resnet",
                                                     decode=lprior), fh, 2)
    ref_model, none = load_serving_net("resnet", ref_pickle=pkl, device=dev)
    if none is not None:
        raise AssertionError("a network_prior.pkl came with a prior")
    got = FusedEstimator(ref_model, cam, device=dev)(depth[:max_batch], com[:max_batch])
    # the pickle's weights with the checkpoint's decode: the serving path alone
    same_w = FusedEstimator(ResNet(loaded.cfg).to(dev), cam, prior=lprior, device=dev)
    same_w.model.load_state_dict({**loaded.state_dict(), **{
        k: v for k, v in ref_model.state_dict().items() if k.endswith("running_var")}})
    same_j = same_w(depth[:max_batch], com[:max_batch])[0]
    pkl_gap = (got[0] - ref[0]).abs().max().item()
    path_gap = (got[0] - same_j).abs().max().item()
    inv_stored = [v[3] for v in load_reference_pickle(pkl).values() if len(v) == 4]
    vars_back = [v.cpu().numpy() for k, v in ref_model.state_dict().items()
                 if k.endswith("running_var")]
    ulps = max(int(np.abs(
        (1.0 / np.sqrt(vb.astype(np.float64) + 1e-5)).astype(np.float32).view(np.int32)
        - inv.view(np.int32)).max()) for vb, inv in zip(vars_back, inv_stored))
    if path_gap > 1e-3 or pkl_gap > 1e-2 or ulps > 2 or not torch.equal(got[2], ref[2]):
        raise AssertionError(f"--ref-pickle: joints off the checkpoint's by {pkl_gap} mm, "
                             f"off its own weights' by {path_gap} mm, inv_std by {ulps} ulps")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepprior_tpu_torch.mains.serve_http", "--model", "resnet",
         "--checkpoint", ckpt, "--port", "0", "--device", str(dev), "--max-wait-ms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        port, seen, deadline = None, [], time.monotonic() + 240
        while port is None:
            try:
                ln = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"serve_http --model resnet did not start: {seen}")
                continue
            seen.append(ln.rstrip())
            if ln.startswith("serving on http://"):
                port = int(ln.split()[2].rsplit(":", 1)[1])
        http_err = []
        for i in range(3):
            buf = io.BytesIO()
            np.savez(buf, depth=depth_np[i], com=com_np[i])
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request("POST", "/predict", body=buf.getvalue())
                resp = conn.getresponse()
                status, body = resp.status, json.loads(resp.read())
            finally:
                conn.close()
            if status != 200:
                raise AssertionError(f"serve_http --model resnet POST {i}: {status} {body}")
            with torch.inference_mode():  # the server's batch: the frame, padded
                want_i = served._pipeline(
                    torch.from_numpy(depth_np[[i] * max_batch]).to(dev),
                    torch.from_numpy(com_np[[i] * max_batch]).to(dev))[0][0].cpu().numpy()
            http_err.append(float(np.abs(np.asarray(body["joints"], np.float32)
                                         - want_i).max()))
        if max(http_err) > 1e-3:
            raise AssertionError(f"serve_http --model resnet: joints off by {http_err} mm")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    log(f"[30 resnet end to end] main_nyu_posereg_embedding --model resnet --synthetic "
        f"--epochs 2 --nmax 256 --batch-size 64: {steps} steps, K5 launches "
        f"{dict(hw.LAUNCHES)['warp_norm']}, costs {hist['train_cost'][0]:.4f} -> "
        f"{hist['train_cost'][-1]:.4f}, "
        + ", ".join(f"{k} mean {v.getMeanError():.3f} mm" for k, v in results.items())
        + f", {main_s:.1f} s; {ckpt}: load_serving_net('resnet') restores every tensor "
        f"bit for bit (the BatchNorm statistics too); serve_http --model resnet "
        f"--checkpoint (subprocess) answers 3 /predict posts within "
        f"{max(http_err):.6f} mm of the eager estimator; --ref-pickle of the same weights "
        f"(decode appended): joints within {pkl_gap:.6f} mm of the checkpoint's (the 61 "
        f"variances' float32 round trip through inv_std) and {path_gap:.6f} mm of its own "
        f"weights with the checkpoint's decode; inv_std round trip within {ulps} ulps")
    del served, ref_model, same_w, loaded, est16, model16, model32
    torch.cuda.empty_cache()


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's and cuBLAS's deterministic algorithms for the block only
    (phases 32-33): the setting, cuDNN's flag and the cuBLAS workspace
    variable that PyTorch requires with it come back after it."""
    import os

    import torch

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        if saved[2] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[2]


def dataset_phases(dev, tag, log, kernels, frames=256, nyu_frames=128, batch=128,
                   epochs=3, out="eval/chip_smoke_datasets"):
    """Phases 31-34, training on an imported dataset, run after phase 30:
    (31) a seeded MSRA15 tree in the real format (9 subjects x ``frames``
    frames of 320x240 float32 .bin, 21 joints) imported frame by frame on
    the host and in batches on the card, held to each other, then with a
    ScaleNet refiner from a port checkpoint attached (comref: K1 once per
    chunk of 256 frames on the batched path, once per frame on the host
    path), frames/s for each; with Pillow, an NYU 640x480 leg; (32) the
    MSRA15 cross-validation main at full width (hidden 1024, PCA 30) on the
    P8 fold at B = ``batch``, --streamed and resident, under deterministic
    algorithms: K5 once per step, the two loss traces equal; K5 and K1 held
    against their plain versions at this path's shapes; samples/s, busy
    share and the prefetcher's staging time per chunk of fit_streamed and
    fit; (33) both runs cut after epoch 0 and continued with --resume: the
    final parameters equal the uninterrupted runs', and the card's snapshot
    restores on the CPU with every tensor equal; (34)
    main_msra15_com_refine --streamed trains ScaleNet through K5 and writes
    net_P0_COM.ckpt, which load_refine_net_lazy reads into an importer
    whose comref import runs K1.  Adds these paths' launches to K1's and
    K5's records in ``kernels``."""
    import shutil

    import torch

    from deepprior_tpu_torch.camera import MSRA15_CAMERA
    from deepprior_tpu_torch.data import trees
    from deepprior_tpu_torch.data.importers import MSRA15Importer, NYUImporter
    from deepprior_tpu_torch.mains import common, main_msra15_com_refine
    from deepprior_tpu_torch.mains import main_msra15_posereg_embedding_crossval as crossval
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import NV_VAL, augment_geometry, sample_augment_params
    from deepprior_tpu_torch.ops.crop import clamp_depth, normalized_crop
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    record = {k["name"]: k for k in kernels}
    paths = {"normalized_crop": {}, "warp_norm": {}}
    cam = MSRA15_CAMERA
    subjects = [f"P{i}" for i in range(9)]
    shutil.rmtree(out, ignore_errors=True)
    root, cache = f"{out}/msra15", f"{out}/cache"

    # --------------------------------------------------------------- 31
    t0 = time.perf_counter()
    trees.write_msra15_tree(root, subjects=subjects, frames=frames, seed=31)
    write_s = time.perf_counter() - t0

    def load(imp, subj, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        seq = imp.loadSequence(subj, **kw)
        torch.cuda.synchronize()
        return seq, time.perf_counter() - t

    host_imp = MSRA15Importer(root, use_cache=False, device=dev)
    host, dev_seqs, t_host, t_dev = {}, {}, 0.0, 0.0
    for subj in subjects:
        host[subj], dt = load(host_imp, subj)
        t_host += dt
        dev_seqs[subj], dt = load(host_imp, subj, device_crop=True)
        t_dev += dt
    n_all = sum(len(s.data) for s in host.values())
    worst = {"com": 0.0, "T": 0.0}  # max |d|; T within rtol 1e-6 (test_torch_crop.py)
    for subj in subjects:
        a, b = host[subj].data, dev_seqs[subj].data
        if len(a) != len(b) or not len(a):
            raise AssertionError(f"{subj}: {len(a)} host frames, {len(b)} batched")
        for fa, fb in zip(a, b):
            if not (np.array_equal(fa.dpt, fb.dpt) and np.array_equal(fa.com, fb.com)
                    and np.array_equal(fa.gt3Dcrop, fb.gt3Dcrop)):
                raise AssertionError(f"{subj}: a batched crop on the card differs from "
                                     f"the host crop ({fa.fileName})")
            np.testing.assert_allclose(fb.T, fa.T, rtol=1e-6)
            worst["T"] = max(worst["T"], float(np.abs(fa.T - fb.T).max()))
    # the refiner: a seeded full-width ScaleNet through a port checkpoint
    ckpt = f"{out}/net_random_scalenet.ckpt"
    save_checkpoint(ckpt, {"params": ScaleNet(
        ScaleNetConfig(num_joints=1, n_dims=3),
        generator=torch.Generator().manual_seed(31)).state_dict()})
    ref_imp = MSRA15Importer(root, use_cache=False, device=dev)
    ref_imp.load_refine_net_lazy(ckpt)
    hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
    t_ref = 0.0
    comref = {}
    for subj in subjects:
        comref[subj], dt = load(ref_imp, subj, docom=True, device_crop=True)
        t_ref += dt
    chunks = sum(-(-frames // 256) for _ in subjects)
    k1 = dict(hopper_crop.LAUNCHES)
    if k1 != {"normalized_crop": chunks, "normalized_crop_linear": 0}:
        raise AssertionError(f"the comref import of {chunks} chunks launched {k1}")
    paths["normalized_crop"]["comref import, batched (31)"] = k1["normalized_crop"]
    hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
    host_ref, t_host_ref = load(ref_imp, "P8", docom=True)
    k1_host = hopper_crop.LAUNCHES["normalized_crop"]
    if k1_host != len(host_ref.data):
        raise AssertionError(f"the host comref import of {len(host_ref.data)} frames "
                             f"launched K1 {k1_host} times")
    paths["normalized_crop"]["comref import, host (31)"] = k1_host
    plain_docom = {s.fileName: s for s in MSRA15Importer(
        root, use_cache=False, device=dev).loadSequence("P8", docom=True,
                                                        device_crop=True).data}
    moved = 0.0
    for fh, fb in zip(host_ref.data, comref["P8"].data):
        # the host docom pass is numpy, the batched one torch on the card:
        # the detection bound of phase 14 (the JAX package's own)
        worst["com"] = max(worst["com"], float(np.abs(fh.com - fb.com).max()))
        moved = max(moved, float(np.abs(fb.com - plain_docom[fb.fileName].com).max()))
        np.testing.assert_allclose(fh.com, fb.com, rtol=1e-3, atol=0.5)
    if moved < 0.1:
        raise AssertionError("the refiner did not move the CoMs")
    # K1 at the comref import's shapes against its plain version
    p8 = comref["P8"].data
    dptc = clamp_depth(torch.from_numpy(np.stack(
        [host_imp.loadDepthMap(f.fileName) for f in p8])).to(dev))[0]
    com_b = torch.from_numpy(np.stack([f.com for f in p8])).to(dev)
    cube = torch.tensor(MSRA15Importer.default_cubes["P8"], dtype=torch.float32, device=dev)
    got = hopper_crop.hopper_normalized_crop(dptc, com_b, cube, cam.fx, cam.fy)
    want = normalized_crop(dptc, com_b, cube, cam.fx, cam.fy)
    k1_err = float((got[0] - want[0]).abs().max())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K1 at B={len(p8)} MSRA15 320x240 != plain ({k1_err})")
    record["normalized_crop"]["max_abs_err"] = max(record["normalized_crop"]["max_abs_err"],
                                                   k1_err)
    nyu = "Pillow missing on this machine: no NYU leg"
    try:
        import PIL  # noqa: F401
    except ImportError:
        pass
    else:
        nroot = f"{out}/nyu"
        trees.write_nyu_tree(nroot, {"train": nyu_frames}, seed=32)
        nimp = NYUImporter(nroot, use_cache=False, device=dev)
        nh, tn_h = load(nimp, "train")
        nd, tn_d = load(nimp, "train", device_crop=True)
        if not all(np.array_equal(a.dpt, b.dpt) for a, b in zip(nh.data, nd.data)):
            raise AssertionError("NYU: a batched crop on the card differs from the host's")
        nyu = (f"NYU 640x480 ({len(nh.data)} frames, Pillow present): host "
               f"{len(nh.data) / tn_h:.1f} frames/s, batched on the card "
               f"{len(nd.data) / tn_d:.1f} frames/s, crops equal")
    log(f"[31 import] {tag} MSRA15 tree of 9 x {frames} frames 320x240 written in "
        f"{write_s:.2f} s; {n_all} frames imported on the host {n_all / t_host:.1f} "
        f"frames/s and batched on the card {n_all / t_dev:.1f} frames/s (decode "
        f"included): crops, CoMs and labels equal, T within {worst['T']:.2e}; comref "
        f"(a seeded ScaleNet through a port checkpoint) batched {n_all / t_ref:.1f} "
        f"frames/s with K1 {k1['normalized_crop']}x ({chunks} chunks), on the host "
        f"{len(host_ref.data) / t_host_ref:.1f} frames/s with K1 {k1_host}x (one per "
        f"frame); host vs batched comref CoMs max |d| {worst['com']:.2e} px/mm, moved "
        f"up to {moved:.3f} by the refiner; K1 at B={len(p8)} == plain; {nyu}")

    # --------------------------------------------------------------- 32
    def run(main, argv):
        """``main`` on the tree, its prior cut to the synthetic mains' count of
        poses (the host fit of the recipe's count, about 10 s, is timed once
        below and not repeated in each of the six runs)."""
        hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
        saved = common.PRIOR_POSES
        common.PRIOR_POSES = common.PRIOR_POSES_SYNTHETIC
        t = time.perf_counter()
        try:
            res = main(argv + ["--data", root, "--cache-dir", cache, "--device", str(dev)])
            torch.cuda.synchronize()
        finally:
            common.PRIOR_POSES = saved
        return res, dict(hw.LAUNCHES), time.perf_counter() - t

    fold = ["--holdout", "P8", "--batch-size", str(batch)]
    steps = -(-8 * frames // batch)
    runs = {}
    with deterministic_algorithms():
        for mode in ("resident", "streamed"):
            flags = ["--streamed"] if mode == "streamed" else []
            folds, counts, wall = run(crossval.main, fold + flags + [
                "--epochs", str(epochs), "--out", f"{out}/{mode}"])
            state, results, hist = folds["P8"]
            if counts != {"warp_norm": epochs * steps, "warp_patch": 0}:
                raise AssertionError(f"{mode}: {epochs * steps} steps launched {counts}")
            if not (np.isfinite(hist["train_cost"]).all()
                    and np.isfinite(results["P8"].getMeanError())):
                raise AssertionError(f"{mode}: non-finite costs or errors")
            paths["warp_norm"][f"crossval main, {mode} (32)"] = counts["warp_norm"]
            runs[mode] = (state, list(hist["train_cost"]), results["P8"].getMeanError(), wall)
    (s_res, c_res, e_res, w_res), (s_str, c_str, e_str, w_str) = runs.values()
    if c_res != c_str or e_res != e_str:
        raise AssertionError(f"streamed loss trace != resident: {c_str} vs {c_res}")
    if not all(torch.equal(v, s_str.model.state_dict()[k])
               for k, v in s_res.model.state_dict().items()):
        raise AssertionError("streamed parameters != resident parameters")
    # the path's kernels at its shapes against their plain versions: K5 at
    # B = batch on the imported crops, with the MSRA15 camera
    train_seq = crossval._MultiSubjectImporter(root, subjects[:8], cache_dir=cache,
                                               device=dev).loadSequence(
        "train", shuffle=True, rng=np.random.RandomState(23455))
    data = TrainData.from_sequence(train_seq)
    gen = torch.Generator(dev).manual_seed(32)
    modes = ("com", "rot", "none")
    k5_err = 0.0
    for bsz in (batch, 64):
        bt = data.to(dev).take(torch.arange(bsz, device=dev))
        drawn = sample_augment_params(gen, bsz, len(modes))
        geo = augment_geometry(drawn, bt["com"], bt["cube"], bt["m"], cam, modes, (128, 128))
        want = hw.warp_norm_plain(bt["crops"], hw.warp_norm_params(geo.a_fwd, geo.norm),
                                  0.0, NV_VAL)
        got = hw.launch_warp_norm(bt["crops"], hw.warp_norm_args(
            bt["crops"], drawn, bt["com"], bt["cube"], bt["m"], cam, modes), 0.0, NV_VAL)
        k5_err = max(k5_err, float((got.out - want).abs().max()))
        if not (torch.equal(got.out, want) and torch.equal(got.m_out, geo.m_out)):
            raise AssertionError(f"K5 at B={bsz} MSRA15 crops != plain ({k5_err})")
    record["warp_norm"]["max_abs_err"] = max(record["warp_norm"]["max_abs_err"], k5_err)
    # throughput and busy share of the two loops, one trainer each, with
    # the recipe's prior, whose fit every run of the main above repeats
    t = time.perf_counter()
    prior = fit_pose_prior(cam, np.random.default_rng(0), data.gt3d_crop, data.com,
                           data.cube, n_components=30, num_poses=common.PRIOR_POSES)
    prior_s = time.perf_counter() - t
    arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
    resident = data.to(dev)
    figs = {}
    for mode in ("fit", "fit_streamed"):
        tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30)),
                     TrainConfig(batch_size=batch, n_epochs=1), cam, prior=prior, device=dev)
        st = tr.init_state()
        if mode == "fit":
            fn = lambda: tr.fit(st, resident, log=lambda m: None)  # noqa: E731
        else:
            fn = lambda: tr.fit_streamed(st, arrays, log=lambda m: None)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t) * 1e3 / (2 * steps)
        host_ms, busy_ms, launches = profile_stage(f"{tag} {mode} epoch of {steps} steps "
                                                   f"B={batch}", fn, 1, log, phase="32 profile")
        stage = (float(np.median(tr.prefetcher.stage_s)) * 1e3
                 if mode == "fit_streamed" else None)
        figs[mode] = (ms_step, busy_ms / host_ms, stage)
    log(f"[32 streamed training] {tag} main_msra15_posereg_embedding_crossval --holdout P8 "
        f"(8 x {frames} train frames, {len(results['P8'].gt)} test), PoseRegNet hidden 1024 "
        f"f32, PCA 30, B={batch}, {epochs} epochs of {steps} steps, deterministic "
        f"algorithms: K5 {epochs * steps}x in each run; streamed loss trace == resident "
        f"({c_res[0]:.4f} -> {c_res[-1]:.4f}), parameters equal, P8 mean {e_res:.3f} mm; "
        f"main wall resident {w_res:.1f} s, streamed {w_str:.1f} s (import from the cache "
        f"and a prior of {common.PRIOR_POSES_SYNTHETIC:,} poses included; the recipe's "
        f"prior of {common.PRIOR_POSES:,} poses alone {prior_s:.2f} s on the host); K5 == plain at B={batch} and 64 on these crops; "
        + "; ".join(f"{m}: {1e3 * batch / v[0]:.1f} samples/s ({v[0]:.4f} ms/step), busy "
                    f"share {v[1]:.3f}" + (f", staging {v[2]:.3f} ms/chunk of 8 steps "
                                           f"(median)" if v[2] is not None else "")
                    for m, v in figs.items()))

    # --------------------------------------------------------------- 33
    with deterministic_algorithms():
        for mode, flags in (("resident", []), ("streamed", ["--streamed"])):
            cut = fold + flags + ["--out", f"{out}/{mode}_cut"]
            run(crossval.main, cut + ["--epochs", "1"])
            folds, counts, _ = run(crossval.main, cut + ["--epochs", str(epochs), "--resume"])
            state, _, hist = folds["P8"]
            want_state = runs[mode][0]
            if counts["warp_norm"] != (epochs - 1) * steps:
                raise AssertionError(f"{mode} resume: launches {counts}")
            if hist["train_cost"] != runs[mode][1][-len(hist["train_cost"]):]:
                raise AssertionError(f"{mode} resume: losses differ from the "
                                     f"uninterrupted run's")
            bad = [k for k, v in want_state.model.state_dict().items()
                   if not torch.equal(v, state.model.state_dict()[k])]
            if bad or state.step != want_state.step:
                raise AssertionError(f"{mode} resume: parameters differ: {bad}")
    # the card's snapshot resumed on the CPU: parameters and optimizer
    # state exact (the draws after it are the CPU generator's)
    snap = f"{out}/resident_cut/MSRA_EMB_crossval_P8/net_last.ckpt"
    restored = []
    for where in (dev, torch.device("cpu")):
        tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30)),
                     TrainConfig(batch_size=batch, n_epochs=1), cam, device=where)
        st, next_epoch = tr.load_train_state(snap, tr.init_state())
        opt = st.optimizer
        restored.append((next_epoch, st.step, [t.cpu() for t in (
            list(st.model.state_dict().values()) + [opt.param_groups[0]["count"]]
            + [v for p in opt.param_groups[0]["params"] for v in opt.state[p].values()])]))
    (e_card, s_card, t_card), (e_cpu, s_cpu, t_cpu) = restored
    if (e_card, s_card) != (e_cpu, s_cpu) or not all(
            torch.equal(a, b) for a, b in zip(t_card, t_cpu)):
        raise AssertionError("the card's snapshot restores differently on the CPU")
    log(f"[33 resume] {tag} the P8 fold cut after epoch 0 (net_last.ckpt) and continued "
        f"with --resume to epoch {epochs - 1}, resident and --streamed, deterministic "
        f"algorithms: parameters, step and epoch losses bit-equal to the uninterrupted runs; "
        f"the card's snapshot restores on the CPU with its {len(t_cpu)} parameter, "
        f"statistic and optimizer tensors equal (epoch {e_cpu}, step {s_cpu})")

    # --------------------------------------------------------------- 34
    (state, results, hist), counts, wall = run(main_msra15_com_refine.main, [
        "--subject", "P0", "--test-subject", "P8", "--streamed", "--epochs", str(epochs),
        "--out", f"{out}/com"])
    com_steps = len(hist["train_cost"])
    if counts != {"warp_norm": com_steps, "warp_patch": 0} or com_steps != epochs * -(
            -frames // 64):
        raise AssertionError(f"ScaleNet's {com_steps} steps launched {counts}")
    paths["warp_norm"]["com refine main, streamed (34)"] = com_steps
    imp = MSRA15Importer(root, use_cache=False, device=dev)
    refiner = imp.load_refine_net_lazy(f"{out}/com/P0_COM/net_P0_COM.ckpt")
    if not all(torch.equal(v, refiner.model.state_dict()[k])
               for k, v in state.model.state_dict().items()):
        raise AssertionError("load_refine_net_lazy did not restore the trained ScaleNet")
    hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
    refined, _ = load(imp, "P8", docom=True, device_crop=True)
    if hopper_crop.LAUNCHES["normalized_crop"] != -(-frames // 256):
        raise AssertionError(f"the trained refiner's import launched {hopper_crop.LAUNCHES}")
    paths["normalized_crop"]["trained refiner's import (34)"] = hopper_crop.LAUNCHES[
        "normalized_crop"]
    if not all(np.isfinite(f.com).all() for f in refined.data):
        raise AssertionError("non-finite refined CoMs")
    log(f"[34 com refine] {tag} main_msra15_com_refine --streamed P0 -> P8, ScaleNet "
        f"full width f32, B=64, {com_steps} steps: K5 {counts['warp_norm']}x, refined "
        f"{results['refined'].getMeanError():.3f} mm vs raw CoM "
        f"{results['com'].getMeanError():.3f} mm, {wall:.1f} s; net_P0_COM.ckpt through "
        f"load_refine_net_lazy: every tensor restored, the comref import of P8 launched K1 "
        f"{hopper_crop.LAUNCHES['normalized_crop']}x")
    for name, by_path in paths.items():
        record[name]["launches_by_path"] = dict(record[name].get("launches_by_path", {}),
                                                **by_path)
    shutil.rmtree(out, ignore_errors=True)


def evaluation_phases(dev, tag, log, kernels, model, prior, nyu_scenes=512, icvl_scenes=256,
                      detect_scenes=128, twin_scenes=128, aug_distinct=128, frames=60,
                      demo_frames=30, accept_nmax=384, out="eval/chip_smoke_eval"):
    """Phases 42-45, the evaluation and capture surfaces, run after phase 34:
    (42) the port's differential sweeps (prof/sweeps.py) on the card:
    random crop scenes at NYU 640x480 (``nyu_scenes`` in one B=512 batch)
    and ICVL 320x240 (``icvl_scenes`` in B=128 batches), K1 and K2 on the
    raw frames (fused clamp) against their plain versions bit for bit, and
    the plain mm crops (nearest, 'linear', 'nd_bilinear') of the first
    ``twin_scenes`` of each camera against the numpy oracle; K5 through
    augment_batch(params=) at B=512 and 128 against its plain version bit
    for bit and against the augmentation twin; calculate_com,
    refine_com_iterative and detect over ``detect_scenes`` random detection
    scenes a camera against the host HandCropper; (43) the capture shim
    (cpp/capture.cpp, built with g++) in synthetic mode at 30 fps ->
    RealtimeHandposePipeline with the full-width bf16 PoseRegNet ->
    K1, ``frames`` frames: frames/s, K1 launches a frame, every frame's
    joints against the plain crop's on the card, every getter once; (44)
    demo_realtime --device capture --save-view: the canvas's shape and
    the status bar's state light, the PNG where matplotlib is installed;
    (45) main_nyu_posereg_embedding --synthetic --accept at B=128 (K5 once
    a step): results.json's acceptance record, a missed threshold exits
    non-zero, the curves and overlays where matplotlib is installed.
    Adds these paths' launches to K1's, K2's and K5's records."""
    import contextlib
    import io
    import os
    import shutil

    import torch

    from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.mains import demo_realtime, main_nyu_posereg_embedding
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops._build import host_library_path
    from deepprior_tpu_torch.ops.augment import (NV_VAL, augment_batch, augment_geometry,
                                                 sample_augment_params)
    from deepprior_tpu_torch.ops.crop import clamp_depth, crop3d, normalized_crop
    from deepprior_tpu_torch.prof import sweeps
    from deepprior_tpu_torch.realtime.camera import CaptureDevice
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.realtime.pipeline import STATE_COLORS, RealtimeHandposePipeline

    record = {k["name"]: k for k in kernels}
    paths = {"normalized_crop": {}, "normalized_crop_linear": {}, "warp_norm": {}}
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def reset():
        hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
        hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))

    # --------------------------------------------------------------- 42
    t42 = time.perf_counter()
    rng = np.random.default_rng(42)
    crop_stats = []
    for cam, n, bsz in ((NYU_CAMERA, nyu_scenes, 512), (ICVL_CAMERA, icvl_scenes, 128)):
        dpts, coms, cubes = sweeps.crop_scenes(rng, cam, n)
        k_diff, twin_bad, k1 = 0, [], {"normalized_crop": 0, "normalized_crop_linear": 0}
        for s in range(0, n, bsz):
            raw, com, cube = put(dpts[s:s + bsz]), put(coms[s:s + bsz]), put(cubes[s:s + bsz])
            clamped = clamp_depth(raw)[0]
            reset()
            got = [hopper_crop.hopper_normalized_crop(raw, com, cube, cam.fx, cam.fy,
                                                      fuse_clamp=True, use_bilinear=lin)
                   for lin in (False, True)]
            torch.cuda.synchronize()
            for key, v in hopper_crop.LAUNCHES.items():
                k1[key] += v
            for lin, (crops, m) in zip((False, True), got):
                want, m_want = normalized_crop(clamped, com, cube, cam.fx, cam.fy,
                                               use_bilinear=lin)
                name = "normalized_crop_linear" if lin else "normalized_crop"
                err = float((crops - want).abs().max())
                record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)
                k_diff += int(((crops != want).flatten(1).any(1)
                               | (m != m_want).flatten(1).any(1)).sum())
            n_twin = max(0, min(bsz, twin_scenes - s))
            if n_twin:
                mm = {mode: crop3d(clamped[:n_twin], com[:n_twin], cube[:n_twin], cam.fx,
                                   cam.fy, resize=mode) for mode in
                      ("nearest", "linear", "nd_bilinear")}
                twin_bad += sweeps.check_crops(
                    cam, clamped[:n_twin].cpu().numpy(), coms[s:s + n_twin],
                    cubes[s:s + n_twin], {k: v[0].cpu().numpy() for k, v in mm.items()},
                    mm["nearest"][1].cpu().numpy())
        if k1 != {"normalized_crop": -(-n // bsz), "normalized_crop_linear": -(-n // bsz)}:
            raise AssertionError(f"the crop sweep launched {k1}")
        for key, v in k1.items():
            paths[key][f"crop sweep {cam.width}x{cam.height} B={bsz} (42)"] = v
        crop_stats.append(f"{cam.width}x{cam.height}: {n} scenes at B={bsz}, K1/K2 != plain "
                          f"on {k_diff} samples, {min(n, twin_scenes)} against the oracle in "
                          f"3 resize modes: {len(twin_bad)} disagreements")
        if k_diff or twin_bad:
            raise AssertionError(f"crop sweep {cam.width}x{cam.height}: {k_diff} kernel != "
                                 f"plain; oracle: {twin_bad[:5]}")
    aug_stats = []
    for cam, modes, zero_one in ((NYU_CAMERA, ("com", "rot", "sc", "none"), False),
                                 (ICVL_CAMERA, ("com", "rot", "none"), True)):
        base = sweeps.augment_inputs(rng, cam, aug_distinct, zero_one)
        for bsz in (512, 128):
            inputs = tuple(np.concatenate([a] * -(-bsz // aug_distinct))[:bsz] for a in base)
            tens = tuple(put(a) for a in inputs)
            params = sample_augment_params(torch.Generator(dev).manual_seed(bsz), bsz,
                                           len(modes))
            reset()
            got = augment_batch(None, *tens, cam, aug_modes=modes, norm_zero_one=zero_one,
                                params=params)
            torch.cuda.synchronize()
            if hw.LAUNCHES != {"warp_patch": 0, "warp_norm": 1}:
                raise AssertionError(f"augment_batch launched {hw.LAUNCHES}")
            paths["warp_norm"][f"augment sweep {cam.width}x{cam.height} B={bsz} (42)"] = 1
            geo = augment_geometry(params, tens[2], tens[3], tens[4], cam, modes, (128, 128),
                                   zero_one)
            want = hw.warp_norm_plain(tens[0], hw.warp_norm_params(geo.a_fwd, geo.norm), 0.0,
                                      NV_VAL)
            err = float((got[0] - want).abs().max())
            record["warp_norm"]["max_abs_err"] = max(record["warp_norm"]["max_abs_err"], err)
            if not (torch.equal(got[0], want) and torch.equal(got[4], geo.m_out)
                    and torch.equal(got[2], geo.new_com) and torch.equal(got[3], geo.new_cube)):
                raise AssertionError(f"K5 at B={bsz} {cam.width}x{cam.height} != plain ({err})")
            bad = sweeps.check_augment(cam, inputs, [p.cpu().numpy() for p in params],
                                       [t.cpu().numpy() for t in got], modes, zero_one,
                                       f"B={bsz}")
            if bad:
                raise AssertionError(f"K5 against the augmentation twin: {bad[:5]}")
            aug_stats.append(f"{cam.width}x{cam.height} B={bsz} {'/'.join(modes)}"
                             f"{' [0,1]' if zero_one else ''}: K5 == plain, twin 0")
    det_stats = []
    for cam in (NYU_CAMERA, ICVL_CAMERA):
        raws, seeds, cubes = sweeps.detect_scenes(rng, cam, detect_scenes)
        got = sweeps.run_detection(raws, seeds, cubes, cam, dev)
        bad = sweeps.check_detection(cam, raws, seeds, cubes, got)
        det_stats.append(f"{cam.width}x{cam.height}: {detect_scenes} scenes, "
                         f"{len(bad)} disagreements")
        if bad:
            raise AssertionError(f"detection sweep {cam.width}x{cam.height}: {bad[:5]}")
    s42 = time.perf_counter() - t42
    log(f"[42 sweeps] {tag} crops: {'; '.join(crop_stats)}; K5: {'; '.join(aug_stats)}; "
        f"detection (calculate_com, refine 2/5, detect 20/200 and 10/50) against "
        f"HandCropper: {'; '.join(det_stats)}; {s42:.1f} s")

    # --------------------------------------------------------------- 43
    t43 = time.perf_counter()
    t = time.perf_counter()
    lib = host_library_path("capture.cpp")
    build_s = time.perf_counter() - t
    device = CaptureDevice(lib, mode="synthetic", fps=30.0)
    device.start()
    try:
        cam = device.getDepthIntrinsics()
        shapes = {}
        for name, fn in (("getDepth", device.getDepth), ("getRGB", device.getRGB),
                         ("getVertices", device.getVertices),
                         ("getVertices(fp=True)", lambda: device.getVertices(fp=True)),
                         ("getUVMap", device.getUVMap), ("getSyncMap", device.getSyncMap)):
            ok, arr = fn()
            if not ok:
                raise AssertionError(f"capture {name} returned no frame")
            shapes[name] = (tuple(arr.shape), str(arr.dtype))
        shapes["getAcceleration"] = tuple(device.getAcceleration().shape)
        shapes["getExtrinsics"] = tuple(device.getExtrinsics().shape)
        color = device.getColorIntrinsics()
        counts = (device.getLastDepthNum(), device.getLastColorNum())
    finally:
        device.stop()
    want_shapes = {"getDepth": ((240, 320), "float32"), "getRGB": ((480, 640, 3), "uint8"),
                   "getVertices": ((240, 320, 3), "int16"),
                   "getVertices(fp=True)": ((240, 320, 3), "float32"),
                   "getUVMap": ((240, 320, 2), "float32"),
                   "getSyncMap": ((240, 320, 3), "uint8"), "getAcceleration": (3,),
                   "getExtrinsics": (3, 4)}
    if shapes != want_shapes or (color.width, color.height) != (640, 480) or min(counts) < 1:
        raise AssertionError(f"capture getters: {shapes}, colour {color}, counts {counts}")
    est = FusedEstimator(model, cam, prior=prior, crop_method="auto", device=dev)
    plain = FusedEstimator(model, cam, prior=prior, crop_method="gather", device=dev)
    pipe = RealtimeHandposePipeline(est, {"fx": cam.fx, "fy": cam.fy,
                                          "cube": (250.0, 250.0, 250.0)})
    pipe.process_video(CaptureDevice(lib, mode="synthetic", fps=30.0), max_frames=3)  # warm
    reset()
    t = time.perf_counter()
    results = pipe.process_video(CaptureDevice(lib, mode="synthetic", fps=30.0),
                                 max_frames=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k1_capture = hopper_crop.LAUNCHES["normalized_crop"]
    if not results or k1_capture != len(results):
        raise AssertionError(f"{len(results)} captured frames posed, K1 {k1_capture}x")
    paths["normalized_crop"][f"capture pipeline, {len(results)} frames (43)"] = k1_capture
    jerr = 0.0
    for r in results:
        pj, _, _ = plain(r["frame"][None], np.asarray(r["com"], np.float32)[None],
                         cube=np.asarray(r["cube"], np.float32), mirror=np.asarray([False]))
        jerr = max(jerr, float(np.abs(pj[0].cpu().numpy() - r["joints3d"]).max()))
    if jerr > 1e-3:
        raise AssertionError(f"captured frames' joints differ from the plain crop's by {jerr} mm")
    s43 = time.perf_counter() - t43
    log(f"[43 capture] {tag} capture.cpp built with g++ in {build_s:.3f} s; CaptureDevice "
        f"synthetic 30 fps (fx {cam.fx:.2f}, {cam.width}x{cam.height}) -> pipeline "
        f"(detect on the card) -> K1 -> PoseRegNet hidden 1024 bf16: {len(results)} of "
        f"{frames} frames posed in {wall:.3f} s = {len(results) / wall:.2f} frames/s, K1 "
        f"{k1_capture / len(results):.2f} launches a frame, joints against the plain crop's "
        f"max |d| {jerr:.3e} mm; getters {shapes}, colour {color.width}x{color.height}, "
        f"frame counters {counts}; {s43:.1f} s")

    # --------------------------------------------------------------- 44
    t44 = time.perf_counter()
    png = os.path.abspath(f"{out}/view.png")
    lines = []
    reset()
    pipe, results = demo_realtime.main(["--device", "capture", "--frames", str(demo_frames),
                                        "--save-view", png], log=lines.append)
    k1_demo = hopper_crop.LAUNCHES["normalized_crop"]
    if not results or k1_demo != len(results):
        raise AssertionError(f"the demo posed {len(results)} frames, K1 {k1_demo}x")
    paths["normalized_crop"][f"demo --device capture, {len(results)} frames (44)"] = k1_demo
    canvas = demo_realtime.view_canvas(pipe, results[-1])
    light = tuple(int(c) for c in canvas[9, 7])
    if canvas.shape != (240 + 20, 2 * 320, 3) or light != STATE_COLORS[pipe.state]:
        raise AssertionError(f"canvas {canvas.shape}, state light {light} in state {pipe.state}")
    wrote = os.path.isfile(png)
    if wrote != have_mpl or (not have_mpl and "no PNG written" not in lines[-1]):
        raise AssertionError(f"matplotlib {have_mpl}, PNG written {wrote}: {lines}")
    log(f"[44 drawing] {tag} demo_realtime --device capture --frames {demo_frames} "
        f"--save-view: {lines[0]}; K1 {k1_demo}x; canvas {canvas.shape}, state light {light} "
        f"(state {pipe.state}); {lines[-1]}; {time.perf_counter() - t44:.1f} s")

    # --------------------------------------------------------------- 45
    t45 = time.perf_counter()
    steps = accept_nmax // 128

    def accept(sub, *extra):
        buf = io.StringIO()
        argv = ["--synthetic", "--accept", "--epochs", "1", "--batch-size", "128", "--nmax",
                str(accept_nmax), "--out", f"{out}/{sub}", *extra]
        exit_msg = None
        with contextlib.redirect_stdout(buf):
            try:
                main_nyu_posereg_embedding.main(argv)
            except SystemExit as exc:
                exit_msg = str(exc)
        rec = json.load(open(f"{out}/{sub}/train_EMB_PCA30/results.json"))["acceptance"]
        return rec, exit_msg, buf.getvalue().splitlines()

    reset()
    rec, exit_msg, lines = accept("pass", "--accept-mm", "1000")
    k5 = hw.LAUNCHES["warp_norm"]
    if k5 != steps or exit_msg is not None or not rec["pass"]:
        raise AssertionError(f"--accept: K5 {k5}x for {steps} steps, exit {exit_msg}, {rec}")
    paths["warp_norm"][f"--accept main, {steps} steps (45)"] = k5
    keys = {"mean_mm", "max_mm", "threshold_mm", "n_test_frames", "synthetic", "pass"}
    if not keys <= set(rec) or not rec["synthetic"]:
        raise AssertionError(f"acceptance record {rec}")
    files = os.listdir(f"{out}/pass/train_EMB_PCA30")
    plots = sorted(f for f in files if f.endswith((".png", ".pdf")))
    missed = [ln for ln in lines if ln.startswith("plot not written")]
    if have_mpl:
        need = {"train_EMB_PCA30_cost.png", "train_EMB_PCA30_errs.png", "train_EMB_PCA30_0.png",
                "train_EMB_PCA30_accept_frameswithin.pdf"}
        if not need <= set(plots) or missed:
            raise AssertionError(f"plots {plots}, not written {missed}")
    elif plots or not missed or not all("matplotlib" in ln for ln in missed):
        raise AssertionError(f"without matplotlib: plots {plots}, lines {missed}")
    verdict = next(ln for ln in lines if ln.startswith("acceptance ["))
    rec_fail, exit_fail, _ = accept("fail", "--nmax", "128", "--accept-mm", "0.0001")
    if not exit_fail or "acceptance FAILED" not in exit_fail or rec_fail["pass"]:
        raise AssertionError(f"a missed threshold: exit {exit_fail}, {rec_fail}")
    log(f"[45 acceptance] {tag} main_nyu_posereg_embedding --synthetic --accept, B=128, "
        f"{steps} steps: K5 {k5}x; {verdict}; record {rec}; plots written {len(plots)}, "
        f"lines for plots not written {len(missed)}"
        f"{' (' + missed[0] + ', ...)' if missed else ''}; --accept-mm 0.0001 exits non-zero "
        f"({exit_fail}); {time.perf_counter() - t45:.1f} s")

    for name, by_path in paths.items():
        record[name]["launches_by_path"] = dict(record[name].get("launches_by_path", {}),
                                                **by_path)
    shutil.rmtree(out, ignore_errors=True)
    log(f"[42-45] {tag} {time.perf_counter() - t42:.1f} s in all")


def http_server(argv, ready="serving on http://", timeout=240):
    """Start ``python -m <argv>`` and wait for its ``ready`` line.  Returns
    (process, port, the lines seen); the caller stops the process."""
    import queue

    proc = subprocess.Popen([sys.executable, "-m", *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    seen, deadline = [], time.monotonic() + timeout
    while True:
        try:
            ln = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                raise AssertionError(f"{argv[0]} did not start (exit {proc.poll()}): {seen}")
            continue
        seen.append(ln.rstrip())
        if ln.startswith(ready):
            return proc, int(ln.split()[2].rsplit(":", 1)[1]), seen


def http_call(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def stop(proc):
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)


def scaleout_phases(dev, tag, log, kernels, batch=128, steps=12,
                    out="eval/chip_smoke_scaleout"):
    """Phases 35-37, the scale-out training path on the one card, run after
    phase 34:
    (35) an NCCL group of one rank (``multihost.initialize`` over a
    FileStore) and a ``DistributedTrainer`` over its ('dp', 'tp') mesh:
    full-width PoseRegNet (hidden 1024, PCA (30, 42)) at B = ``batch`` for
    ``steps`` steps through K5 under deterministic algorithms, its loss trace
    and parameters bit-equal to the plain Trainer's on the same seed; K5
    against its plain version at this path's shapes; the step of each timed
    in turns (the cost of the group and the gradient averaging); (36) a
    sharded DCP snapshot after epoch 1, resumed by a fresh trainer bit for
    bit, and DCP's save and restore timed against train/checkpoint.py's;
    (37) the ResNet-47 leg, 3 steps through K5, bit-equal to the plain
    Trainer.  Adds these paths' launches to K5's record in ``kernels``."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import NV_VAL, augment_geometry, sample_augment_params
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh, multihost
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    record = {k["name"]: k for k in kernels}
    paths = {"warp_norm": {}}
    cam = NYU_CAMERA
    quiet = dict(log=lambda m: None)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    # --------------------------------------------------------------- 35
    multihost.initialize(store=dist.FileStore(f"{out}/store", 1), num_processes=1,
                         process_id=0, device="cuda", timeout=GROUP_TIMEOUT_S)
    try:
        mesh = make_mesh()
        group = (f"{dist.get_backend()} group of {dist.get_world_size()}, mesh "
                 f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        seq = make_sequence(cam, batch, seed=35)
        data = TrainData.from_sequence(seq)
        prior = fit_pose_prior(cam, np.random.default_rng(35), data.gt3d_crop, data.com,
                               data.cube, 30, num_poses=20_000)
        cfg = TrainConfig(batch_size=batch, n_epochs=steps, use_early_stopping=False,
                          snapshot_every=1)

        def pose():
            return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30))

        def fit(tr, **kw):
            hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
            st, hist = tr.fit(tr.init_state(), data, **quiet, **kw)
            torch.cuda.synchronize()
            return st, list(hist["train_cost"]), dict(hw.LAUNCHES)

        with deterministic_algorithms():
            plain = Trainer(pose(), cfg, cam, prior=prior, device=dev)
            s_plain, c_plain, _ = fit(plain)
            dtr = DistributedTrainer(pose(), cfg, cam, mesh, prior=prior, device=dev)
            s_dist, c_dist, k5 = fit(dtr)
        if k5 != {"warp_norm": steps, "warp_patch": 0}:
            raise AssertionError(f"the distributed fit of {steps} steps launched {k5}")
        paths["warp_norm"]["DistributedTrainer, world of 1 (35)"] = k5["warp_norm"]
        if c_dist != c_plain or not all(
                torch.equal(v, s_dist.model.state_dict()[k])
                for k, v in s_plain.model.state_dict().items()):
            raise AssertionError(f"world-of-one DistributedTrainer != Trainer: {c_dist} vs "
                                 f"{c_plain}")
        # K5 at this path's shapes against its plain version
        bt = data.to(dev).take(torch.arange(batch, device=dev))
        drawn = sample_augment_params(torch.Generator(dev).manual_seed(35), batch, 3)
        modes = ("com", "rot", "none")
        geo = augment_geometry(drawn, bt["com"], bt["cube"], bt["m"], cam, modes, (128, 128))
        want = hw.warp_norm_plain(bt["crops"], hw.warp_norm_params(geo.a_fwd, geo.norm),
                                  0.0, NV_VAL)
        got = hw.launch_warp_norm(bt["crops"], hw.warp_norm_args(
            bt["crops"], drawn, bt["com"], bt["cube"], bt["m"], cam, modes), 0.0, NV_VAL)
        k5_err = float((got.out - want).abs().max())
        if not (torch.equal(got.out, want) and torch.equal(got.m_out, geo.m_out)):
            raise AssertionError(f"K5 at B={batch} != plain ({k5_err})")
        record["warp_norm"]["max_abs_err"] = max(record["warp_norm"]["max_abs_err"], k5_err)
        # the step of each, in turns: what the group and the averaging cost
        gens = plain._epoch_generators(0)
        step_ms, ops = {}, {}
        for name, tr, st in (("plain", plain, s_plain), ("dist", dtr, s_dist),
                             ("dist", dtr, s_dist), ("plain", plain, s_plain)):
            def one(tr=tr, st=st):
                tr._train_step_core(st, bt, gens[0], gens[1], 1e-4)
            for _ in range(3):
                one()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(30):
                one()
            torch.cuda.synchronize()
            step_ms.setdefault(name, []).append((time.perf_counter() - t) * 1e3 / 30)
            if name not in ops:
                ops[name] = len(device_ops(one))
        log(f"[35 distributed train] {tag} {group}; DistributedTrainer, PoseRegNet hidden "
            f"1024 f32, PCA (30, 42), B={batch}, {steps} steps, deterministic algorithms: "
            f"K5 {k5['warp_norm']}x, loss trace and parameters == the plain Trainer's bit "
            f"for bit ({c_plain[0]:.4f} -> {c_plain[-1]:.4f}); K5 == plain at B={batch}; "
            f"step (host clock, 30 steps, in turns): plain "
            + ", ".join(f"{v:.4f}" for v in step_ms["plain"]) + " ms, distributed "
            + ", ".join(f"{v:.4f}" for v in step_ms["dist"])
            + f" ms; device operations per step: plain {ops['plain']}, distributed "
            f"{ops['dist']}")

        # ----------------------------------------------------------- 36
        cfg4 = cfg._replace(n_epochs=4)
        with deterministic_algorithms():
            t1 = DistributedTrainer(pose(), cfg4, cam, mesh, prior=prior, device=dev)
            s1, c1, _ = fit(t1)
            t2 = DistributedTrainer(pose(), cfg4, cam, mesh, prior=prior, device=dev)
            t2.sharded_snapshots = True
            fit(t2, n_epochs=2, snapshot_path=f"{out}/net")
            t3 = DistributedTrainer(pose(), cfg4, cam, mesh, prior=prior, device=dev)
            s3, start = t3.load_train_state(f"{out}/net_last.ckpt", t3.init_state())
            s3, h3 = t3.fit(s3, data, start_epoch=start, **quiet)
        if start != 2 or list(h3["train_cost"]) != c1[2:] or not all(
                torch.equal(v, s3.model.state_dict()[k])
                for k, v in s1.model.state_dict().items()):
            raise AssertionError("the sharded-snapshot resume differs from the "
                                 "uninterrupted run")
        files = sorted(os.listdir(f"{out}/net_last.ckpt/tree"))
        times = {}
        for fmt in ("dcp", "file", "file", "dcp"):
            t1.sharded_snapshots = fmt == "dcp"
            path = f"{out}/timing_{fmt}.ckpt"
            torch.cuda.synchronize()
            t = time.perf_counter()
            t1.save_train_state(path, s1, epoch=3)
            t1._drain_snapshots()
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            t1.load_train_state(path, s1)
            torch.cuda.synchronize()
            times.setdefault(fmt, []).append((save_s, time.perf_counter() - t))
        size = {fmt: sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                         os.walk(f"{out}/timing_{fmt}.ckpt") for f in fs)
                if os.path.isdir(f"{out}/timing_{fmt}.ckpt")
                else os.path.getsize(f"{out}/timing_{fmt}.ckpt") for fmt in times}
        log(f"[36 sharded snapshot] {tag} DCP snapshot after epoch 1 ({files}) resumed by "
            f"a fresh DistributedTrainer: epochs 2-3 losses and parameters == the "
            f"uninterrupted run's bit for bit; save + drain / restore of the trained state "
            f"(params, Adam moments, step; in turns): "
            + "; ".join(f"{fmt} ({size[fmt]} bytes) " + ", ".join(
                f"{a * 1e3:.3f} / {b * 1e3:.3f} ms" for a, b in v) for fmt, v in times.items()))

        # ----------------------------------------------------------- 37
        rcfg = cfg._replace(n_epochs=3)
        with deterministic_algorithms():
            rp = Trainer(ResNet(ResNetConfig(num_joints=1, n_dims=30)), rcfg, cam,
                         prior=prior, device=dev)
            rs_p, rc_p, _ = fit(rp)
            rd = DistributedTrainer(ResNet(ResNetConfig(num_joints=1, n_dims=30)), rcfg, cam,
                                    mesh, prior=prior, device=dev)
            t = time.perf_counter()
            rs_d, rc_d, rk5 = fit(rd)
            r_s = time.perf_counter() - t
        if rk5 != {"warp_norm": 3, "warp_patch": 0} or rc_d != rc_p or not all(
                torch.equal(v, rs_d.model.state_dict()[k])
                for k, v in rs_p.model.state_dict().items()):
            raise AssertionError(f"ResNet-47 leg: K5 {rk5}, losses {rc_d} vs {rc_p}")
        paths["warp_norm"]["ResNet-47 DistributedTrainer (37)"] = rk5["warp_norm"]
        log(f"[37 resnet leg] {tag} ResNet-47 f32 DistributedTrainer, B={batch}, 3 steps "
            f"(deterministic): K5 3x, losses {[round(c, 4) for c in rc_d]} and parameters "
            f"(BatchNorm statistics included) == the plain Trainer's bit for bit; "
            f"{r_s:.3f} s with the init")
        del rp, rd, rs_p, rs_d
    finally:
        dist.destroy_process_group()
    for name, by_path in paths.items():
        record[name]["launches_by_path"] = dict(record[name].get("launches_by_path", {}),
                                                **by_path)
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()


def sharded_serving_phases(dev, tag, log, kernels, replica_batch=64, n_req=2048):
    """Phases 38-40 (after phase 37): (38) ``ShardedEstimator`` with two
    replicas on the card at B = 2 x ``replica_batch``, eager and replayed,
    equal to FusedEstimator on each replica's block bit for bit, also with
    detect=True, K1 in every replica and against its plain version at
    B = ``replica_batch``; the modes that aot_compile took up in this round
    (detect=True, refine_iters=3, 'nd_bilinear') replayed bit-equal to the
    eager _pipeline at B = 1 and ``replica_batch``; (39) serve_http's server
    with --dp 2 against --dp 1, requests/s of one burst each in turns, and
    ``serve_http --dp 2`` as a subprocess answering /healthz and /predict;
    (40) ``python -m deepprior_tpu_torch.mains.dryrun``, a world of one.
    Adds these paths' launches to K1's record in ``kernels``."""
    import io

    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.mains import serve_http
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.ops.crop import clamp_depth, normalized_crop
    from deepprior_tpu_torch.parallel import ShardedEstimator
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    record = {k["name"]: k for k in kernels}
    paths = {"normalized_crop": {}}
    cam = NYU_CAMERA

    # --------------------------------------------------------------- 38
    rng = np.random.default_rng(38)
    b2 = 2 * replica_batch
    pairs = [make_depth_frame(cam, rng) for _ in range(16)]
    depth = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev).repeat(b2 // 16, 1, 1)
    com = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev).repeat(b2 // 16, 1)
    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, dtype=torch.bfloat16),
                       generator=torch.Generator().manual_seed(38))
    sprior = PCAPrior(rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
                      np.zeros(42, np.float32))
    halves = (slice(0, replica_batch), slice(replica_batch, b2))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def blockwise(est, c=None):
        with torch.inference_mode():
            outs = [est._pipeline(depth[h], (com if c is None else c)[h]) for h in halves]
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    notes = []
    for detect in (False, True):
        est = FusedEstimator(model, cam, prior=sprior, device=dev, detect=detect)
        sharded = ShardedEstimator(est, devices=[dev, dev])
        if sharded.dp != 2 or not sharded.graph:
            raise AssertionError(f"ShardedEstimator: dp {sharded.dp}, graph {sharded.graph}")
        c_in = None if detect else com
        zeros = torch.zeros_like(com)
        want = blockwise(est, zeros if detect else None)
        hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
        eager = sharded.eager(depth, c_in)
        torch.cuda.synchronize()
        k1_eager = hopper_crop.LAUNCHES["normalized_crop"]
        hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
        first = sharded(depth, c_in)  # captures one graph per replica
        torch.cuda.synchronize()
        k1_capture = hopper_crop.LAUNCHES["normalized_crop"]
        hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
        replayed = sharded(depth, c_in)
        torch.cuda.synchronize()
        k1_replay = hopper_crop.LAUNCHES["normalized_crop"]
        if not (same(eager, want) and same(first, want) and same(replayed, want)):
            raise AssertionError(f"ShardedEstimator(detect={detect}) != FusedEstimator on "
                                 "each replica's block")
        if (k1_eager, k1_capture, k1_replay) != (2, 4, 0):
            raise AssertionError(f"K1 launches eager/capture/replay {k1_eager}/{k1_capture}/"
                                 f"{k1_replay}, want 2/4/0 (one per replica and call; a "
                                 "capture launches twice; a replay runs no Python)")
        paths["normalized_crop"][f"ShardedEstimator x2, detect={detect}, eager (38)"] = k1_eager
        full = est(depth, c_in)
        notes.append(f"detect={detect}: eager, first call (capture) and replay == "
                     f"FusedEstimator per block bit for bit, K1 {k1_eager}x eager, "
                     f"{k1_capture}x at capture, {k1_replay}x a replay; against one "
                     f"B={b2} FusedEstimator call max |joints d| "
                     f"{(full[0] - replayed[0]).abs().max().item():.6f} mm")
    # K1 at the replica's shape against its plain version
    d64, c64 = depth[:replica_batch].contiguous(), com[:replica_batch].contiguous()
    got = hopper_crop.hopper_normalized_crop(d64, c64, (250.0,) * 3, cam.fx, cam.fy,
                                             fuse_clamp=True)
    want = normalized_crop(clamp_depth(d64)[0], c64, (250.0,) * 3, cam.fx, cam.fy)
    k1_err = float((got[0] - want[0]).abs().max())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K1 at B={replica_batch} != plain ({k1_err})")
    record["normalized_crop"]["max_abs_err"] = max(record["normalized_crop"]["max_abs_err"],
                                                   k1_err)
    # the modes aot_compile captures since this round, against the eager pipeline
    modes = []
    for kw in (dict(detect=True), dict(refine_iters=3), dict(resize="nd_bilinear")):
        est = FusedEstimator(model, cam, prior=sprior, device=dev, **kw)
        for bsz in (1, replica_batch):
            fn = est.aot_compile(bsz, (cam.height, cam.width))
            for rows in (slice(0, bsz), slice(bsz, 2 * bsz)):
                got = fn(depth[rows], com[rows])
                with torch.inference_mode():
                    want = est._pipeline(depth[rows].contiguous(), com[rows].contiguous())
                if not same(got, want):
                    raise AssertionError(f"aot_compile({kw}, B={bsz}) replay != eager")
        modes.append(next(iter(kw)) + ("" if "resize" in kw else f"={next(iter(kw.values()))}"))
    # one graph of B=128 against two replicas of 64 on the card, in turns
    est = FusedEstimator(model, cam, prior=sprior, device=dev)
    one = est.aot_compile(b2, (cam.height, cam.width))
    two = ShardedEstimator(est, devices=[dev, dev]).aot_compile(b2, (cam.height, cam.width))
    one_ms, two_ms = alternate(lambda: one(depth, com), lambda: two(depth, com), 50)
    log(f"[38 sharded estimator] {tag} ShardedEstimator, PoseRegNet bf16 hidden 1024, two "
        f"replicas on {dev} (one CUDA graph each, on a stream of its own), B={b2}: "
        + "; ".join(notes) + f"; K1 == plain at B={replica_batch}; aot_compile with "
        f"{', '.join(modes)}: replays == the eager _pipeline bit for bit at B=1 and "
        f"{replica_batch} on two input batches each; B={b2} (CUDA events around the replay "
        f"callables, copies in and out included, in turns): one graph {one_ms:.4f} ms, two "
        f"replicas {two_ms:.4f} ms")
    del one, two, est
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 39
    depth_np, com_np = (t[:16].cpu().numpy() for t in (depth, com))
    n_threads = 4

    def burst(srv, n):
        futs = [None] * n

        def worker(t):
            for i in range(t, n, n_threads):
                futs[i] = srv.submit(depth_np[i % 16], com_np[i % 16])

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        return np.stack([f.result(timeout=300) for f in futs])

    parser = serve_http.build_parser()
    servers = {dp: serve_http.build_server(parser.parse_args(
        ["--device", str(dev), "--max-batch", "64", "--max-wait-ms", "2", "--dp", str(dp)]))
        for dp in (1, 2)}
    try:
        answers, rate = {}, {1: [], 2: []}
        for dp in (1, 2):
            answers[dp] = burst(servers[dp], 64)  # warm: the graphs are captured
        for dp in (1, 2, 2, 1):
            t = time.perf_counter()
            burst(servers[dp], n_req)
            rate[dp].append(n_req / (time.perf_counter() - t))
        occ = {dp: servers[dp].occupancy() for dp in (1, 2)}
    finally:
        for srv in servers.values():
            srv.close()
    gap = float(np.abs(answers[1] - answers[2]).max())
    proc, port, seen = http_server(["deepprior_tpu_torch.mains.serve_http", "--port", "0",
                                    "--device", str(dev), "--dp", "2", "--max-wait-ms", "20"])
    try:
        health = http_call(port, "GET", "/healthz")
        buf = io.BytesIO()
        np.savez(buf, depth=depth_np[0], com=com_np[0])
        status, body = http_call(port, "POST", "/predict", buf.getvalue())
    finally:
        stop(proc)
    if status != 200 or health[0] != 200 or \
            np.abs(np.asarray(body["joints"], np.float32) - answers[2][0]).max() > 1e-3:
        raise AssertionError(f"serve_http --dp 2: {status} {body}, healthz {health}")
    log(f"[39 serve_http --dp] {tag} serve_http's server (PoseRegNet f32, random weights, "
        f"max batch 64, graphs replayed), {n_req} requests from {n_threads} threads, in turns: "
        f"--dp 1 " + ", ".join(f"{r:.1f}" for r in rate[1]) + " requests/s (occupancy "
        f"{occ[1]:.3f}), --dp 2 (two replicas on one card) "
        + ", ".join(f"{r:.1f}" for r in rate[2]) + f" requests/s (occupancy {occ[2]:.3f}); "
        f"answers of the two within {gap:.6f} mm; serve_http --dp 2 as a subprocess: "
        f"{seen[-1]}; /healthz {health[1]}; /predict 200, joints within 1e-3 mm")

    # --------------------------------------------------------------- 40
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "deepprior_tpu_torch.mains.dryrun"],
                         capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    okline = [ln for ln in res.stdout.splitlines() if ln.startswith("dryrun_multichip OK")]
    if res.returncode != 0 or not okline:
        raise AssertionError(f"dryrun failed ({res.returncode}): {res.stdout[-2000:]} "
                             f"{res.stderr[-3000:]}")
    log(f"[40 dryrun] {tag} python -m deepprior_tpu_torch.mains.dryrun "
        f"({time.perf_counter() - t:.1f} s): {okline[0]}")
    record["normalized_crop"]["launches_by_path"] = dict(
        record["normalized_crop"].get("launches_by_path", {}), **paths["normalized_crop"])


def _gloo_card_rank(rank, world, out, batch, steps):
    """Phase 41's rank: a dp = ``world`` DistributedTrainer over a
    'cpu:gloo,cuda:gloo' group whose ranks all use cuda:0."""
    import torch
    import torch.distributed as dist

    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import NV_VAL, augment_geometry, sample_augment_params
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    multihost.initialize(store=dist.FileStore(f"{out}/store", world), num_processes=world,
                         process_id=rank, device="cuda", backend="cpu:gloo,cuda:gloo",
                         timeout=GROUP_TIMEOUT_S)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        data, prior, cfg, pose, cam = _gloo_card_setup(batch, steps)
        mesh = make_mesh(dp=world)
        hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
        with deterministic_algorithms():
            tr = DistributedTrainer(pose(), cfg, cam, mesh, prior=prior, device=dev)
            st, hist = tr.fit(tr.init_state(), data, log=lambda m: None)
            torch.cuda.synchronize()
        k5 = dict(hw.LAUNCHES)
        # K5 at this rank's shape against its plain version
        local = batch // world
        bt = data.to(dev).take(torch.arange(local, device=dev))
        drawn = sample_augment_params(torch.Generator(dev).manual_seed(41), local, 3)
        modes = ("com", "rot", "none")
        geo = augment_geometry(drawn, bt["com"], bt["cube"], bt["m"], cam, modes, (128, 128))
        want = hw.warp_norm_plain(bt["crops"], hw.warp_norm_params(geo.a_fwd, geo.norm),
                                  0.0, NV_VAL)
        got = hw.launch_warp_norm(bt["crops"], hw.warp_norm_args(
            bt["crops"], drawn, bt["com"], bt["cube"], bt["m"], cam, modes), 0.0, NV_VAL)
        torch.save({"costs": list(hist["train_cost"]), "k5": k5,
                    "k5_equal": bool(torch.equal(got.out, want)),
                    "k5_err": float((got.out - want).abs().max()),
                    "params": {k: v.cpu() for k, v in tr.full_state_dict(st).items()},
                    "backend": dist.get_backend()}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _gloo_card_setup(batch, steps):
    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData

    data = TrainData.from_sequence(make_sequence(NYU_CAMERA, batch, seed=41))
    prior = fit_pose_prior(NYU_CAMERA, np.random.default_rng(41), data.gt3d_crop, data.com,
                           data.cube, 30, num_poses=20_000)
    cfg = TrainConfig(batch_size=batch, n_epochs=steps, use_early_stopping=False)

    def pose():
        return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30),
                          generator=torch.Generator().manual_seed(41))

    return data, prior, cfg, pose, NYU_CAMERA


def gloo_card_phase(dev, tag, log, kernels, world=2, batch=128, steps=3,
                    out="eval/chip_smoke_gloo"):
    """Phase 41: ``world`` processes, each a rank of one 'cpu:gloo,cuda:gloo'
    group and all on the one card (CUDA tensors through gloo), train a
    dp = ``world`` DistributedTrainer at full width (PoseRegNet hidden 1024,
    PCA 30) for ``steps`` steps at a global B = ``batch`` through K5 (each
    rank at B / world, K5 held against its plain version there), under
    deterministic algorithms, against the plain Trainer here on the whole
    batch: the loss trace within rtol 1e-4 and the parameters within 1e-4
    (their deviations logged), K5 ``steps`` times on every rank."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp

    from deepprior_tpu_torch.train.trainer import Trainer

    record = {k["name"]: k for k in kernels}
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t = time.perf_counter()
    mp.start_processes(_gloo_card_rank, args=(world, out, batch, steps), nprocs=world,
                       start_method="spawn")
    wall = time.perf_counter() - t
    ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False) for r in range(world)]
    data, prior, cfg, pose, cam = _gloo_card_setup(batch, steps)
    with deterministic_algorithms():
        single = Trainer(pose(), cfg, cam, prior=prior, device=dev)
        st, hist = single.fit(single.init_state(), data, log=lambda m: None)
    want = np.asarray(hist["train_cost"])
    dev_loss = dev_param = 0.0
    for r, res in enumerate(ranks):
        if res["k5"] != {"warp_norm": steps, "warp_patch": 0} or not res["k5_equal"]:
            raise AssertionError(f"gloo rank {r}: K5 {res['k5']}, == plain {res['k5_equal']}")
        got = np.asarray(res["costs"])
        np.testing.assert_allclose(got, want, rtol=1e-4)
        dev_loss = max(dev_loss, float(np.max(np.abs(got - want) / np.abs(want))))
        for k, v in st.model.state_dict().items():
            d = float((res["params"][k] - v.cpu()).abs().max())
            if d > 1e-4:
                raise AssertionError(f"gloo rank {r}: {k} off by {d}")
            dev_param = max(dev_param, d)
        record["warp_norm"]["max_abs_err"] = max(record["warp_norm"]["max_abs_err"],
                                                 res["k5_err"])
    record["warp_norm"]["launches_by_path"] = dict(
        record["warp_norm"].get("launches_by_path", {}),
        **{f"gloo dp={world} on one card, rank {r} (41)": res["k5"]["warp_norm"]
           for r, res in enumerate(ranks)})
    log(f"[41 gloo on one card] {tag} {world} processes, one {ranks[0]['backend']} group, "
        f"all on {dev}: DistributedTrainer dp={world}, PoseRegNet hidden 1024 f32, B={batch} "
        f"({batch // world} a rank), {steps} steps (deterministic): K5 {steps}x on every "
        f"rank and == plain at B={batch // world}; losses "
        f"{[round(float(c), 4) for c in want]} "
        f"against one device: max relative deviation {dev_loss:.3e}, parameters within "
        f"{dev_param:.3e}; {wall:.1f} s with the processes' start")
    shutil.rmtree(out, ignore_errors=True)


def _spatial_card_setups(batch, steps, res_batch, res_steps):
    """Phases 46-47's legs: {name: (data, prior, cfg, make, camera,
    parameter bound, exact leg)}.  Full-width PoseRegNet (hidden 1024, PCA
    30, dropout, the augmentation, ADAM, float32); ResNet-47 in float32,
    the model users train, and in float64; ScaleNet (the comref net) in
    float32 under ADAM, the optimizer users train it with, and under
    sgd_momentum.  Every leg holds its losses to rtol 1e-4 of one device's
    and ResNet's BatchNorm running statistics to 1e-5, and its parameters
    to 1e-4 where the bound is set (read elsewhere), except a leg that
    names an exact one: float32 ResNet-47 at its initial weights takes the
    loss from 36 to 20 in one step, and two float32 summation orders then
    part by about 5e-4 (both about as far from float64), so that leg is
    bound to one device up to its first update and to the float64 losses
    at rtol 1e-3.  ADAM's first steps are sign-like, so a weight whose
    gradient is small moves by up to lr either way: ScaleNet's ADAM leg
    reads its parameters and logs the worst tensor's last gradient, plain
    and split."""
    import torch

    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.models import (
        PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig, ScaleNet, ScaleNetConfig)
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData

    cam = NYU_CAMERA
    data = TrainData.from_sequence(make_sequence(cam, batch, seed=46))
    prior = fit_pose_prior(cam, np.random.default_rng(46), data.gt3d_crop, data.com,
                           data.cube, 30, num_poses=20_000)
    cfg = TrainConfig(batch_size=batch, n_epochs=steps, use_early_stopping=False)
    small = TrainData(*(np.asarray(a)[:res_batch] for a in data))
    com = small._replace(gt3d_crop=small.gt3d_crop[:, :1])
    rcfg = cfg._replace(batch_size=res_batch, n_epochs=res_steps)
    sgd = rcfg._replace(optimizer="sgd_momentum")

    def seeded(cls, cfg_):
        return lambda: cls(cfg_, generator=torch.Generator().manual_seed(46))

    def resnet(dtype):
        return seeded(ResNet, ResNetConfig(num_joints=1, n_dims=30, dtype=dtype))

    scalenet = seeded(ScaleNet, ScaleNetConfig(num_joints=1, n_dims=3))
    return {
        "pose": (data, prior, cfg, seeded(PoseRegNet, PoseRegNetConfig(num_joints=1, n_dims=30)),
                 cam, 1e-4, None),
        "resnet f32": (small, prior, sgd._replace(model_has_dropout=False),
                       resnet(torch.float32), cam, None, "resnet f64"),
        "resnet f64": (small, prior, sgd._replace(model_has_dropout=False),
                       resnet(torch.float64), cam, 1e-4, None),
        "scalenet adam": (com, None, rcfg, scalenet, cam, None, None),
        "scalenet sgd": (com, None, sgd, scalenet, cam, 1e-4, None),
    }


def _spatial_card_rank(rank, world, out, sizes, device="cuda"):
    """Phases 46-47's rank: a DistributedTrainer of each model over a dp = 1
    x sp = ``world`` mesh of a 'cpu:gloo,cuda:gloo' group whose ranks all use
    cuda:0 (a gloo group on the CPU with ``device`` 'cpu', for a rehearsal),
    and K5 at this path's shape against its plain version."""
    import torch
    import torch.distributed as dist

    from deepprior_tpu_torch.ops import hopper_warp as hw
    from deepprior_tpu_torch.ops.augment import NV_VAL, augment_geometry, sample_augment_params
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    multihost.initialize(store=dist.FileStore(f"{out}/store", world), num_processes=world,
                         process_id=rank, device=device,
                         backend="cpu:gloo,cuda:gloo" if device == "cuda" else "gloo",
                         timeout=GROUP_TIMEOUT_S)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        mesh = make_mesh(dp=1, sp=world)
        setups = _spatial_card_setups(*sizes)
        result = {"backend": dist.get_backend()}
        with deterministic_algorithms():
            for name, (data, prior, cfg, make, cam, *_) in setups.items():
                hw.LAUNCHES.update(dict.fromkeys(hw.LAUNCHES, 0))
                torch.cuda.synchronize()
                t = time.perf_counter()
                tr = DistributedTrainer(make(), cfg, cam, mesh, prior=prior, device=dev)
                st, hist = tr.fit(tr.init_state(), data, log=lambda m: None)
                torch.cuda.synchronize()
                result[name] = {"costs": list(hist["train_cost"]), "k5": dict(hw.LAUNCHES),
                                "s": time.perf_counter() - t,
                                "params": {k: v.cpu() for k, v in
                                           tr.full_state_dict(st).items()},
                                "grads": {k: p.grad.cpu() for k, p in
                                          st.model.named_parameters()}}
        # K5 at this path's shape: every sp rank warps the whole batch
        data, _, cfg, _, cam, *_ = setups["pose"]
        b = cfg.batch_size
        bt = data.to(dev).take(torch.arange(b, device=dev))
        drawn = sample_augment_params(torch.Generator(dev).manual_seed(46), b, 3)
        modes = ("com", "rot", "none")
        geo = augment_geometry(drawn, bt["com"], bt["cube"], bt["m"], cam, modes, (128, 128))
        want = hw.warp_norm_plain(bt["crops"], hw.warp_norm_params(geo.a_fwd, geo.norm),
                                  0.0, NV_VAL)
        got = hw.launch_warp_norm(bt["crops"], hw.warp_norm_args(
            bt["crops"], drawn, bt["com"], bt["cube"], bt["m"], cam, modes), 0.0, NV_VAL)
        result["k5_equal"] = bool(torch.equal(got.out, want))
        result["k5_err"] = float((got.out - want).abs().max())
        torch.save(result, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spatial_card_phases(dev, tag, log, kernels, world=2, batch=128, steps=3, res_batch=32,
                        res_steps=2, out="eval/chip_smoke_sp"):
    """Phases 46-47, the 'sp' axis: ``world`` processes, each a rank of one
    'cpu:gloo,cuda:gloo' group and all on the one card, split the crop height
    over sp = ``world`` (parallel/spatial.py: halo exchanges around the
    convolutions, K5 on every rank at the whole batch) under deterministic
    algorithms, against the plain Trainer here on the same batches.  (46)
    PoseRegNet at full width (hidden 1024, PCA 30, f32, dropout, aug
    com/rot/none) at B = ``batch`` for ``steps`` steps: K5 ``steps`` times on
    every rank and == its plain version at B = ``batch``, the losses within
    rtol 1e-4 and every parameter within 1e-4.  (47) ResNet-47 (float32
    and float64) and ScaleNet (the comref net; ADAM and sgd_momentum) at
    full width, B = ``res_batch``, ``res_steps`` steps: the losses within
    rtol 1e-4, ResNet's BatchNorm running statistics within 1e-5, and the
    parameters within 1e-4 in the legs ``_spatial_card_setups`` bounds
    (read in the others; float32 ResNet-47 as it says).  Logs the largest deviations, the wall time and
    the halo bytes a step and rank, reckoned from the layout.  Gloo carries
    the CUDA tensors through host memory: the time proves the semantics,
    not a speed."""
    import os
    import shutil

    import torch
    import torch.multiprocessing as mp

    from deepprior_tpu_torch.parallel.spatial import SpatialContext, plan_for
    from deepprior_tpu_torch.train.trainer import Trainer

    record = {k["name"]: k for k in kernels}
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    sizes = (batch, steps, res_batch, res_steps)
    t = time.perf_counter()
    mp.start_processes(_spatial_card_rank, args=(world, out, sizes, dev.type), nprocs=world,
                       start_method="spawn")
    wall = time.perf_counter() - t
    ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False) for r in range(world)]
    for r, res in enumerate(ranks):
        if not res["k5_equal"]:
            raise AssertionError(f"sp rank {r}: K5 != plain at B={batch} ({res['k5_err']})")
        record["warp_norm"]["max_abs_err"] = max(record["warp_norm"]["max_abs_err"],
                                                 res["k5_err"])
    setups, plain = _spatial_card_setups(*sizes), {}
    for name, (data, prior, cfg, make, cam, *_) in setups.items():
        with deterministic_algorithms():
            single = Trainer(make(), cfg, cam, prior=prior, device=dev)
            st, hist = single.fit(single.init_state(), data, log=lambda m: None)
        plain[name] = (np.asarray(hist["train_cost"]), st)
    def off(a, b, stats):
        """The largest |a - b| over the statistics (or the parameters) of
        two state dicts, and the tensor it is in."""
        return max((float((a[k].cpu() - v.cpu()).abs().max()), k) for k, v in b.items()
                   if ("running" in k) == stats)

    paths = {}
    for name, (data, prior, cfg, make, cam, bound, exact) in setups.items():
        want, st = plain[name]
        ours = st.model.state_dict()
        n = len(want)
        phase = 46 if name == "pose" else 47
        dev_loss = dev_stat = 0.0
        worst = (0.0, None, None)  # (parameter deviation, tensor, rank)
        for r, res in enumerate(ranks):
            got = res[name]
            costs = np.asarray(got["costs"])
            if got["k5"] != {"warp_norm": n, "warp_patch": 0}:
                raise AssertionError(f"sp rank {r} {name}: {n} steps launched {got['k5']}")
            # a leg held to an exact one: bound to one device up to its first
            # update, and within rtol 1e-3 of the exact losses
            np.testing.assert_allclose(costs[:1] if exact else costs, want[:1] if exact
                                       else want, rtol=1e-4, err_msg=name)
            if exact:
                np.testing.assert_allclose(costs, plain[exact][0], rtol=1e-3, err_msg=name)
            dev_loss = max(dev_loss, float(np.max(np.abs(costs - want) / np.abs(want))))
            if any("running" in k for k in ours):
                d, k = off(got["params"], ours, True)
                if exact is None and d > 1e-5:
                    raise AssertionError(f"sp rank {r} {name}: {k} off by {d} (> 1e-5)")
                dev_stat = max(dev_stat, d)
            d, k = off(got["params"], ours, False)
            if bound is not None and d > bound:
                raise AssertionError(f"sp rank {r} {name}: {k} off by {d} (> {bound})")
            worst = max(worst, (d, k, r), key=lambda w: w[0])
            paths[f"sp={world} {name} on one card, rank {r} ({phase})"] = got["k5"]["warp_norm"]
        d, k, r = worst
        reading = f"parameters within {d:.3e}"
        if bound is None:  # a reading: the worst tensor's last gradient, plain and split
            grads = {k_: p.grad.cpu() for k_, p in st.model.named_parameters()}
            g, g_sp = grads[k], ranks[r][name]["grads"][k]
            reading += (f" (read, not bound: {k}, its last gradient max |g| "
                        f"{float(g.abs().max()):.3e} plain, the split one off by "
                        f"{float((g_sp - g).abs().max()):.3e}; largest gradient "
                        f"{max(float(v.abs().max()) for v in grads.values()):.3e})")
        if exact is not None:  # both float32 runs against the exact one
            ref, ex = plain[exact][0], plain[exact][1].model.state_dict()
            split = ranks[0][name]
            reading += (
                f"; against {exact} one device's losses {ref.tolist()}: the split off by "
                f"{(np.abs(np.asarray(split['costs']) - ref) / ref).tolist()} relative, one "
                f"device by {(np.abs(want - ref) / ref).tolist()}; statistics: the split off "
                f"by {off(split['params'], ex, True)}, one device by {off(ours, ex, True)}; "
                f"parameters: the split off by {off(split['params'], ex, False)}, one device "
                f"by {off(ours, ex, False)}")
        # the halo a step and rank: the rows each exchange brings in, of
        # square maps in the model's compute dtype, forward and back
        model = make()
        itemsize = torch.empty((), dtype=model.cfg.dtype).element_size()
        exchanging = [layer for layout in plan_for(model, SpatialContext(None, 0, world)).layers
                      for layer in layout if layer.own_in is not None]
        channels = ([b.conv1.in_channels for b in model.blocks] if name.startswith("resnet")
                    else [8] * len(exchanging))
        halo = [2 * sum(layer.halo_rows(r) * cfg.batch_size * c * layer.h_in * itemsize
                        for layer, c in zip(exchanging, channels)) for r in range(world)]
        log(f"[{phase} sp] {tag} {world} processes, one {ranks[0]['backend']} group on {dev}: "
            f"DistributedTrainer dp=1 x sp={world}, {name} full width, {cfg.optimizer}, "
            f"B={cfg.batch_size}, {n} steps (deterministic): K5 {n}x on every rank; losses "
            f"{want.tolist()} against one device: max relative deviation {dev_loss:.3e}, "
            f"{reading}"
            + (f", BatchNorm running statistics within {dev_stat:.3e}"
               + (" (read, not bound)" if exact else "") if name.startswith("resnet") else "")
            + f"; halo {halo} bytes a step per rank (forward + backward); "
            f"{max(res[name]['s'] for res in ranks):.1f} s of training on the slowest rank")
    record["warp_norm"]["launches_by_path"] = dict(
        record["warp_norm"].get("launches_by_path", {}), **paths)
    log(f"[46-47 sp] {tag} K5 == plain at B={batch} on every rank; {wall:.1f} s with the "
        f"processes' start (gloo carries CUDA tensors through host memory: semantics, "
        f"not speed)")
    shutil.rmtree(out, ignore_errors=True)


def jax_checkpoint_phase(dev, tag, log, kernels, batch=512, frames=256,
                         out="eval/chip_smoke_jax"):
    """Phase 48, the JAX package's checkpoint format on a machine without
    jax: a full-width PoseRegNet's and a calibrated ResNet-47's
    network_prior.ckpt written in that format (``write_jax_checkpoint``,
    held byte for byte to the JAX package's save_checkpoint in
    deepprior_tpu/train/checkpoint.py by tests/test_torch_jax_checkpoint.py) and in the port's, each through
    load_serving_net into a FusedEstimator at B = ``batch`` NYU frames: K1
    once per call, the joints bit-equal between the two formats; serve_http
    --checkpoint <the JAX file> as a subprocess answering /predict; a JAX
    format ScaleNet net_P0_COM.ckpt through load_refine_net_lazy into a
    comref import of an MSRA15 subject of ``frames`` frames (K1 once per
    chunk of 256)."""
    import io
    import shutil

    import torch

    from deepprior_tpu_torch.camera import MSRA15_CAMERA, NYU_CAMERA
    from deepprior_tpu_torch.data import trees
    from deepprior_tpu_torch.data.importers import MSRA15Importer
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.ops import hopper_crop
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.train.trainer import TrainConfig

    record = {k["name"]: k for k in kernels}
    paths = {}
    shutil.rmtree(out, ignore_errors=True)
    cam = NYU_CAMERA
    rng = np.random.default_rng(48)
    pairs = [make_depth_frame(cam, rng) for _ in range(16)]
    depth = torch.from_numpy(np.stack([p[0] for p in pairs] * (batch // 16))).to(dev)
    com = torch.from_numpy(np.stack([p[1] for p in pairs] * (batch // 16))).to(dev)
    prior_np = {"pca_components": (rng.standard_normal((30, 42)) * 0.05).astype(np.float32),
                "pca_mean": rng.uniform(-0.1, 0.1, 42).astype(np.float32)}
    config = TrainConfig()._asdict()  # the JAX fingerprint: no "model" field
    t0 = time.perf_counter()
    pose = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30),
                      generator=torch.Generator().manual_seed(48))
    resnet, _ = calibrated_resnet(dev, cam, depth[:16], com[:16])
    files = {}
    for name, model in (("poseregnet", pose), ("resnet", resnet)):
        jax_file, port_file = f"{out}/{name}_jax.ckpt", f"{out}/{name}_port.ckpt"
        write_jax_checkpoint(jax_file, dict(flax_variables(model), **prior_np), config)
        save_checkpoint(port_file, dict(params=model.state_dict(), **prior_np),
                        config=dict(config, model=name))
        joints = {}
        for fmt, path in (("jax", jax_file), ("port", port_file)):
            served, prior = load_serving_net(name, checkpoint=path, device=dev)
            est = FusedEstimator(served, cam, prior=prior, device=dev)
            hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
            joints[fmt] = est(depth, com)[0]
            torch.cuda.synchronize()
            if dict(hopper_crop.LAUNCHES) != {"normalized_crop": 1, "normalized_crop_linear": 0}:
                raise AssertionError(f"{name} from the {fmt} format launched "
                                     f"{hopper_crop.LAUNCHES}")
            paths[f"JAX-format {name} network_prior.ckpt, estimator (48)" if fmt == "jax"
                  else f"port-format {name} network_prior.ckpt, estimator (48)"] = 1
        if not (torch.isfinite(joints["jax"]).all() and joints["jax"].shape == (batch, 14, 3)
                and torch.equal(joints["jax"], joints["port"])):
            raise AssertionError(f"{name}: the JAX-format checkpoint's joints differ from "
                                 f"the port format's")
        files[name] = jax_file
    load_s = time.perf_counter() - t0

    # serve_http --checkpoint <the JAX file>
    proc, port, seen = http_server(["deepprior_tpu_torch.mains.serve_http", "--checkpoint",
                                    files["poseregnet"], "--port", "0", "--device", str(dev),
                                    "--max-wait-ms", "20"])
    try:
        buf = io.BytesIO()
        np.savez(buf, depth=pairs[0][0], com=pairs[0][1])
        status, body = http_call(port, "POST", "/predict", buf.getvalue())
    finally:
        stop(proc)
    served, prior = load_serving_net("poseregnet", checkpoint=files["poseregnet"], device=dev)
    want = FusedEstimator(served, cam, prior=prior, device=dev)(depth[:1], com[:1])[0][0]
    http_err = float(np.abs(np.asarray(body.get("joints"), np.float32)
                            - want.cpu().numpy()).max()) if status == 200 else None
    if status != 200 or http_err > 1e-3:
        raise AssertionError(f"serve_http --checkpoint <JAX file>: {status} {body}")

    # a JAX-format ScaleNet through load_refine_net_lazy into a comref import
    root = f"{out}/msra15"
    trees.write_msra15_tree(root, subjects=["P0"], frames=frames, seed=48)
    refiner = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3),
                       generator=torch.Generator().manual_seed(48))
    ckpt = f"{out}/P0_COM/net_P0_COM.ckpt"
    write_jax_checkpoint(ckpt, flax_variables(refiner), config)
    imp = MSRA15Importer(root, use_cache=False, device=dev)
    loaded = imp.load_refine_net_lazy(ckpt)
    if not all(torch.equal(v.cpu(), loaded.model.state_dict()[k].cpu())
               for k, v in refiner.state_dict().items()):
        raise AssertionError("load_refine_net_lazy did not restore the JAX-format ScaleNet")
    hopper_crop.LAUNCHES.update(dict.fromkeys(hopper_crop.LAUNCHES, 0))
    seq = imp.loadSequence("P0", docom=True, device_crop=True)
    torch.cuda.synchronize()
    chunks = -(-frames // 256)
    if dict(hopper_crop.LAUNCHES) != {"normalized_crop": chunks, "normalized_crop_linear": 0}:
        raise AssertionError(f"the comref import of {chunks} chunks launched "
                             f"{hopper_crop.LAUNCHES}")
    if not all(np.isfinite(f.com).all() for f in seq.data):
        raise AssertionError("non-finite refined CoMs")
    paths["JAX-format ScaleNet net_P0_COM.ckpt, comref import (48)"] = chunks
    record["normalized_crop"]["launches_by_path"] = dict(
        record["normalized_crop"].get("launches_by_path", {}), **paths)
    log(f"[48 JAX checkpoint] {tag} a full-width PoseRegNet's and a calibrated ResNet-47's "
        f"network_prior.ckpt in the JAX package's format (b'DPTPU1', flax msgpack), read "
        f"without jax or msgpack through load_serving_net: at B={batch} NYU K1 once per "
        f"call, joints bit-equal to the same weights from the port's format "
        f"({load_s:.1f} s for both families, both formats); serve_http --checkpoint <JAX "
        f"file> answered /predict within {http_err} mm of the estimator; a JAX-format "
        f"ScaleNet net_P0_COM.ckpt through load_refine_net_lazy: every tensor restored, "
        f"the comref import of {len(seq.data)} frames launched K1 {chunks}x")
    shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------------------
# the JAX package's checkpoint format, written without jax (phase 48)
# ---------------------------------------------------------------------------
def _nchw_rows_to_nhwc(kernel, c):
    """A Dense kernel's (in, out) rows from the NCHW flatten order back to
    flax's NHWC one (utils/convert.py's inverse)."""
    rows = kernel.shape[0]
    side = math.isqrt(rows // c)
    return kernel.reshape(c, side, side, -1).transpose(1, 2, 0, 3).reshape(rows, -1)


def flax_variables(model):
    """A port PoseRegNet, ResNet or ScaleNet as the JAX package's flax
    variables ({"params", "batch_stats"}, numpy leaves): the inverse of
    utils/convert.py::state_dict_from_flax."""
    from deepprior_tpu_torch.models import PoseRegNet, ResNet, ScaleNet
    from deepprior_tpu_torch.models.scalenet import FEATURES, tower_sides

    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}

    def conv(pfx):
        return {"kernel": np.ascontiguousarray(sd[f"{pfx}.weight"].transpose(2, 3, 1, 0)),
                "bias": sd[f"{pfx}.bias"]}

    def head(blocks):
        """{Dense_i}: the first kernel's rows back to NHWC, block by block."""
        out, i = {}, 0
        while f"head.dense.{i}.weight" in sd:
            kern = sd[f"head.dense.{i}.weight"].T
            if i == 0:
                parts, start = [], 0
                for c, rows in blocks:
                    parts.append(_nchw_rows_to_nhwc(kern[start:start + rows], c))
                    start += rows
                kern = np.concatenate(parts)
            out[f"Dense_{i}"] = {"kernel": np.ascontiguousarray(kern),
                                 "bias": sd[f"head.dense.{i}.bias"]}
            i += 1
        return out

    rows = sd["head.dense.0.weight"].shape[1]
    if isinstance(model, PoseRegNet):
        n = len(model.convs)
        params = {f"ConvPool_{i}": {"Conv_0": conv(f"convs.{i}.conv")} for i in range(n)}
        params["MLPHead_0"] = head([(model.convs[-1].conv.out_channels, rows)])
        for c in ("c0", "c1"):
            if f"head.{c}" in sd:
                params["MLPHead_0"][c] = sd[f"head.{c}"]
        return {"params": params, "batch_stats": {}}
    if isinstance(model, ScaleNet):
        params = {f"_Tower_{t}": {f"ConvPool_{i}": {"Conv_0": conv(f"towers.{t}.layers.{i}.conv")}
                                  for i in range(len(model.towers[t].layers))}
                  for t in range(len(model.towers))}
        params["MLPHead_0"] = head([(FEATURES, FEATURES * s * s) for s in tower_sides(
            128, model.cfg.resize_factor)])
        return {"params": params, "batch_stats": {}}
    if not isinstance(model, ResNet):
        raise TypeError(f"no flax layout for {type(model).__name__}")

    def bn(pfx):
        return ({"scale": sd[f"{pfx}.weight"], "bias": sd[f"{pfx}.bias"]},
                {"mean": sd[f"{pfx}.running_mean"], "var": sd[f"{pfx}.running_var"]})

    params, stats = {"Conv_0": conv("stem")}, {}
    for i in range(len(model.blocks)):
        bp, bs = {}, {}
        for j in range(3):
            bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"] = bn(f"blocks.{i}.bn{j}")
            bp[f"Conv_{j}"] = conv(f"blocks.{i}.conv{j}")
        if f"blocks.{i}.shortcut.weight" in sd:
            bp["Conv_3"] = conv(f"blocks.{i}.shortcut")
        params[f"_Bottleneck_{i}"], stats[f"_Bottleneck_{i}"] = bp, bs
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("bn")
    params.update(head([(sd["bn.weight"].shape[0], rows)]))
    return {"params": params, "batch_stats": stats}


def _msgpack(obj, out):
    """Append msgpack's encoding of ``obj`` as flax.serialization.to_bytes
    writes it (msgpack-python's packb, bin type on, strict types): dicts in
    sorted key order (the order jax.device_get leaves them in), numpy
    arrays and scalars as flax's ext types 1 and 3."""
    import struct

    def head(small, base, codes, n):
        if small is not None and n <= small:
            out.append(base | n)
            return
        for code, width in codes:
            if n < 1 << (8 * width):
                out.append(code)
                out.extend(n.to_bytes(width, "big"))
                return
        raise ValueError(f"{n} items or bytes do not fit msgpack")

    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out.extend(obj.to_bytes(1, "big", signed=obj < 0))
        elif obj >= 0:
            for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if obj < 1 << (8 * width):
                    out.append(code)
                    out.extend(obj.to_bytes(width, "big"))
                    break
        else:
            for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
                if obj >= -(1 << (8 * width - 1)):
                    out.append(code)
                    out.extend(obj.to_bytes(width, "big", signed=True))
                    break
    elif type(obj) is float:
        out.append(0xCB)
        out.extend(struct.pack(">d", obj))
    elif type(obj) is str:
        raw = obj.encode()
        head(31, 0xA0, ((0xD9, 1), (0xDA, 2), (0xDB, 4)), len(raw))
        out.extend(raw)
    elif type(obj) is bytes:
        head(None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)), len(obj))
        out.extend(obj)
    elif type(obj) in (list, tuple):
        head(15, 0x90, ((0xDC, 2), (0xDD, 4)), len(obj))
        for v in obj:
            _msgpack(v, out)
    elif type(obj) is dict:
        head(15, 0x80, ((0xDE, 2), (0xDF, 4)), len(obj))
        for k in sorted(obj):
            _msgpack(k, out)
            _msgpack(obj[k], out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        data = bytearray()
        _msgpack((tuple(int(s) for s in arr.shape), arr.dtype.name, arr.tobytes("C")), data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            head(None, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4)), len(data))
        out.append(1 if isinstance(obj, np.ndarray) else 3)
        out.extend(data)
    else:
        raise TypeError(f"no msgpack encoding for {type(obj).__name__}")
    return out


def jax_checkpoint_bytes(tree, config=None) -> bytes:
    """The bytes the JAX package's save_checkpoint (deepprior_tpu/train/
    checkpoint.py) writes for
    ``tree`` (dicts of numpy arrays and Python scalars) and ``config`` (a
    dict): b"DPTPU1\\x00", the fingerprint JSON's length and the JSON, then
    flax's msgpack of the tree."""
    fp = json.dumps(config, sort_keys=True, indent=1).encode()
    return b"DPTPU1\x00" + len(fp).to_bytes(8, "little") + fp + bytes(_msgpack(tree, bytearray()))


def write_jax_checkpoint(path, tree, config=None):
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(jax_checkpoint_bytes(tree, config))


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
        drawn = sample_augment_params(gen, bsz, 3)
        geo = augment_geometry(drawn, batch["com"], batch["cube"], batch["m"], cam,
                               ("com", "rot", "none"), (128, 128))
        img, _ = hw.unnormalize(batch["crops"], geo.norm)
        p6 = hw.warp_patch_params(geo.a_fwd)
        # K5 from the draws, its geometry included; its bytes as warp_bytes
        # counts them from the (B, 15) params the kernel computes itself
        k5_params = hw.warp_norm_params(geo.a_fwd, geo.norm)
        args5 = hw.warp_norm_args(batch["crops"], drawn, batch["com"], batch["cube"],
                                  batch["m"], cam, ("com", "rot", "none"))
        k4_ms, k5_ms = alternate(
            lambda: hw.launch_warp(img, p6, 0.0, NV_VAL),
            lambda: hw.launch_warp_norm(batch["crops"], args5, 0.0, NV_VAL), 50, graph_ms)
        rows += [("warp_patch", bsz, k4_ms, hw.warp_bytes(p6, (128, 128)),
                  hw.FP32_OPS_PER_PIXEL["warp_patch"] * bsz * 128 * 128),
                 ("warp_norm", bsz, k5_ms, hw.warp_bytes(k5_params, (128, 128), fused=True),
                  hw.FP32_OPS_PER_PIXEL["warp_norm"] * bsz * 128 * 128)]
    full = data.take(torch.arange(data.n, device=dev))
    for fuse, name in ((False, "warp_patch"), (True, "warp_norm")):
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
    if _EXPIRED.is_set():
        raise SystemExit(3)
