"""CPU self-tests of the benchmark's yardstick: the traffic repeats for a
seed, the byte and flop models equal the port's at each cell's shapes, the
trace reduction and the metric readers compute what they say, and the
command refuses to run without a card.

    python -m pytest bench_torch/tests -q
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_torch.lib import frames, spec, system
from bench_torch.lib.harness import Record
from bench_torch.lib.trace import reduce_trace
from bench_torch.models import crop_bytes, flops, peaks, warp_bytes
from bench_torch.reference import geometry as G

ROOT = spec.ROOT
BENCH = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CFG = {name[:-5]: spec.load_json(os.path.join(spec.BENCH_DIR, "configs", name))
       for name in os.listdir(os.path.join(spec.BENCH_DIR, "configs"))}


def _serve_arrivals():
    return spec.load_module(os.path.join(spec.BENCH_DIR, "traffic", "serve_open.py"),
                            "serve_open_t").arrivals


def test_frames_and_arrivals_repeat_for_a_seed():
    cfg = CFG["poseregnet_nyu"]
    a = frames.render_pool(cfg, system.rng(2**31 + 5, "frames"), 3)
    b = frames.render_pool(cfg, system.rng(2**31 + 5, "frames"), 3)
    c = frames.render_pool(cfg, system.rng(2**31 + 6, "frames"), 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    arrivals = _serve_arrivals()
    d1, w1 = arrivals(2**31 + 5, 2000.0, 3.0, 256)
    d2, w2 = arrivals(2**31 + 5, 2000.0, 3.0, 256)
    d3, _ = arrivals(2**31 + 6, 2000.0, 3.0, 256)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(w1, w2)
    assert len(d1) == len(d3) == 6000 and np.all(np.diff(d1) >= 0) and d1[-1] < 3.0


def test_frames_are_the_ports_frames():
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_depth_frame

    cfg = CFG["poseregnet_nyu"]
    depth, com, _ = frames.render_pool(cfg, np.random.default_rng(11), 2)
    rng = np.random.default_rng(11)
    for i in range(2):
        d, c = make_depth_frame(NYU_CAMERA, rng)
        np.testing.assert_array_equal(depth[i], d)
        np.testing.assert_array_equal(com[i], c)


def test_crop_bytes_equal_the_ports_at_the_serving_shapes():
    from deepprior_tpu_torch.ops.hopper_crop import FP32_OPS_PER_PIXEL, crop_params
    from deepprior_tpu_torch.ops.hopper_crop import crop_bytes as port_crop_bytes

    cfg = CFG["poseregnet_nyu"]
    cam = G.Camera.of(cfg)
    depth, com, _ = frames.render_pool(cfg, np.random.default_rng(3), 64)
    d, c = torch.from_numpy(depth), torch.from_numpy(com)
    cube = torch.tensor(cfg["cube_mm"]).expand(64, 3)
    params, _ = crop_params(d, c, cube, cam.fx, cam.fy, fuse_clamp=True)
    ours = crop_bytes.crop_bytes_per_sample(c, cube, cam.fx, cam.fy, depth.shape[1:])
    assert int(ours.sum()) == port_crop_bytes(params, depth.shape[1:])
    assert crop_bytes.FP32_OPS_PER_PIXEL == FP32_OPS_PER_PIXEL["normalized_crop"]


def test_warp_bytes_equal_the_ports_at_the_training_shapes():
    from deepprior_tpu_torch.ops.hopper_warp import FP32_OPS_PER_PIXEL
    from deepprior_tpu_torch.ops.hopper_warp import warp_bytes as port_warp_bytes

    b = 128
    params = torch.zeros(b, warp_bytes.PARAM_FLOATS)
    assert warp_bytes.warp_bytes(b) == port_warp_bytes(params, (128, 128), fused=True)
    assert warp_bytes.FP32_OPS_PER_PIXEL == FP32_OPS_PER_PIXEL["warp_norm"]


# DeepPrior++'s ResNet-47 (deep-prior-pp src/net/resnet.py type 2), a family
# the generators build, though no configuration of BENCHMARK.json uses it yet
RESNET47 = {"model": {"family": "resnet", "type": 2, "depth": 47,
                      "stages": [32, 64, 128, 256, 256], "hidden": 1024, "dropout": True,
                      "dropout_rate": 0.3, "out_dim": 30}}


@pytest.mark.parametrize("config,batches", [("poseregnet_nyu", (1, 64, 128)),
                                            ("resnet47_nyu", (1, 128))])
def test_flops_equal_the_ports(config, batches):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = RESNET47 if config == "resnet47_nyu" else CFG[config]
    specs = [cfg["model"]] + ([cfg["refiner"]] if "refiner" in cfg else [])
    for net_spec in specs:
        layout = system._program_net(net_spec, torch.float32).state_dict()
        for b in batches:
            net = system._program_net(net_spec, torch.float32)
            x = torch.empty((b, 1, 128, 128), device="meta")
            counter = FlopCounterMode(display=False)
            with counter, torch.no_grad():
                net.eval()(x)
            assert flops.forward_flops(net_spec["family"], layout, b) == counter.get_total_flops()
            counter = FlopCounterMode(display=False)
            with counter:
                net.train()(x).sum().backward()
            assert flops.train_step_flops(net_spec["family"], layout, b) \
                == counter.get_total_flops()
    if config == "resnet47_nyu":  # one frame's forward flops, as FlopCounterMode counts the port's model
        layout = system._program_net(cfg["model"], torch.float32).state_dict()
        assert flops.forward_flops("resnet", layout, 1) == 249_622_528


class _Event:
    def __init__(self, name, start, dur, device, kind):
        self._v = (name, start, dur, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def is_user_annotation(self):
        return self._v[4] == "user_annotation"


def _recorded_profile():
    """A 100 us window: two launches of K1 (10 us each), one of K5 (20 us),
    a copy (10 us) overlapping the second K1, so 45 us busy, and host spans
    and calls around them."""
    ev = [
        _Event("normalized_crop_kernel", 10_000, 10_000, "CUDA", "kernel"),
        _Event("normalized_crop_kernel", 40_000, 10_000, "CUDA", "kernel"),
        _Event("Memcpy HtoD", 45_000, 10_000, "CUDA", "gpu_memcpy"),
        _Event("warp_norm_kernel", 70_000, 20_000, "CUDA", "kernel"),
        _Event("bench:batch_step", 0, 60_000, "CPU", "user_annotation"),
        _Event("bench:batch_step", 0, 60_000, "CUDA", "gpu_user_annotation"),
        _Event("aten::copy_", 20_000, 15_000, "CPU", "cpu_op"),
        _Event("cudaStreamSynchronize", 55_000, 14_000, "CPU", "cuda_runtime"),
    ]
    return reduce_trace(ev, (0, 100_000))


def test_trace_reduction():
    t = _recorded_profile()
    assert t["busy_s"] == pytest.approx(45e-6)
    assert t["window_s"] == pytest.approx(100e-6)
    assert t["ops"]["normalized_crop_kernel"] == (2, pytest.approx(20e-6))
    gaps = t["idle_by_host"]
    assert gaps["batch_step | -"] == pytest.approx(10e-6)  # [0, 10) us
    assert gaps["- | -"] == pytest.approx(10e-6)  # [90, 100) us
    assert gaps["batch_step | aten::copy_"] == pytest.approx(20e-6)  # [20, 40) us
    assert gaps["- | cudaStreamSynchronize"] == pytest.approx(15e-6)  # [55, 70) us


def _reader(name):
    return spec.metric_reader(name).read


def test_metric_readers_on_a_recorded_profile():
    peak = peaks.H100_SXM
    # two steps began in the profiled window, one after it
    tracer = SimpleNamespace(perf_window=(0.0, 10.0),
                             spans={"step": [(0.5, 0.6), (9.0, 9.5), (10.5, 11.0)]})
    values = {"server": {"frames": 96, "batches": 2}, "max_batch": 64,
              "k1_batch_bytes": [(1.0, 3_350_000), (2.0, 3_350_000), (11.0, 1)],
              "batch_spans": [(0.0, 0.5), (1.0, 1.5)], "flops_per_batch": 6.7e12,
              "steps": 10, "window_s": 2.0, "step_flops": 1.34e13, "batch": 128,
              "detect_s": [0.01, 0.03], "pose_s": [0.002, 0.004], "frames": 100,
              "flops_per_frame": 1.34e9}
    rec = Record(values, tracer, _recorded_profile(), peak)
    assert _reader("server_occupancy_pct.serve")(rec) == pytest.approx(75.0)
    # 3.35 MB at 3.35 TB/s = 1 us against a 10 us mean launch
    assert _reader("k1_roofline_pct.serve")(rec) == pytest.approx(10.0)
    # 2 batches of 6.7 TFLOP in 1 s of spans over 67 TFLOP/s
    assert _reader("mfu_pct.serve")(rec) == pytest.approx(20.0)
    for cell in ("serve", "train", "camera"):
        assert _reader(f"device_idle_pct.{cell}")(rec) == pytest.approx(55.0)
    assert _reader("mfu_pct.train")(rec) == pytest.approx(100.0)
    assert _reader("step_device_ms.train")(rec) == pytest.approx(0.025)  # 50 us, two steps
    k5 = 100.0 * warp_bytes.warp_bytes(128) / peak.hbm_bytes / 20e-6
    assert _reader("k5_roofline_pct.train")(rec) == pytest.approx(k5)
    assert _reader("detect_ms.camera")(rec) == pytest.approx(20.0)
    assert _reader("pose_ms.camera")(rec) == pytest.approx(3.0)
    assert _reader("mfu_pct.camera")(rec) == pytest.approx(0.1)
    empty = Record({}, SimpleNamespace(), {}, None)
    for m in BENCH["per_layer"]:
        assert _reader(m["name"])(empty) is None


def test_every_benchmark_entry_has_its_files():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "traffic", cell.generator + ".py"))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"]).read


def test_run_refuses_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    cell = BENCH["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch", "run.py"), "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_no_jax_on_the_run_path():
    code = ("import sys, runpy; sys.argv = ['x']; "
            "import bench_torch.lib.harness, bench_torch.reference.train, "
            "bench_torch.reference.camera; "
            "from bench_torch.lib import spec; "
            "[spec.generator_module(d) for d in ('serve_open', 'train', 'camera_loop')]; "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'deepprior_tpu', 'bench'))))")
    proc = subprocess.run([sys.executable, "-c", "import json; " + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []
