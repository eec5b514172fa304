"""The port's flop accounting and roofline inputs on the CPU.

- deepprior_tpu_torch/utils/flops.py against deepprior_tpu/utils/flops.py:
  ``crop_selection_flops`` and ``mfu_pct`` equal over a grid of arguments;
  the peaks are None on the CPU, honour DEEPPRIOR_PEAK_TFLOPS, and match
  the H100's data-sheet row by device name; ``model_flops`` of a small
  PoseRegNet equals the analytic 2 x MAC count of its convs and denses.
- The byte models beside the kernels' wrappers (``crop_bytes`` for K1/K2,
  ``warp_bytes`` for K4/K5) against independent counts: the frame pixels
  that receive a gradient through the plain crop or warp (each output
  pixel of the nearest maps depends on exactly one source pixel), and a
  brute-force set of K2's taps.
"""

import itertools

import numpy as np
import pytest
import torch

from deepprior_tpu.utils import flops as jflops

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_depth_frame
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.ops import hopper_crop, hopper_warp
from deepprior_tpu_torch.ops.crop import normalized_crop
from deepprior_tpu_torch.ops.resize import halfpixel_taps
from deepprior_tpu_torch.utils import flops


@pytest.mark.parametrize("bilinear", [False, True])
def test_crop_selection_flops_and_mfu_match_jax(bilinear):
    for batch, win_h, win_w, dh, dw in itertools.product(
            (1, 64, 512), (96, 304, 480), (128, 512, 640), (64, 128), (128,)):
        args = (batch, win_h, win_w, dh, dw, bilinear)
        assert flops.crop_selection_flops(*args) == jflops.crop_selection_flops(*args)
    for f, s, peak in itertools.product((0.0, 1e9, 3.5e12), (0.0, 1e-3, 2.0),
                                        (None, 0.0, 197.0, 989.0)):
        assert flops.mfu_pct(f, s, peak) == jflops.mfu_pct(f, s, peak)


def test_peaks(monkeypatch):
    monkeypatch.delenv("DEEPPRIOR_PEAK_TFLOPS", raising=False)
    for fn in (flops.peak_tflops, flops.peak_hbm_tbps, flops.peak_fp32_tflops):
        assert fn("cpu") is None
        if not torch.cuda.is_available():
            assert fn() is None
    with pytest.raises(RuntimeError, match="no peak"):
        flops.roofline_ms(1e9, device="cpu")
    monkeypatch.setenv("DEEPPRIOR_PEAK_TFLOPS", "123.5")
    assert flops.peak_tflops("cpu") == 123.5 and flops.peak_tflops() == 123.5
    monkeypatch.delenv("DEEPPRIOR_PEAK_TFLOPS")
    # the card's row, matched on its name
    for name, want in (("NVIDIA H100 80GB HBM3", (989.0, 3.35, 67.0)),
                       ("NVIDIA H100 PCIe", (None, None, None)),
                       ("NVIDIA A100-SXM4-80GB", (None, None, None))):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        got = (flops.peak_tflops("cuda:0"), flops.peak_hbm_tbps("cuda:0"),
               flops.peak_fp32_tflops("cuda:0"))
        assert got == want, name
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    ms, by = flops.roofline_ms(3.35e9, device="cuda:0")
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = flops.roofline_ms(3.35e9, 67e12 * 2e-3, device="cuda:0")
    assert (ms, by) == (pytest.approx(2.0), "operations")


def test_model_flops_of_a_small_poseregnet():
    b, hidden, out = 3, 16, 30
    net = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=out, hidden=hidden))
    net.eval()
    x = torch.zeros((b, 1, 128, 128))
    mac = b * (124 * 124 * 8 * 1 * 25      # conv 5x5, 1 -> 8, then pool 4
               + 27 * 27 * 8 * 8 * 25      # conv 5x5, 8 -> 8, then pool 2
               + 11 * 11 * 8 * 8 * 9       # conv 3x3, 8 -> 8
               + 968 * hidden + hidden * hidden + hidden * out)
    assert flops.model_flops(net, x) == 2 * mac
    assert flops.model_flops(lambda t: t + 1.0, x) is None


@pytest.fixture(scope="module")
def nyu_frames():
    rng = np.random.default_rng(7)
    pairs = [make_depth_frame(NYU_CAMERA, rng) for _ in range(3)]
    depth = torch.from_numpy(np.stack([p[0] for p in pairs]))
    com = torch.from_numpy(np.stack([p[1] for p in pairs]))
    com[1, 0] = 5.0  # a window that leaves the frame on the left
    return depth, com


def _touched(fn, shape):
    """Pixels of a (B, H, W) input that receive a gradient from fn."""
    x = torch.full(shape, 700.0, requires_grad=True)
    fn(x).sum().backward()
    return int((x.grad != 0).sum())


@pytest.mark.parametrize("cube", [(250.0,) * 3, (120.0,) * 3])
def test_crop_bytes_nearest_counts_the_pixels_read(nyu_frames, cube):
    depth, com = nyu_frames
    com = com.clone()
    com[:, 2] = 700.0  # every pixel of the frames at 700 mm: none thresholded
    params, _ = hopper_crop.crop_params(depth, com, cube, NYU_CAMERA.fx, NYU_CAMERA.fy)
    b, h, w = depth.shape
    n_px = _touched(lambda x: normalized_crop(x, com, cube, NYU_CAMERA.fx,
                                              NYU_CAMERA.fy)[0], depth.shape)
    want = 4 * (n_px + params.numel() + b * 128 * 128)
    assert hopper_crop.crop_bytes(params, (h, w)) == want
    # a 250 mm cube at 700 mm spans more than 128 px: the crop downsamples
    # and needs at most one pixel per output pixel
    assert n_px <= b * 128 * 128


def test_crop_bytes_linear_counts_distinct_taps(nyu_frames):
    depth, com = nyu_frames
    cube = (250.0,) * 3
    params, _ = hopper_crop.crop_params(depth, com, cube, NYU_CAMERA.fx, NYU_CAMERA.fy)
    b, h, w = depth.shape
    col = {n: params[:, i] for i, n in enumerate(hopper_crop.PARAM_NAMES)}
    n_px = 0
    for i in range(b):  # brute force: the set of taps of every output pixel
        def taps(n_out, off, sz, extent, start, limit):
            out = set()
            for o in range(n_out):
                of = torch.tensor(float(o))
                if not (of >= col[off][i] and of < col[off][i] + col[sz][i]):
                    continue
                t0, t1, _ = halfpixel_taps(of, col[off][i], col[sz][i], col[extent][i],
                                           col[start][i])
                out |= {int(t) for t in (t0, t1) if 0 <= t < limit}
            return out
        xs = taps(128, "off_x", "sz_w", "wb", "xstart", w)
        ys = taps(128, "off_y", "sz_h", "hb", "ystart", h)
        n_px += len(xs) * len(ys)
    want = 4 * (n_px + params.numel() + b * 128 * 128)
    assert hopper_crop.crop_bytes(params, (h, w), linear=True) == want
    # distinct taps, not four reads a pixel
    assert want < 4 * (4 * b * 128 * 128 + params.numel() + b * 128 * 128)
    assert want > hopper_crop.crop_bytes(params, (h, w))


def test_warp_bytes_counts_the_pixels_read():
    b, hw = 6, (32, 32)
    rng = np.random.default_rng(3)
    ang = np.deg2rad(rng.uniform(-180, 180, b)).astype(np.float32)
    m = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    m[:, 0, 0], m[:, 0, 1] = np.cos(ang), np.sin(ang)
    m[:, 1, 0], m[:, 1, 1] = -np.sin(ang), np.cos(ang)
    m[:, :2, 2] = 16.0 + rng.uniform(-4, 4, (b, 2))
    m[0] = np.eye(3)  # the identity reads every pixel
    m[1, :2] *= 0.5   # a 2x zoom-in reads a quarter of them
    params = hopper_warp.warp_patch_params(torch.from_numpy(m))
    n_px = _touched(lambda x: hopper_warp.warp_patch_plain(x, params), (b, *hw))
    got = hopper_warp.warp_bytes(params, hw)
    assert got == 4 * (n_px + params.numel() + b * 32 * 32)
    norm = torch.zeros((b, len(hopper_warp.NORM_COLS)))
    k5 = hopper_warp.warp_norm_params(torch.from_numpy(m), norm)
    assert hopper_warp.warp_bytes(k5, hw, fused=True) == 4 * (
        2 * b * 32 * 32 + k5.numel())
    assert n_px < b * 32 * 32
