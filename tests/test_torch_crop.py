"""The port's crop (deepprior_tpu_torch.ops) against the JAX package.

Three references, all on the same numpy inputs:
  (a) deepprior_tpu.ops.crop.normalized_crop (the XLA gather path):
      bit-exact crops, exact bounds, M within rtol 1e-6;
  (b) the Pallas kernel pallas_normalized_crop(fuse_clamp=True) in
      interpret mode, on raw frames with injected out-of-range pixels:
      bit-exact;
  (c) the numpy oracle data/detector_np.HandCropper.crop_area_3d:
      bit-exact mm crops, as bench.py asserts for the JAX paths.
The port's hopper_normalized_crop runs its plain version on CPU tensors,
so it is held to the same references.

The resize methods 'linear' (cv2 INTER_LINEAR) and 'nd_bilinear' are held
to the host twin bit for bit (the same float32 op order, no FMA), to the
JAX gather within rtol 3e-7, atol 1e-3 mm (XLA may contract the blend into
FMAs), to its one-hot form within rtol 1e-5, atol 2e-2 mm (separable
summation order), and to the interpret-mode Pallas K2 on normalized crops
within rtol 1e-4, atol 1e-4.
"""

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu.data.detector_np import HandCropper
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.ops import crop as jcrop
from deepprior_tpu.ops.pallas_crop import pallas_normalized_crop

from deepprior_tpu_torch.ops import crop as tcrop
from deepprior_tpu_torch.ops.hopper_crop import hopper_normalized_crop

CAMERAS = {"nyu": NYU_CAMERA, "icvl": ICVL_CAMERA}
CUBES = {"250": 250.0, "900": 900.0}


def _scene(cam, seed, n=4):
    """n raw frames; sample 1 has d = 0 (the centred fallback), sample 2
    a CoM 10 px inside the top-left corner, sample 3 inside the
    bottom-right one."""
    rng = np.random.default_rng(seed)
    frames = [make_frame(cam, rng) for _ in range(n)]
    raw = np.stack([f.extraData["dpt_full"] for f in frames])
    com = np.stack([f.com for f in frames]).astype(np.float32)
    com[1, 2] = 0.0
    com[2, :2] = (10.0, 12.0)
    com[3, :2] = (cam.width - 15.0, cam.height - 8.0)
    return raw, com


@pytest.fixture(scope="module")
def scenes():
    return {"nyu": _scene(NYU_CAMERA, 11), "icvl": _scene(ICVL_CAMERA, 12)}


def _with_outliers(raw, seed=5):
    """Raw frames with 1% of pixels set to 1600-2500 mm, which the
    per-image clamp must remove."""
    rng = np.random.default_rng(seed)
    out = np.array(raw)
    mask = rng.uniform(size=out.shape) < 0.01
    out[mask] = rng.uniform(1600.0, 2500.0, mask.sum())
    return out


def test_clamp_depth_matches_jax(scenes):
    raw = _with_outliers(scenes["nyu"][0])
    want, wmin, wmax = jcrop.clamp_depth(raw)
    got, gmin, gmax = tcrop.clamp_depth(torch.from_numpy(raw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gmin.numpy(), np.asarray(wmin))
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(wmax))


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
@pytest.mark.parametrize("cube_name", ["250", "900"])
@pytest.mark.parametrize("zero_one", [False, True])
def test_normalized_crop_matches_jax_gather(scenes, cam_name, cube_name, zero_one):
    """(a): bit-exact crops, exact bounds, M within rtol 1e-6."""
    cam = CAMERAS[cam_name]
    raw, com = scenes[cam_name]
    cube = np.full(3, CUBES[cube_name], np.float32)
    clamped = np.array(jcrop.clamp_depth(raw)[0])
    want, m_want = jcrop.normalized_crop(
        clamped, com, cube, cam.fx, cam.fy, norm_zero_one=zero_one
    )
    got, m_got = tcrop.normalized_crop(
        torch.from_numpy(clamped), torch.from_numpy(com), cube, cam.fx, cam.fy,
        norm_zero_one=zero_one,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), rtol=1e-6)

    hw = (cam.height, cam.width)
    np.testing.assert_array_equal(
        tcrop.crop_transform(torch.from_numpy(com), cube, cam.fx, cam.fy, hw).numpy(),
        m_got.numpy(),
    )
    for g, w in zip(
        tcrop.com_to_bounds(torch.from_numpy(com), cube, cam.fx, cam.fy, hw),
        jcrop.com_to_bounds(com, cube, cam.fx, cam.fy, hw),
    ):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # the wrapper's CPU path: raw frames, clamp fused
    fused, m_fused = hopper_normalized_crop(
        torch.from_numpy(raw), torch.from_numpy(com), cube, cam.fx, cam.fy,
        norm_zero_one=zero_one, fuse_clamp=True,
    )
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))
    np.testing.assert_array_equal(m_fused.numpy(), m_got.numpy())


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
@pytest.mark.parametrize("cube_name", ["250", "900"])
@pytest.mark.parametrize("zero_one", [False, True])
def test_fused_clamp_matches_pallas_interpret(scenes, cam_name, cube_name, zero_one):
    """(b): the Pallas kernel's fused clamp on raw frames with outliers."""
    cam = CAMERAS[cam_name]
    raw, com = scenes[cam_name]
    raw = _with_outliers(raw)
    cube = np.full(3, CUBES[cube_name], np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, _ = pallas_normalized_crop(
            raw, com, cube, cam.fx, cam.fy, norm_zero_one=zero_one,
            fuse_clamp=True,
        )
    want = np.asarray(want)
    got, _ = hopper_normalized_crop(
        torch.from_numpy(raw), torch.from_numpy(com), cube, cam.fx, cam.fy,
        norm_zero_one=zero_one, fuse_clamp=True,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    # and the plain clamp-then-crop order
    clamped, _, _ = tcrop.clamp_depth(torch.from_numpy(raw))
    plain, _ = tcrop.normalized_crop(
        clamped, torch.from_numpy(com), cube, cam.fx, cam.fy,
        norm_zero_one=zero_one,
    )
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
@pytest.mark.parametrize("cube_name", ["250", "900"])
def test_crop3d_matches_numpy_oracle(scenes, cam_name, cube_name):
    """(c): mm crops bit-exact against the host oracle, per frame."""
    cam = CAMERAS[cam_name]
    raw, com = scenes[cam_name]
    size = (CUBES[cube_name],) * 3
    clamped, _, _ = tcrop.clamp_depth(torch.from_numpy(raw))
    got, m_got = tcrop.crop3d(clamped, torch.from_numpy(com), size, cam.fx, cam.fy)
    for i in range(raw.shape[0]):
        want, m_want, _ = HandCropper(raw[i], cam).crop_area_3d(com=com[i], size=size)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_allclose(m_got[i].numpy(), m_want, rtol=1e-6)
    # normalize of the oracle's crop == the wrapper's fused output
    want_norm = tcrop.normalize_crop(
        torch.from_numpy(np.stack([
            HandCropper(raw[i], cam).crop_area_3d(com=com[i], size=size)[0]
            for i in range(raw.shape[0])
        ])),
        torch.from_numpy(com[:, 2]), torch.full((raw.shape[0],), size[2]),
    )
    fused, _ = hopper_normalized_crop(
        torch.from_numpy(raw), torch.from_numpy(com), size, cam.fx, cam.fy,
        fuse_clamp=True,
    )
    np.testing.assert_array_equal(fused.numpy(), want_norm.numpy())


def test_onehot_method_and_tpu_knobs_change_nothing(scenes):
    """'onehot' is the same crop; win_rows, win_cols and block_k are the
    TPU kernel's speed knobs and leave the output unchanged."""
    cam = NYU_CAMERA
    raw, com = scenes["nyu"]
    dpt, com_t = torch.from_numpy(raw), torch.from_numpy(com)
    cube = (250.0, 250.0, 250.0)
    ref, m_ref = hopper_normalized_crop(dpt, com_t, cube, cam.fx, cam.fy,
                                        fuse_clamp=True)
    for kw in (dict(win_rows=304), dict(win_cols=640),
               dict(win_rows=304, win_cols=640, block_k=3)):
        got, m = hopper_normalized_crop(dpt, com_t, cube, cam.fx, cam.fy,
                                        fuse_clamp=True, **kw)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        np.testing.assert_array_equal(m.numpy(), m_ref.numpy())
    clamped, _, _ = tcrop.clamp_depth(dpt)
    onehot, _ = tcrop.normalized_crop(clamped, com_t, cube, cam.fx, cam.fy,
                                      method="onehot")
    np.testing.assert_array_equal(onehot.numpy(), ref.numpy())


def test_per_sample_cube_matches_jax(scenes):
    cam = NYU_CAMERA
    raw, com = scenes["nyu"]
    cube = np.array([[250, 250, 250], [300, 280, 260], [900, 900, 900],
                     [180, 220, 200]], np.float32)
    clamped = np.array(jcrop.clamp_depth(raw)[0])
    want, _ = jcrop.normalized_crop(clamped, com, cube, cam.fx, cam.fy)
    got, _ = hopper_normalized_crop(
        torch.from_numpy(raw), torch.from_numpy(com), torch.from_numpy(cube),
        cam.fx, cam.fy, fuse_clamp=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bilinear_raises(scenes):
    """Only an unknown resize method raises now ('cubic': ValueError);
    resize='nearest' overrides the legacy use_bilinear flag, as in the JAX
    package."""
    cam = NYU_CAMERA
    raw, com = scenes["nyu"]
    dpt, com_t = torch.from_numpy(raw), torch.from_numpy(com)
    cube = (250.0, 250.0, 250.0)
    for fn in (tcrop.crop3d, tcrop.normalized_crop):
        with pytest.raises(ValueError, match="cubic"):
            fn(dpt, com_t, cube, cam.fx, cam.fy, resize="cubic")
    got, _ = tcrop.crop3d(dpt, com_t, cube, cam.fx, cam.fy,
                          use_bilinear=True, resize="nearest")
    want, _ = tcrop.crop3d(dpt, com_t, cube, cam.fx, cam.fy)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
@pytest.mark.parametrize("cube_name", ["250", "900"])
@pytest.mark.parametrize("resize", ["linear", "nd_bilinear"])
def test_resize_crop_matches_host_twin_and_jax(scenes, cam_name, cube_name, resize):
    """mm crops: bit-exact against HandCropper(resize_method=resize), the
    JAX gather within rtol 3e-7 / atol 1e-3 mm ('linear') or rtol 1e-5 /
    atol 1e-3 mm ('nd_bilinear'); M equal to the nearest crop's."""
    cam = CAMERAS[cam_name]
    raw, com = scenes[cam_name]
    size = (CUBES[cube_name],) * 3
    clamped = np.array(jcrop.clamp_depth(raw)[0])
    got, m_got = tcrop.crop3d(torch.from_numpy(clamped), torch.from_numpy(com), size,
                              cam.fx, cam.fy, resize=resize)
    for i in range(raw.shape[0]):
        want, m_want, _ = HandCropper(raw[i], cam, resize_method=resize).crop_area_3d(
            com=com[i], size=size)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_allclose(m_got[i].numpy(), m_want, rtol=1e-6)
    want, _ = jcrop.crop3d(clamped, com, np.asarray(size, np.float32), cam.fx, cam.fy,
                           resize=resize)
    rtol = 3e-7 if resize == "linear" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-3)
    _, m_near = tcrop.crop3d(torch.from_numpy(clamped), torch.from_numpy(com), size,
                             cam.fx, cam.fy)
    np.testing.assert_array_equal(m_got.numpy(), m_near.numpy())
    # it interpolates: not the nearest crop
    near, _ = tcrop.crop3d(torch.from_numpy(clamped), torch.from_numpy(com), size,
                           cam.fx, cam.fy)
    assert np.abs(got.numpy() - near.numpy()).max() > 0.5


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
def test_linear_crop_matches_jax_onehot(scenes, cam_name):
    """The JAX two-tap one-hot form sums rows before columns: within rtol
    1e-5, atol 2e-2 mm.  The port's 'onehot' is its own gather."""
    cam = CAMERAS[cam_name]
    raw, com = scenes[cam_name]
    cube = np.full(3, 250.0, np.float32)
    clamped = np.array(jcrop.clamp_depth(raw)[0])
    want, _ = jcrop.crop3d(clamped, com, cube, cam.fx, cam.fy, resize="linear",
                           method="onehot")
    got, _ = tcrop.crop3d(torch.from_numpy(clamped), torch.from_numpy(com), cube,
                          cam.fx, cam.fy, resize="linear", method="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-2)
    gather, _ = tcrop.crop3d(torch.from_numpy(clamped), torch.from_numpy(com), cube,
                             cam.fx, cam.fy, use_bilinear=True)
    np.testing.assert_array_equal(got.numpy(), gather.numpy())


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
@pytest.mark.parametrize("zero_one", [False, True])
def test_linear_crop_matches_pallas_interpret(scenes, cam_name, zero_one):
    """hopper_normalized_crop(use_bilinear=True) (its plain version on the
    CPU, the clamp fused) against the Pallas K2 in interpret mode, on two
    frames: normalized crops within rtol 1e-4, atol 1e-4 (the Pallas
    kernel blends rows before columns)."""
    cam = CAMERAS[cam_name]
    raw, com = scenes[cam_name]
    raw, com = _with_outliers(raw)[:2], com[:2]
    cube = np.full(3, 250.0, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, m_want = pallas_normalized_crop(raw, com, cube, cam.fx, cam.fy,
                                              norm_zero_one=zero_one,
                                              fuse_clamp=True, use_bilinear=True)
    got, m_got = hopper_normalized_crop(torch.from_numpy(raw), torch.from_numpy(com),
                                        cube, cam.fx, cam.fy, norm_zero_one=zero_one,
                                        fuse_clamp=True, use_bilinear=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), rtol=1e-6)
    # the fused clamp is clamp-then-crop, bit for bit
    clamped, _, _ = tcrop.clamp_depth(torch.from_numpy(raw))
    plain, _ = tcrop.normalized_crop(clamped, torch.from_numpy(com), cube, cam.fx, cam.fy,
                                     norm_zero_one=zero_one, resize="linear")
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
