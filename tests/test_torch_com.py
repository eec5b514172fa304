"""The port's CoM localization (deepprior_tpu_torch.ops.com) against the
JAX package (deepprior_tpu/ops/com.py) and the numpy host twin, on the
same seeded synthetic frames.

label_components is exact.  CoMs agree with JAX within rtol 1e-4, atol
1e-2 (px or mm): the masked sums of pixel coordinates can pass 2^24 and
the float32 sums then depend on the reduction order, which differs
between XLA and PyTorch.  Against the host twin (float64 means of scipy's
components) the bound is the JAX package's own, rtol 1e-3, atol 0.5
(tests/test_com.py).
"""

import numpy as np
import pytest
import torch

from deepprior_tpu.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu.data.detector_np import HandCropper
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.ops import com as jcom
from deepprior_tpu.ops import crop as jcrop

from deepprior_tpu_torch.ops import com as tcom

CUBE = np.full(3, 250.0, np.float32)
TOL = dict(rtol=1e-4, atol=1e-2)


def _frames(cam, seed, n=3, specks=True):
    """n raw frames; with specks, frame 0 gets a single pixel and frame 1
    a 5x5 patch nearer than the hand, both under the 200 px area gate."""
    rng = np.random.default_rng(seed)
    raw = np.stack([make_frame(cam, rng).extraData["dpt_full"] for _ in range(n)])
    com = np.stack([make_frame(cam, rng).com for _ in range(n)])
    if specks:
        for i, (sl, dz) in enumerate([((20, 30), 120.0),
                                      ((slice(100, 105), slice(40, 45)), 80.0)]):
            raw[i][sl] = raw[i][raw[i] > 0].min() - dz
    return raw, com.astype(np.float32)


@pytest.fixture(scope="module")
def icvl():
    return _frames(ICVL_CAMERA, 21)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_label_components_exact():
    rng = np.random.default_rng(0)
    masks = [rng.uniform(size=(24, 31)) < p for p in (0.3, 0.55, 0.7)]
    hand = np.zeros((16, 24), bool)
    hand[2:5, 3:7] = hand[10:14, 10:18] = hand[5:10, 5] = True
    hand[0, 20] = True
    masks.append(np.pad(hand, ((4, 4), (3, 4))))
    for mask in masks:
        want = np.asarray(jcom.label_components(mask))
        np.testing.assert_array_equal(tcom.label_components(_t(mask)).numpy(), want)
    # batched, with a region that splits components
    stack = np.stack(masks)
    region = rng.integers(0, 3, stack.shape).astype(np.int32)
    got = tcom.label_components(_t(stack), _t(region)).numpy()
    for i in range(len(masks)):
        want = np.asarray(jcom.label_components(stack[i], region[i]))
        np.testing.assert_array_equal(got[i], want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("axis", [-1, -2])
def test_seg_min_scan_exact(axis):
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=(2, 9, 13)) < 0.6
    lab = np.where(mask, rng.integers(0, 9 * 13, mask.shape), 9 * 13).astype(np.int32)
    region = rng.integers(0, 2, mask.shape).astype(np.int32)
    for i in range(2):
        want = np.asarray(jcom._seg_min_scan(lab[i], mask[i], axis, region[i]))
        got = tcom._seg_min_scan(_t(lab[i]), _t(mask[i]), axis, _t(region[i]))
        np.testing.assert_array_equal(got.numpy(), want)


def test_calculate_com_and_check_image(icvl):
    raw, _ = icvl
    dc, dmin, dmax = jcrop.clamp_depth(raw)
    want = np.asarray(jcom.calculate_com(dc, dmin, dmax))
    got = tcom.calculate_com(_t(dc), _t(dmin), _t(dmax)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(tcom.calculate_com(torch.zeros(32, 32)).numpy(), 0.0)
    flat = np.full((2, 16, 16), 500.0, np.float32)
    flat[1, :8] = 600.0
    np.testing.assert_array_equal(tcom.check_image(_t(flat)).numpy(),
                                  np.asarray(jcom.check_image(flat)))


def test_refine_com_iterative_matches_jax(icvl):
    raw, com = icvl
    dc, dmin, dmax = jcrop.clamp_depth(raw)
    seed = com + np.array([12.0, -9.0, 30.0], np.float32)
    seed[2, 2] = 0.0  # the centred-crop fallback of com_to_bounds
    for kw in (dict(), dict(min_depth=dmin, max_depth=dmax)):
        want = np.asarray(jcom.refine_com_iterative(dc, seed, CUBE, ICVL_CAMERA.fx,
                                                    ICVL_CAMERA.fy, num_iter=3, **kw))
        got = tcom.refine_com_iterative(
            _t(dc), _t(seed), CUBE, ICVL_CAMERA.fx, ICVL_CAMERA.fy, num_iter=3,
            **{k: _t(v) for k, v in kw.items()}).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    # one frame against the host twin
    hc = HandCropper(raw[1], ICVL_CAMERA)
    want = hc.refine_com_iterative(seed[1], 3, tuple(CUBE))
    got = tcom.refine_com_iterative(_t(hc.dpt), _t(seed[1]), CUBE, ICVL_CAMERA.fx,
                                    ICVL_CAMERA.fy, num_iter=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.5)


def test_empty_crop_fallbacks():
    """An empty crop falls back to the thresholded centre depth, or to
    empty_z = 300 mm when that is 0 (the docom path)."""
    dpt = np.zeros((2, 64, 64), np.float32)
    dpt[1, 32, 32] = 450.0
    com = np.array([[32.0, 32.0, 500.0], [32.0, 32.0, 500.0]], np.float32)
    cube = (100.0, 100.0, 100.0)
    for empty_z in (None, 300.0):
        want = np.asarray(jcom.refine_com_iterative(dpt, com, cube, 500.0, 500.0,
                                                    num_iter=1, empty_z=empty_z))
        got = tcom.refine_com_iterative(_t(dpt), _t(com), cube, 500.0, 500.0,
                                        num_iter=1, empty_z=empty_z).numpy()
        np.testing.assert_array_equal(got, want)
    assert got[0, 2] == 300.0


def test_detect_closest_matches_jax(icvl):
    raw, _ = icvl
    dc, dmin, dmax = jcrop.clamp_depth(raw)
    want = np.asarray(jcom.detect_closest(dc, CUBE, ICVL_CAMERA.fx, ICVL_CAMERA.fy,
                                          min_depth=dmin, max_depth=dmax))
    got = tcom.detect_closest(_t(dc), CUBE, ICVL_CAMERA.fx, ICVL_CAMERA.fy,
                              min_depth=_t(dmin), max_depth=_t(dmax)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_first_index_on_ties():
    """argmin/argmax take the first index on a tie, as JAX does: a frame
    of equal depths seeds detect_closest at pixel 0."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 0.0, 5.0]])
    assert tcom._first_argmin(x).tolist() == [1, 2]
    assert tcom._first_argmax(x).tolist() == [0, 0]
    flat = np.full((1, 40, 50), 600.0, np.float32)
    want = np.asarray(jcom.detect_closest(flat, CUBE, 200.0, 200.0, num_iter=0))
    got = tcom.detect_closest(_t(flat), CUBE, 200.0, 200.0, num_iter=0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [0.0, 0.0, 600.0])


@pytest.mark.parametrize("cam_name", ["icvl", "nyu"])
def test_detect_matches_jax_and_host(icvl, cam_name):
    """The slice scan's area gate rejects the specks nearer than the hand;
    the CoMs agree with JAX and with the host twin."""
    cam = {"icvl": ICVL_CAMERA, "nyu": NYU_CAMERA}[cam_name]
    raw = icvl[0] if cam_name == "icvl" else _frames(NYU_CAMERA, 22, n=2)[0]
    want = np.asarray(jcom.detect(raw, CUBE, cam.fx, cam.fy))
    got = tcom.detect(_t(raw), CUBE, cam.fx, cam.fy).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    for i in range(raw.shape[0]):
        host = HandCropper(raw[i], cam).detect(tuple(CUBE))
        np.testing.assert_allclose(got[i], host, rtol=1e-3, atol=0.5)
    # one frame without the batch axis
    np.testing.assert_allclose(tcom.detect(_t(raw[0]), CUBE, cam.fx, cam.fy).numpy(),
                               got[0], rtol=1e-6)
    if cam_name == "icvl":
        # the speck would have fooled the closest-pixel seed (at NYU's focal
        # length the cube around it reaches the hand and refines onto it)
        dc, dmin, dmax = tcom.clamp_depth(_t(raw))
        close = tcom.detect_closest(dc, CUBE, cam.fx, cam.fy, min_depth=dmin,
                                    max_depth=dmax).numpy()
        assert np.linalg.norm(close[0, :2] - got[0, :2]) > 5.0


def test_make_frame_docom_matches_jax():
    """make_frame(docom=True) recentres the CoM inside the cube through the
    numpy HandCropper, as the JAX package's does: the same frame from the
    same rng state."""
    from deepprior_tpu_torch.camera import ICVL_CAMERA as T_ICVL
    from deepprior_tpu_torch.data.synthetic import make_frame as t_make_frame

    for seed in (0, 1):
        want = make_frame(ICVL_CAMERA, np.random.default_rng(seed), docom=True)
        got = t_make_frame(T_ICVL, np.random.default_rng(seed), docom=True)
        for field in ("dpt", "com", "T", "gtorig", "gt3Dorig", "gt3Dcrop", "gtcrop"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=field)
        plain = t_make_frame(T_ICVL, np.random.default_rng(seed))
        assert np.abs(got.com - plain.com).max() > 0.0  # the CoM moved


def test_detect_empty_scene():
    out = tcom.detect(torch.zeros((2, 64, 64)), CUBE, 500.0, 500.0).numpy()
    np.testing.assert_array_equal(out, 0.0)
