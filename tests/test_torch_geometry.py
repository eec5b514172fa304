"""The port's 2D geometry (deepprior_tpu_torch.geometry) and the camera's
projection on tensors against the JAX package, on the same numpy inputs.

Tensor functions within rtol 1e-6 (cos/sin and the einsum of
transform_points_2d may differ by an ulp between XLA and PyTorch); the
numpy twins, copies of the JAX package's, bit-exact.
"""

import numpy as np
import pytest
import torch

from deepprior_tpu import geometry as jgeo
from deepprior_tpu.camera import ICVL_CAMERA as J_ICVL
from deepprior_tpu.camera import NYU_CAMERA as J_NYU

from deepprior_tpu_torch import geometry as tgeo
from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(17)


def _affines(rng, n=16):
    m = np.zeros((n, 3, 3), np.float32)
    m[:, :2, :] = rng.uniform(-2.0, 2.0, (n, 2, 3))
    m[:, 2, 2] = 1.0
    return m


def test_inv3x3_matches_jax(rng):
    m = _affines(rng)
    m[:4, 2, :2] = rng.uniform(-0.01, 0.01, (4, 2))  # projective rows too
    want = np.asarray(jgeo.inv3x3(m))
    got = tgeo.inv3x3(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # and it inverts
    np.testing.assert_allclose(
        np.einsum("bij,bjk->bik", m.astype(np.float64), got.astype(np.float64)),
        np.broadcast_to(np.eye(3), m.shape), atol=1e-4)


def test_matmul3x3_is_the_product(rng):
    a, b = _affines(rng), _affines(rng)
    got = tgeo.matmul3x3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, a @ b, rtol=1e-6, atol=1e-6)


def test_rotation_matrix_2d_matches_jax(rng):
    center = rng.uniform(0.0, 128.0, (32, 2)).astype(np.float32)
    ang = rng.uniform(-360.0, 360.0, 32).astype(np.float32)
    ang[:4] = (0.0, 90.0, 180.0, -270.0)
    want = np.asarray(jgeo.rotation_matrix_2d(center, ang))
    got = tgeo.rotation_matrix_2d(torch.from_numpy(center), torch.from_numpy(ang)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("depth", [False, True])
def test_rotate_points_2d_matches_jax(rng, depth):
    pts = rng.uniform(0.0, 640.0, (8, 14, 3 if depth else 2)).astype(np.float32)
    center = rng.uniform(100.0, 500.0, (8, 1, 2)).astype(np.float32)
    ang = rng.uniform(-180.0, 180.0, (8, 1)).astype(np.float32)
    want = np.asarray(jgeo.rotate_points_2d(pts, center, ang))
    got = tgeo.rotate_points_2d(torch.from_numpy(pts), torch.from_numpy(center),
                                torch.from_numpy(ang)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_transform_points_2d_matches_jax(rng):
    pts = rng.uniform(0.0, 640.0, (5, 14, 3)).astype(np.float32)
    m = _affines(rng, 1)[0]
    m[2, :2] = (1e-4, -2e-4)
    want = np.asarray(jgeo.transform_points_2d(pts, m))
    got = tgeo.transform_points_2d(torch.from_numpy(pts), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], pts[..., 2])


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
def test_three_d_to_img_matches_jax(rng, cam_name):
    jcam, tcam = {"nyu": (J_NYU, NYU_CAMERA), "icvl": (J_ICVL, ICVL_CAMERA)}[cam_name]
    xyz = rng.uniform(-150.0, 150.0, (64, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(400.0, 900.0, 64)
    xyz[:3, 2] = 0.0  # the z == 0 guard
    want = np.asarray(jcam.three_d_to_img(xyz))
    got = tcam.three_d_to_img(torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[:3, :2], [[tcam.ux, tcam.uy]] * 3)
    # round trip through the port's back-projection
    back = tcam.img_to_3d(torch.from_numpy(got[3:])).numpy()
    np.testing.assert_allclose(back, xyz[3:], rtol=1e-5, atol=1e-3)


def test_numpy_twins_bit_exact(rng):
    pts = rng.uniform(0.0, 640.0, (4, 14, 3)).astype(np.float32)
    m = _affines(rng, 1)[0]
    np.testing.assert_array_equal(tgeo.transform_points_2d_np(pts, m),
                                  jgeo.transform_points_2d_np(pts, m))
    center = rng.uniform(100.0, 500.0, (4, 1, 2))
    ang = rng.uniform(-180.0, 180.0, (4, 1))
    np.testing.assert_array_equal(tgeo.rotate_points_2d_np(pts, center, ang),
                                  jgeo.rotate_points_2d_np(pts, center, ang))
    c3 = rng.uniform(-50.0, 50.0, (4, 1, 3))
    a3 = [rng.uniform(-180.0, 180.0, (4, 1)) for _ in range(3)]
    np.testing.assert_array_equal(tgeo.rotate_points_3d_np(pts, c3, *a3),
                                  jgeo.rotate_points_3d_np(pts, c3, *a3))
