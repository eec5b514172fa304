"""The port's 2D geometry (deepprior_tpu_torch.geometry) and the camera's
projection on tensors against the JAX package, on the same numpy inputs.

Tensor functions within rtol 1e-6 (cos/sin and the einsum of
transform_points_2d may differ by an ulp between XLA and PyTorch); the
numpy twins, copies of the JAX package's, bit-exact.  The 3D rotations are
also held to an independent quaternion oracle (a copy of
tests/test_geometry.py's), and the camera's matrices and point clouds to
the JAX camera's.
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


# ------------------------------------------------------------ 3D geometry
def _quat_from_axis_angle(axis, angle_rad):
    axis = np.asarray(axis, np.float64)
    half = angle_rad / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rotate(q, p):
    """Sandwich p' = q (0,p) q*: no rotation matrix involved."""
    pq = np.concatenate([[0.0], np.asarray(p, np.float64)])
    qc = q * np.array([1.0, -1.0, -1.0, -1.0])
    return _quat_mul(_quat_mul(q, pq), qc)[1:]


def test_euler_rotation_matrix_matches_jax_and_quaternions(rng):
    """'rxyz' (R = Rx Ry Rz): the JAX matrices within rtol 1e-6 / atol 1e-6
    (an ulp of cos/sin), batched angles too; and the quaternion product
    qx qy qz applied by the sandwich within atol 5e-4 mm on points of
    100 mm (the JAX test's bound)."""
    ang = rng.uniform(-180.0, 180.0, (3, 16)).astype(np.float32)
    want = np.asarray(jgeo.euler_rotation_matrix(*ang))
    got = tgeo.euler_rotation_matrix(*map(torch.from_numpy, ang)).numpy()
    assert got.shape == (16, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for _ in range(20):
        ax, ay, az = rng.uniform(-np.pi, np.pi, 3)
        q = _quat_mul(_quat_mul(_quat_from_axis_angle([1, 0, 0], ax),
                                _quat_from_axis_angle([0, 1, 0], ay)),
                      _quat_from_axis_angle([0, 0, 1], az))
        r = tgeo.euler_rotation_matrix(np.rad2deg(ax), np.rad2deg(ay), np.rad2deg(az))
        p = rng.uniform(-100, 100, 3)
        np.testing.assert_allclose(r.numpy().astype(np.float64) @ p, _quat_rotate(q, p),
                                   atol=5e-4)


def test_rotate_points_3d_matches_jax(rng):
    """Batched points, centres and angles as the prior samples them: the
    JAX function within rtol 1e-6 / atol 1e-3 mm; the centre is fixed; the
    float64 numpy twin within 5e-3 mm (the JAX test's twin bound)."""
    pts = rng.uniform(-125, 125, (7, 5, 3)).astype(np.float32)
    center = rng.uniform(-50, 50, (7, 1, 3)).astype(np.float32)
    ang = rng.uniform(-180, 180, (7, 3)).astype(np.float32)
    args = (ang[:, 0:1], ang[:, 1:2], ang[:, 2:3])
    want = np.asarray(jgeo.rotate_points_3d(pts, center, *args))
    got = tgeo.rotate_points_3d(torch.from_numpy(pts), torch.from_numpy(center),
                                *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got, tgeo.rotate_points_3d_np(pts, center, *args),
                               rtol=1e-5, atol=5e-3)
    c = tgeo.rotate_points_3d(torch.from_numpy(center[0]), torch.from_numpy(center[0]),
                              15.0, -30.0, 45.0).numpy()
    np.testing.assert_allclose(c, center[0], atol=1e-4)


def test_transform_points_3d_matches_jax(rng):
    """A 4x4 homogeneous transform with a projective row: the JAX function
    within rtol 1e-6; a translation exactly."""
    pts = rng.uniform(-150.0, 150.0, (6, 14, 3)).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :] = rng.uniform(-2.0, 2.0, (3, 4))
    m[3, :3] = rng.uniform(-1e-4, 1e-4, 3)
    want = np.asarray(jgeo.transform_points_3d(pts, m))
    got = tgeo.transform_points_3d(torch.from_numpy(pts), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    t = np.eye(4)
    t[:3, 3] = [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(
        tgeo.transform_points_3d(torch.zeros(1, 3), torch.from_numpy(t).float()).numpy(),
        [[1.0, 2.0, 3.0]])


def test_affine_2d_matches_jax(rng):
    """The tracking overlay's affine: the JAX 6-vector within rtol 1e-6."""
    for _ in range(8):
        center = tuple(rng.uniform(0, 320, 2).astype(np.float32))
        trans = tuple(rng.uniform(-20, 20, 2).astype(np.float32))
        rot, scale = rng.uniform(-np.pi, np.pi), rng.uniform(0.5, 2.0)
        want = np.asarray(jgeo.affine_2d(center, rot, trans, scale))
        got = tgeo.affine_2d(center, rot, trans, scale).numpy()
        assert got.shape == (6,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# ------------------------------------------------------------ the camera
@pytest.mark.parametrize("cam_name", ["nyu", "icvl", "msra15"])
def test_camera_matrices_and_aliases_match_jax(rng, cam_name):
    from deepprior_tpu.camera import CAMERAS as J_CAMERAS
    from deepprior_tpu_torch.camera import CAMERAS

    jcam, tcam = J_CAMERAS[cam_name], CAMERAS[cam_name]
    np.testing.assert_array_equal(tcam.intrinsics().numpy(), np.asarray(jcam.intrinsics()))
    np.testing.assert_array_equal(tcam.projection().numpy(), np.asarray(jcam.projection()))
    uvd = rng.uniform(0.0, 300.0, (10, 3)).astype(np.float32)
    assert torch.equal(tcam.to_3d(torch.from_numpy(uvd)), tcam.img_to_3d(torch.from_numpy(uvd)))
    xyz = tcam.to_3d(torch.from_numpy(uvd))
    assert torch.equal(tcam.to_img(xyz), tcam.three_d_to_img(xyz))


@pytest.mark.parametrize("crop", [False, True])
def test_depth_to_pcl_matches_jax(rng, crop):
    """A synthetic frame's point cloud, and a crop's through M^-1 (the
    importer's depthToPCL): the JAX camera's host function bit for bit."""
    from deepprior_tpu_torch.data.synthetic import make_depth_frame

    dpt, com = make_depth_frame(NYU_CAMERA, rng)[:2]
    dpt[dpt > com[2] + 150.0] = 0.0  # the background, as a crop leaves it
    m = None
    if crop:
        u0, v0 = int(com[0]) - 64, int(com[1]) - 64
        dpt = dpt[v0:v0 + 128, u0:u0 + 128].copy()
        m = np.array([[1.0, 0.0, -u0], [0.0, 1.0, -v0], [0.0, 0.0, 1.0]], np.float32)
    want = J_NYU.depth_to_pcl(dpt, m)
    got = NYU_CAMERA.depth_to_pcl(dpt, m)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    if crop:  # the importer's depthToPCL, the crop's T as the transform
        from deepprior_tpu.data.importers import NYUImporter as JNYUImporter

        from deepprior_tpu_torch.data.importers import NYUImporter

        np.testing.assert_array_equal(NYUImporter(".", device="cpu").depthToPCL(dpt, m),
                                      JNYUImporter(".").depthToPCL(dpt, m))
