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

The kernel computes the geometry itself; its plain prologue
``hopper_crop.crop_params`` is held column by column to the JAX geometry
bit for bit, and the kernel's argument preparation (``crop_args``) and
ctypes binding (``build`` with a stub library) are checked here, since the
kernel runs only on a card (chip_smoke.py holds it to the plain crop).
"""

import ctypes

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu.data.detector_np import HandCropper
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.ops import crop as jcrop
from deepprior_tpu.ops.pallas_crop import pallas_normalized_crop

from deepprior_tpu_torch.ops import _build, hopper_crop
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


def _geometry_scene(cam, seed, n=12):
    """n raw frames for the geometry: sample 0 has com_z = 0 (the centred
    fallback); samples 1-4 a CoM within 20 px of the left, right, top and
    bottom border; per-sample non-square cubes, wide and tall in turns,
    so both branches of _embed_geometry run."""
    rng = np.random.default_rng(seed)
    frames = [make_frame(cam, rng) for _ in range(n)]
    raw = np.stack([f.extraData["dpt_full"] for f in frames])
    com = np.stack([f.com for f in frames]).astype(np.float32)
    com[0, 2] = 0.0
    edge = rng.uniform(0.0, 20.0, 4).astype(np.float32)
    com[1, 0], com[2, 0] = edge[0], cam.width - 1 - edge[1]
    com[3, 1], com[4, 1] = edge[2], cam.height - 1 - edge[3]
    cube = rng.uniform(150.0, 450.0, (n, 3)).astype(np.float32)
    wide = np.arange(n) % 2 == 0
    cube[wide, 0] = cube[wide, 1] * 1.3
    cube[~wide, 1] = cube[~wide, 0] * 1.3
    return raw, com, cube


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
def test_crop_params_matches_jax_geometry(cam_name):
    """The plain prologue, column by column, against the JAX package's
    com_to_bounds, _embed_geometry and depth_limits, and its M against
    crop_transform: bit for bit."""
    cam = CAMERAS[cam_name]
    raw, com, cube = _geometry_scene(cam, 21 if cam_name == "nyu" else 22)
    hw = (cam.height, cam.width)
    params, m = hopper_crop.crop_params(torch.from_numpy(raw), torch.from_numpy(com),
                                        torch.from_numpy(cube), cam.fx, cam.fy,
                                        fuse_clamp=True)
    xs, xe, ys, ye, zs, ze = jcrop.com_to_bounds(com, cube, cam.fx, cam.fy, hw)
    _, off_x, off_y, sz_w, sz_h = jcrop._embed_geometry(xs, xe, ys, ye, (128, 128))
    min_d, max_d = jcrop.depth_limits(raw)
    want = dict(xstart=xs, ystart=ys, wb=xe - xs, hb=ye - ys, off_x=off_x, off_y=off_y,
                zstart=zs, zend=ze, com_z=com[:, 2], cube_half=cube[:, 2] / np.float32(2),
                sz_w=sz_w, sz_h=sz_h, min_d=min_d, max_d=max_d)
    assert params.shape == (len(com), len(hopper_crop.PARAM_NAMES))
    for i, name in enumerate(hopper_crop.PARAM_NAMES):
        np.testing.assert_array_equal(params[:, i].numpy(),
                                      np.asarray(want[name], np.float32), err_msg=name)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jcrop.crop_transform(com, cube, cam.fx, cam.fy, hw)))
    # the scene reaches what it is meant to: the fallback, both branches,
    # and bounding boxes that leave the frame
    col = {n: params[:, i].numpy() for i, n in enumerate(hopper_crop.PARAM_NAMES)}
    assert (col["xstart"][0], col["zstart"][0]) == (cam.width // 4, 10.0)
    wide = col["wb"] > col["hb"]
    assert wide.any() and (~wide).any()
    assert col["xstart"][1] < 0 and col["xstart"][2] + col["wb"][2] > cam.width
    assert col["ystart"][3] < 0 and col["ystart"][4] + col["hb"][4] > cam.height


def test_crop_args_make_the_kernel_tensors(scenes):
    """The launch's tensors: contiguous float32 com (B, 3); a (3,) cube, or
    one expanded to (B, 3), read at stride 0 without a copy; a per-sample
    cube as contiguous (B, 3); fx/fy as Python floats; the (B,) clamp
    limits only with the fused clamp; the (B, dh, dw) and (B, 3, 3)
    outputs."""
    cam = NYU_CAMERA
    raw, com = scenes["nyu"]
    dpt = torch.from_numpy(raw)
    b = dpt.shape[0]
    # a strided float64 CoM: the args copy it to contiguous float32
    com64 = torch.from_numpy(np.repeat(com, 2, axis=1).astype(np.float64))[:, ::2]
    assert not com64.is_contiguous()
    one = torch.tensor([250.0, 260.0, 270.0])
    per = torch.from_numpy(np.random.default_rng(3).uniform(150, 450, (b, 3)).astype(np.float32))
    for cube, stride in (((250.0,) * 3, 0), (one, 0), (one.expand(b, 3), 0),
                         (one[None], 0), (per, 3)):
        for fuse in (False, True):
            a = hopper_crop.crop_args(dpt, com64, cube, cam.fx, cam.fy, (96, 72), fuse)
            assert a.com.shape == (b, 3) and a.com.dtype == torch.float32
            assert a.com.is_contiguous()
            np.testing.assert_array_equal(a.com.numpy(), com)
            assert a.cube_stride == stride and a.cube.is_contiguous()
            assert a.cube.dtype == torch.float32
            assert a.cube.shape == ((3,) if stride == 0 else (b, 3))
            assert type(a.fx) is float and type(a.fy) is float
            assert (a.fx, a.fy) == (cam.fx, cam.fy)
            assert a.out.shape == (b, 72, 96) and a.m.shape == (b, 3, 3)
            for t in (a.out, a.m):
                assert t.dtype == torch.float32 and t.is_contiguous()
            if fuse:
                want = tcrop.depth_limits(dpt)
                for got, w in zip((a.min_d, a.max_d), want):
                    assert got.shape == (b,) and got.is_contiguous()
                    assert torch.equal(got, w)
            else:
                assert a.min_d is None and a.max_d is None
    # an expanded cube is read in place: no copy
    a = hopper_crop.crop_args(dpt, com, one.expand(b, 3), cam.fx, cam.fy)
    assert a.cube.data_ptr() == one.data_ptr()
    with pytest.raises(ValueError, match="cube"):
        hopper_crop.crop_args(dpt, com, torch.ones(b, 2), cam.fx, cam.fy)
    with pytest.raises(ValueError, match="com"):
        hopper_crop.crop_args(dpt, com[:, :2], one, cam.fx, cam.fy)


class _StubFn:
    """A C function of a stub library: takes argtypes/restype, returns
    ``ret(*args)``."""

    def __init__(self, ret):
        self.ret, self.argtypes, self.restype = ret, None, None

    def __call__(self, *args):
        return self.ret(*args)


class _StubLib:
    """What ``_build.load_library`` returns, without nvcc: each C function
    answers with ``answers[name]`` (default 0)."""

    def __init__(self, **answers):
        self._answers = answers

    def __getattr__(self, name):
        ret = self._answers.get(name, lambda *a: 0)
        fn = _StubFn(ret)
        setattr(self, name, fn)
        return fn


def test_crop_build_binds_float_focal_lengths(monkeypatch):
    """build() declares fx and fy as c_float (ctypes would pass a bare
    Python float as a double) and every pointer and the stream as
    c_void_p (as c_int they would be cut to 32 bits)."""
    stub = _StubLib()
    monkeypatch.setattr(_build, "load_library", lambda source: stub)
    hopper_crop.build.cache_clear()
    try:
        lib = hopper_crop.build()
    finally:
        hopper_crop.build.cache_clear()
    assert lib is stub
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    names = ("dpt com cube cube_stride fx fy min_d max_d out m b h w dh dw "
             "fuse_clamp norm_zero_one linear stream").split()
    want = dict(zip(names, [ptr] * 3 + [i32] + [f32] * 2 + [ptr] * 4 + [i32] * 8 + [ptr]))
    assert dict(zip(names, lib.dp_normalized_crop.argtypes)) == want
    assert len(lib.dp_normalized_crop.argtypes) == len(names)
    assert lib.dp_normalized_crop.restype is i32
    assert lib.dp_error_string.argtypes == [i32]
    assert lib.dp_error_string.restype is ctypes.c_char_p
    # the focal lengths of both cameras survive the float32 argument
    for cam in CAMERAS.values():
        assert ctypes.c_float(cam.fx).value == np.float32(cam.fx)
