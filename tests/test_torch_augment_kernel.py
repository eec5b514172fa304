"""The fused augmentation warp K5 (csrc/warp.cu, ops/hopper_warp.py) on the
CPU: what can be checked without the card.

  (a) K5's plain route, ``augment_batch(use_pallas=True, fuse_norm=True)``
      on a CPU tensor (augment_geometry + warp_norm_plain), against the
      JAX package's fused path (``augment_batch`` with the Pallas
      ``pallas_warp_norm`` in interpret mode) on the same draws, at 32x32
      and 64x64, for every mode set and both normalizations: crops within
      the f32 ulps tests/test_pallas_warp.py allows the JAX package's own
      fused path (atol 1e-5) but for max(1e-4 of the pixels, 2) pixels,
      where cos/sin or the 3x3 compose may differ by an ulp and flip a
      half-integer source coordinate (test_torch_augment.py's bound);
      labels within 1e-4, com, cube and M within rtol 1e-6;
  (b) the per-sample fields K5 writes for the labels (new_com, new_cube,
      m_out, com3d, new_com3d_c, rot, the mode masks) are
      augment_geometry's, and ``warp_norm_args`` builds the launch's
      tensors (mode masks, the cube's stride, dtypes, the outputs);
  (c) ``fuse_norm=None``: K5 on the kernel path of every device, its
      plain version on the CPU, where no launcher is reached;
  (d) ``build()`` binds the C signatures of csrc/warp.cu as written there.
The kernel itself runs only on a CUDA card: chip_smoke.py phase 7 holds it
to augment_geometry + warp_norm_plain bit for bit.
"""

import ctypes
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.camera import NYU_CAMERA as J_NYU
from deepprior_tpu.ops import augment as jaug
from deepprior_tpu.ops.crop import crop_transform as j_crop_transform

from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.ops import _build
from deepprior_tpu_torch.ops import augment as taug
from deepprior_tpu_torch.ops import hopper_warp as hw

B = 6
MODES = {
    "all": ("com", "rot", "sc", "none"),
    "com": ("com",),
    "rot": ("rot",),
    "sc": ("sc",),
    "none": ("none",),
}


def _batch(size, seed):
    """B normalized (size, size) crops with their CoMs, cubes, crop
    transforms onto the patch and CoM-centred labels."""
    rng = np.random.default_rng(seed)
    com = np.stack([rng.uniform(200, 440, B), rng.uniform(150, 330, B),
                    rng.uniform(600, 900, B)], 1).astype(np.float32)
    cube = np.tile(np.float32([250.0, 250.0, 250.0]), (B, 1))
    cube[1::2] = 300.0
    m = np.asarray(j_crop_transform(com, cube, J_NYU.fx, J_NYU.fy,
                                    (J_NYU.height, J_NYU.width), (size, size)))
    crops = rng.uniform(-1.0, 1.0, (B, size, size)).astype(np.float32)
    crops[rng.uniform(size=crops.shape) < 0.25] = 1.0  # background
    gt3d = rng.uniform(-80.0, 80.0, (B, 14, 3)).astype(np.float32)
    return crops, gt3d, com, cube, m


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("modes", list(MODES))
@pytest.mark.parametrize("zero_one", [False, True])
def test_plain_k5_route_matches_jax_fused(size, modes, zero_one):
    """(a)"""
    crops, gt3d, com, cube, m = _batch(size, 40 + size)
    aug_modes = MODES[modes]
    key = jax.random.key(size + 2 * zero_one)
    params = [np.array(a) for a in jaug.sample_augment_params(key, B, len(aug_modes))]
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jaug.augment_batch(
            key, crops, gt3d, com, cube, m, J_NYU, aug_modes=aug_modes,
            norm_zero_one=zero_one, use_pallas=True, fuse_norm=True)]
    got = [t.numpy() for t in taug.augment_batch(
        None, torch.from_numpy(crops), gt3d, com, cube, m, NYU_CAMERA,
        aug_modes=aug_modes, norm_zero_one=zero_one, use_pallas=True,
        fuse_norm=True, params=params)]
    bad = int(np.sum(np.abs(got[0] - want[0]) > 1e-5))
    bound = max(1e-4 * got[0].size, 2)
    print(f"{size}x{size} {modes} zero_one={zero_one}: {bad} of {got[0].size} "
          f"pixels beyond 1e-5, {int(np.sum(got[0] != want[0]))} not bit-equal")
    assert bad <= bound, bad
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    for name, g, w in zip(("com", "cube", "m"), got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("zero_one", [False, True])
def test_plain_k5_route_writes_augment_geometry(zero_one):
    """(b) the fields the kernel writes, on K5's plain route: the crops are
    K4's unfused pipeline's bit for bit, and com', cube', M' are
    augment_geometry's from the same draws."""
    crops, gt3d, com, cube, m = _batch(64, 7)
    params = taug.sample_augment_params(torch.Generator().manual_seed(5), B, 4,
                                        sigma_sc=0.1)
    kw = dict(aug_modes=MODES["all"], norm_zero_one=zero_one, params=params)
    k5 = taug.augment_batch(None, torch.from_numpy(crops), gt3d, com, cube, m,
                            NYU_CAMERA, use_pallas=True, fuse_norm=True, **kw)
    k4 = taug.augment_batch(None, torch.from_numpy(crops), gt3d, com, cube, m,
                            NYU_CAMERA, use_pallas=True, fuse_norm=False, **kw)
    for a, b in zip(k5, k4):
        assert torch.equal(a, b)
    geo = taug.augment_geometry(params, com, cube, m, NYU_CAMERA, MODES["all"],
                                (64, 64), zero_one)
    for got, want in zip(k5[2:], (geo.new_com, geo.new_cube, geo.m_out)):
        assert torch.equal(got, want)


def test_warp_norm_args_builds_the_launch():
    """(b) the launch's tensors: int64 modes, float32 contiguous draws, the
    mode masks (bit i: slot i of aug_modes), one cube at stride 0, and the
    outputs the kernel writes, shaped as augment_geometry's fields."""
    crops, gt3d, com, cube, m = _batch(32, 3)
    patch = torch.from_numpy(crops)
    mode_idx = np.arange(B, dtype=np.int32) % 3
    off, rot, sc = (np.zeros((B, 3), np.float32), np.zeros(B, np.float32),
                    np.ones(B, np.float32))
    args = hw.warp_norm_args(patch, (mode_idx, off, rot, sc), com, cube[0], m,
                             ICVL_CAMERA, ("com", "com", "rot"), True)
    assert args.mode_idx.dtype == torch.int64 and args.mode_idx.tolist() == mode_idx.tolist()
    assert args.masks == (0b000, 0b011, 0b100, 0b000)  # none, com, rot, sc
    assert args.cube_stride == 0 and args.cube.shape == (3,)
    assert args.camera is ICVL_CAMERA and args.norm_zero_one is True
    for t in (args.off, args.rot, args.sc, args.com, args.m):
        assert t.dtype == torch.float32 and t.is_contiguous()
    # a (B, 3) cube with one row repeated is read at stride 0 too; distinct
    # rows at stride 3
    same = hw.warp_norm_args(patch, (mode_idx, off, rot, sc), com,
                             torch.from_numpy(cube[0]).expand(B, 3), m, NYU_CAMERA,
                             MODES["all"])
    assert same.cube_stride == 0 and same.masks == (0b1000, 0b0001, 0b0010, 0b0100)
    per = hw.warp_norm_args(patch, (mode_idx, off, rot, sc), com, cube, m, NYU_CAMERA,
                            MODES["all"])
    assert per.cube_stride == 3 and per.cube.shape == (B, 3)
    geo = taug.augment_geometry((mode_idx, off, rot, sc), com, cube, m, NYU_CAMERA,
                                MODES["all"], (32, 32))
    o = per.outs
    assert o.out.shape == patch.shape and o.out.dtype == torch.float32
    for name in ("new_com", "new_cube", "m_out", "com3d", "new_com3d_c", "rot"):
        assert getattr(o, name).shape == getattr(geo, name).shape, name
    assert o.is_mode.shape == (B, len(hw.MODES)) and o.is_mode.dtype == torch.bool
    assert taug.VALID_MODES == hw.MODES
    with pytest.raises(ValueError, match="mode"):
        hw.warp_norm_args(patch, (mode_idx, off, rot, sc), com, cube, m, NYU_CAMERA,
                          ("flip",))
    with pytest.raises(ValueError, match="off"):
        hw.warp_norm_args(patch, (mode_idx, off[:2], rot, sc), com, cube, m, NYU_CAMERA,
                          MODES["all"])
    with pytest.raises(ValueError, match="CUDA"):
        hw.launch_warp_norm(patch, per)


def test_fuse_norm_none_dispatch(monkeypatch):
    """(c) the route of every knob setting, and no launcher reached on the
    CPU: fuse_norm=None is K5 on the card and K5's plain version on the
    CPU, bit-equal to K4's."""
    assert taug.warp_route("cuda") == "k5"
    assert taug.warp_route("cuda", fuse_norm=True) == "k5"
    assert taug.warp_route("cuda", fuse_norm=False) == "k4"
    assert taug.warp_route("cuda", use_pallas=False) == "gather"
    assert taug.warp_route("cuda", resize="linear") == "gather"
    assert taug.warp_route("cpu") == "gather"
    assert taug.warp_route("cpu", use_pallas=True) == "k5"
    assert taug.warp_route("cpu", use_pallas=True, fuse_norm=True) == "k5"
    assert taug.warp_route("cpu", use_pallas=True, fuse_norm=False) == "k4"
    calls = []

    def launcher(name):
        def launch(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"{name} reached on the CPU")
        return launch

    monkeypatch.setattr(hw, "launch_warp_norm", launcher("launch_warp_norm"))
    monkeypatch.setattr(hw, "launch_warp", launcher("launch_warp"))
    crops, gt3d, com, cube, m = _batch(32, 4)
    params = taug.sample_augment_params(torch.Generator().manual_seed(1), B, 3)
    outs = [taug.augment_batch(None, torch.from_numpy(crops), gt3d, com, cube, m,
                               NYU_CAMERA, params=params, **kw)
            for kw in (dict(), dict(use_pallas=True), dict(use_pallas=True, fuse_norm=False))]
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(outs[1], outs[2]))
    assert int((outs[0][0] != outs[1][0]).sum()) <= max(1e-4 * crops.size, 2)


_CTYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const int64_t*": ctypes.c_void_p, "bool*": ctypes.c_void_p,
           "void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _c_signature(name):
    """The ctypes of the C function ``name``'s parameters in csrc/warp.cu."""
    with open(os.path.join(_build.CSRC, "warp.cu")) as f:
        src = f.read()
    params = re.search(rf"\bint {name}\(([^)]*)\)", src).group(1)
    return [_CTYPES[re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")]
            for p in params.split(",")]


class _StubLib:
    """What ``_build.load_library`` returns without nvcc: each C function a
    recorder that answers with ``answers[name]`` (default 0)."""

    def __init__(self, **answers):
        self._answers = answers

    def __getattr__(self, name):
        answer = self._answers.get(name, lambda *a: 0)

        class Fn:
            argtypes = restype = None

            def __call__(self, *args):
                return answer(*args)

        fn = Fn()
        setattr(self, name, fn)
        return fn


def test_warp_build_binds_the_c_signatures(monkeypatch):
    """(d) every pointer and the stream as c_void_p, the floats as
    c_float, in the order csrc/warp.cu declares them; build() refuses a
    source whose layout constants differ from the wrapper's."""
    consts = {0: len(hw.PATCH_PARAMS), 1: len(hw.MODES)}
    stub = _StubLib(dp_warp_constant=lambda i: consts[i])
    monkeypatch.setattr(_build, "load_library", lambda source: stub)
    hw.build.cache_clear()
    try:
        lib = hw.build()
        for name in ("dp_warp_patch", "dp_warp_norm"):
            assert list(getattr(lib, name).argtypes) == _c_signature(name), name
            assert getattr(lib, name).restype is ctypes.c_int
        assert len(lib.dp_warp_norm.argtypes) == 37
        hw.build.cache_clear()
        bad = _StubLib(dp_warp_constant=lambda i: consts[i] + i)
        monkeypatch.setattr(_build, "load_library", lambda source: bad)
        with pytest.raises(RuntimeError, match="modes"):
            hw.build()
    finally:
        hw.build.cache_clear()


def test_build_key_covers_the_shared_headers(tmp_path):
    """A build is keyed on its source, every csrc/*.cuh it may include and
    the flags: editing geometry.cuh rebuilds crop.cu and warp.cu, and
    editing one source leaves the other's key alone."""
    for name in ("warp.cu", "crop.cu", "geometry.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            (tmp_path / name).write_text(f.read())
    assert '#include "geometry.cuh"' in (tmp_path / "warp.cu").read_text()
    assert '#include "geometry.cuh"' in (tmp_path / "crop.cu").read_text()
    assert _build.source_digest("warp.cu") == _build.source_digest("warp.cu", str(tmp_path))
    before = {s: _build.source_digest(s, str(tmp_path)) for s in ("warp.cu", "crop.cu")}
    (tmp_path / "geometry.cuh").write_text((tmp_path / "geometry.cuh").read_text() + "\n")
    after = {s: _build.source_digest(s, str(tmp_path)) for s in ("warp.cu", "crop.cu")}
    assert all(before[s] != after[s] for s in before)
    (tmp_path / "warp.cu").write_text((tmp_path / "warp.cu").read_text() + "\n")
    assert _build.source_digest("crop.cu", str(tmp_path)) == after["crop.cu"]
    assert _build.source_digest("warp.cu", str(tmp_path)) != after["warp.cu"]
