"""The augmentation warps of the port against the JAX package.

  (a) ops/crop.py::warp_patch, the gather warp, against the JAX
      warp_patch: nearest bit-exact, 'linear' within 1e-4 mm;
  (b) the plain version of K4 (ops/hopper_warp.py) against the Pallas
      pallas_warp_patch in interpret mode.  Neither divides by the
      projective sz and both round floor(x + 0.5), but XLA may fuse the
      coordinate's multiply-adds into FMAs, which can flip a coordinate
      that lands on a half-integer: at most max(1e-4 of the pixels, 2)
      pixels may differ, the bound tests/test_pallas_warp.py allows the
      JAX package itself; the identity is bit-exact;
  (c) the plain K5 against pallas_warp_norm in interpret mode, atol 1e-5;
  (d) the plain K5 against the port's unfused pipeline, bit-exact.
Patches are 32x32 and 64x64: the Pallas general warp in interpret mode
is slow at 128x128.  The kernels themselves run only on a CUDA card
(chip_smoke.py holds them bit for bit against these plain versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.geometry import rotation_matrix_2d as j_rotation
from deepprior_tpu.ops.crop import warp_patch as j_warp_patch
from deepprior_tpu.ops.pallas_warp import pallas_warp_norm, pallas_warp_patch

from deepprior_tpu_torch.ops import hopper_warp as hw
from deepprior_tpu_torch.ops.augment import NV_VAL
from deepprior_tpu_torch.ops.crop import warp_patch

SIZES = [32, 64]


def _patches(b, hw_, seed, nv_frac=0.02):
    """Depth patches in mm with a few NYU invalid markers (32000)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(400.0, 900.0, (b, hw_, hw_)).astype(np.float32)
    p[rng.uniform(size=p.shape) < nv_frac] = NV_VAL
    p[rng.uniform(size=p.shape) < 0.2] = 0.0  # background
    return p


def _transforms(hw_, seed):
    """A mixed batch of forward transforms: identity, separable scale +
    translate (the com/sc recrops), rotations (incl. 90 and 180 deg),
    one far out of frame and one projective."""
    rng = np.random.default_rng(seed)
    c = np.array([hw_ / 2, hw_ / 2], np.float32)
    ms = [np.eye(3, dtype=np.float32)]
    for _ in range(3):
        s = rng.uniform(0.9, 1.1)
        ms.append(np.array([[s, 0, rng.uniform(-3, 3)], [0, s, rng.uniform(-3, 3)],
                            [0, 0, 1]], np.float32))
    for ang in (90.0, 180.0, -33.0, 117.5, rng.uniform(-180, 180)):
        ms.append(np.asarray(j_rotation(c, np.float32(ang)), np.float32))
    far = np.eye(3, dtype=np.float32)
    far[0, 2] = 3.0 * hw_
    ms.append(far)
    return np.stack(ms)


def _mismatch_ok(got, want, label):
    bad = int(np.sum(got != want))
    bound = max(1e-4 * got.size, 2)
    print(f"{label}: {bad} of {got.size} pixels differ (bound {bound:g})")
    assert bad <= bound, f"{label}: {bad} pixels differ"


@pytest.mark.parametrize("size", SIZES)
def test_gather_warp_matches_jax(size):
    """(a) nearest bit-exact, with and without the NV mask, and a
    projective transform; 'linear' within 1e-4 mm."""
    m = _transforms(size, 1)
    m[-1, 2, :2] = (1e-3, -2e-3)  # projective: the /sz matters
    p = _patches(len(m), size, 2)
    for nv in (None, NV_VAL):
        want = np.asarray(j_warp_patch(p, m, nv_val=nv))
        got = warp_patch(torch.from_numpy(p), torch.from_numpy(m), nv_val=nv).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(j_warp_patch(p, m, nv_val=NV_VAL, use_bilinear=True))
    got = warp_patch(torch.from_numpy(p), torch.from_numpy(m), nv_val=NV_VAL,
                     use_bilinear=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # out_hw and leading batch axes
    got = warp_patch(torch.from_numpy(p[:4].reshape(2, 2, size, size)),
                     torch.from_numpy(m[:4].reshape(2, 2, 3, 3)),
                     out_hw=(size // 2, size)).numpy()
    want = np.asarray(j_warp_patch(p[:4], m[:4], out_hw=(size // 2, size)))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("size", SIZES)
def test_plain_k4_matches_pallas_interpret(size):
    """(b) identity, separable, rotations, out of frame and NV as one
    mixed batch."""
    m = _transforms(size, 3)
    p = _patches(len(m), size, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_warp_patch(p, jnp.asarray(m), nv_val=NV_VAL))
    got = hw.hopper_warp_patch(torch.from_numpy(p), torch.from_numpy(m),
                               nv_val=NV_VAL).numpy()
    _mismatch_ok(got, want, f"plain K4 vs Pallas {size}x{size}")
    # the identity passes every pixel through, NV markers -> border
    np.testing.assert_array_equal(got[0], np.where(p[0] == NV_VAL, 0.0, p[0]))
    np.testing.assert_array_equal(got[0], want[0])
    # far out of frame: the border everywhere
    np.testing.assert_array_equal(got[-1], 0.0)
    np.testing.assert_array_equal(want[-1], 0.0)
    # without the NV mask the markers pass through
    plain = hw.hopper_warp_patch(torch.from_numpy(p[:1]), torch.from_numpy(m[:1])).numpy()
    np.testing.assert_array_equal(plain[0], p[0])


def test_plain_k4_against_gather_warp():
    """The kernel's function skips /sz; on affine transforms it agrees
    with the gather warp but for half-integer flips."""
    m = _transforms(64, 5)
    p = _patches(len(m), 64, 6)
    got = hw.hopper_warp_patch(torch.from_numpy(p), torch.from_numpy(m), nv_val=NV_VAL)
    want = warp_patch(torch.from_numpy(p), torch.from_numpy(m), nv_val=NV_VAL)
    _mismatch_ok(got.numpy(), want.numpy(), "plain K4 vs gather warp")


def _norm_inputs(size, seed, zero_one):
    rng = np.random.default_rng(seed)
    m = _transforms(size, seed)
    b = len(m)
    com_z = rng.uniform(500.0, 800.0, b).astype(np.float32)
    cube_z = rng.uniform(200.0, 300.0, b).astype(np.float32)
    mm = com_z[:, None, None] + rng.uniform(-0.5, 0.5, (b, size, size)).astype(
        np.float32) * cube_z[:, None, None]
    mm[rng.uniform(size=mm.shape) < 0.2] = com_z[0] + cube_z[0]  # far
    if zero_one:
        patch = (mm - (com_z - cube_z / 2)[:, None, None]) / cube_z[:, None, None]
    else:
        patch = (mm - com_z[:, None, None]) / (cube_z / 2)[:, None, None]
    thresh = np.arange(b) % 2 == 0
    zs = (com_z - rng.uniform(80.0, 120.0, b)).astype(np.float32)
    ze = (com_z + rng.uniform(80.0, 120.0, b)).astype(np.float32)
    new_com_z = (com_z + rng.uniform(-10.0, 10.0, b)).astype(np.float32)
    new_cube_z = (cube_z * rng.uniform(0.95, 1.05, b)).astype(np.float32)
    return (patch.astype(np.float32), m, com_z, cube_z, thresh, zs, ze,
            new_com_z, new_cube_z)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("zero_one", [False, True])
def test_plain_k5_matches_pallas_interpret(size, zero_one):
    """(c)"""
    args = _norm_inputs(size, 7 + size, zero_one)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_warp_norm(
            *[jnp.asarray(a) for a in args], norm_zero_one=zero_one,
            border=0.0, nv_val=NV_VAL))
    got = hw.hopper_warp_norm(*[torch.from_numpy(np.asarray(a)) for a in args],
                              norm_zero_one=zero_one, border=0.0,
                              nv_val=NV_VAL).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("zero_one", [False, True])
def test_plain_k5_equals_unfused_pipeline(zero_one):
    """(d) K5's function equals unnormalize -> premax -> K4 -> threshold ->
    renormalize written out as the JAX augment_batch writes it."""
    (patch, m, com_z, cube_z, thresh, zs, ze, new_com_z,
     new_cube_z) = [torch.from_numpy(np.asarray(a)) for a in _norm_inputs(64, 9, zero_one)]
    fused = hw.hopper_warp_norm(patch, m, com_z, cube_z, thresh, zs, ze,
                                new_com_z, new_cube_z, norm_zero_one=zero_one,
                                nv_val=NV_VAL)
    cz, cu = com_z[:, None, None], cube_z[:, None, None]
    if zero_one:
        img = patch * cu + (cz - cu / 2.0)
    else:
        img = patch * (cu / 2.0) + cz
    premax = torch.amax(img, dim=(1, 2))[:, None, None]
    warped = hw.hopper_warp_patch(img, m, nv_val=NV_VAL)
    th = thresh[:, None, None]
    zs_b, ze_b = zs[:, None, None], ze[:, None, None]
    warped = torch.where(th & (warped < zs_b) & (warped != 0.0), zs_b, warped)
    warped = torch.where(th & (warped > ze_b), 0.0, warped)
    ncz, ncu = new_com_z[:, None, None], new_cube_z[:, None, None]
    zend, zstart = ncz + ncu / 2.0, ncz - ncu / 2.0
    d = torch.where(warped == premax, zend, warped)
    d = torch.where(d == 0.0, zend, d)
    d = torch.clamp(d, zstart, zend)
    want = (d - zstart) / ncu if zero_one else (d - ncz) / (ncu / 2.0)
    assert torch.equal(fused, want)


def test_block_k_changes_nothing_and_devices():
    m = _transforms(32, 11)
    p = torch.from_numpy(_patches(len(m), 32, 12))
    ref = hw.hopper_warp_patch(p, torch.from_numpy(m), nv_val=NV_VAL)
    got = hw.hopper_warp_patch(p, torch.from_numpy(m), nv_val=NV_VAL, block_k=4)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="cpu or cuda"):
        hw.hopper_warp_patch(torch.zeros((1, 32, 32), device="meta"),
                             torch.eye(3)[None])
    with pytest.raises(ValueError, match="CUDA"):
        hw.launch_warp(p, hw.warp_patch_params(torch.from_numpy(m)))
