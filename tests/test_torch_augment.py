"""The port's augment_batch against the JAX package's.

Both packages get the same draws: JAX's sample_augment_params(key, ...)
feeds the port through its ``params`` seam, and the JAX augment_batch
(use_pallas=False, the gather warp) draws the same numbers from the same
key.  Crops: at most max(1e-4 of the pixels, 2) may differ (cos/sin and
the 3x3 compose may differ by an ulp and flip a half-integer source
coordinate); labels within 1e-4; com, cube and M within rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from deepprior_tpu.camera import NYU_CAMERA as J_NYU
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.ops import augment as jaug
from deepprior_tpu.ops.crop import normalize_crop

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.ops import augment as taug

B = 8
NAMES = ("crops", "labels", "com", "cube", "m")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    frames = [make_frame(J_NYU, rng) for _ in range(B)]
    cube = np.tile(np.array([250.0, 250.0, 250.0], np.float32), (B, 1))
    cube[1::2] = 300.0
    crops = np.stack([f.dpt for f in frames])
    com = np.stack([f.com for f in frames]).astype(np.float32)
    m = np.stack([f.T for f in frames])
    gt3d = np.stack([f.gt3Dcrop for f in frames])
    return crops, gt3d, com, cube, m


def _normed(crops, com, cube, zero_one):
    return np.array(normalize_crop(crops, com[:, 2], cube[:, 2], zero_one))


def _compare(got, want, label):
    got = [t.numpy() for t in got]
    want = [np.asarray(a) for a in want]
    bad = int(np.sum(got[0] != want[0]))
    bound = max(1e-4 * got[0].size, 2)
    print(f"{label}: {bad} of {got[0].size} crop pixels differ")
    assert bad <= bound, f"{label}: {bad} crop pixels differ"
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    for name, g, w in zip(NAMES[2:], got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)


MODES = {
    "all": ("com", "rot", "sc", "none"),
    "com": ("com",),
    "rot": ("rot",),
    "sc": ("sc",),
    "none": ("none",),
}


@pytest.mark.parametrize("modes", list(MODES))
@pytest.mark.parametrize("zero_one", [False, True])
def test_augment_matches_jax(batch, modes, zero_one):
    crops, gt3d, com, cube, m = batch
    aug_modes = MODES[modes]
    cn = _normed(crops, com, cube, zero_one)
    key = jax.random.key(11)
    params = [np.array(a) for a in jaug.sample_augment_params(key, B, len(aug_modes))]
    want = jaug.augment_batch(key, cn, gt3d, com, cube, m, J_NYU,
                              aug_modes=aug_modes, norm_zero_one=zero_one,
                              use_pallas=False)
    got = taug.augment_batch(None, torch.from_numpy(cn), gt3d, com, cube, m,
                             NYU_CAMERA, aug_modes=aug_modes,
                             norm_zero_one=zero_one, params=params)
    _compare(got, want, f"{modes} zero_one={zero_one}")


def test_augment_linear_matches_jax(batch):
    crops, gt3d, com, cube, m = batch
    cn = _normed(crops, com, cube, False)
    aug_modes = MODES["all"]
    key = jax.random.key(12)
    params = [np.array(a) for a in jaug.sample_augment_params(key, B, 4)]
    want = jaug.augment_batch(key, cn, gt3d, com, cube, m, J_NYU,
                              aug_modes=aug_modes, resize="linear")
    got = taug.augment_batch(None, torch.from_numpy(cn), gt3d, com, cube, m,
                             NYU_CAMERA, aug_modes=aug_modes, resize="linear",
                             params=params)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)


def test_kernel_paths_on_cpu(batch):
    """use_pallas=True with fuse_norm=False runs K4's plain version (no
    /sz); fuse_norm=True K5's, which equals the unfused pipeline bit for
    bit; block_k changes nothing."""
    crops, gt3d, com, cube, m = batch
    cn = torch.from_numpy(_normed(crops, com, cube, False))
    params = taug.sample_augment_params(torch.Generator().manual_seed(3), B, 4)
    kw = dict(aug_modes=MODES["all"], params=params)
    gather = taug.augment_batch(None, cn, gt3d, com, cube, m, NYU_CAMERA, **kw)
    k4 = taug.augment_batch(None, cn, gt3d, com, cube, m, NYU_CAMERA,
                            use_pallas=True, fuse_norm=False, **kw)
    k5 = taug.augment_batch(None, cn, gt3d, com, cube, m, NYU_CAMERA,
                            use_pallas=True, fuse_norm=True, **kw)
    k4b = taug.augment_batch(None, cn, gt3d, com, cube, m, NYU_CAMERA,
                             use_pallas=True, fuse_norm=False, block_k=4, **kw)
    bad = int((k4[0] != gather[0]).sum())
    assert bad <= max(1e-4 * k4[0].numel(), 2), bad
    for a, b, c in zip(k4, k5, k4b):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_generator_draws_are_reproducible(batch):
    crops, gt3d, com, cube, m = batch
    cn = torch.from_numpy(_normed(crops, com, cube, False))
    outs = [taug.augment_batch(torch.Generator().manual_seed(s), cn, gt3d, com,
                               cube, m, NYU_CAMERA)[0] for s in (4, 4, 5)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_linear_fails_loudly(batch):
    crops, gt3d, com, cube, m = batch
    cn = torch.from_numpy(_normed(crops, com, cube, False))
    g = torch.Generator().manual_seed(0)
    for kw, what in ((dict(use_pallas=True), "use_pallas"),
                     (dict(fuse_norm=True), "fuse_norm"),
                     (dict(block_k=4), "block_k")):
        with pytest.raises(ValueError, match=what):
            taug.augment_batch(g, cn, gt3d, com, cube, m, NYU_CAMERA,
                               resize="linear", **kw)
    with pytest.raises(ValueError, match="resize"):
        taug.augment_batch(g, cn, gt3d, com, cube, m, NYU_CAMERA, resize="cubic")
    with pytest.raises(ValueError, match="mode"):
        taug.augment_batch(g, cn, gt3d, com, cube, m, NYU_CAMERA, aug_modes=("flip",))


def test_sample_params_distribution():
    """test_augment.py's distribution test, on the torch sampler."""
    mode, off, rot, sc = (t.numpy() for t in taug.sample_augment_params(
        torch.Generator().manual_seed(0), 4096, 3))
    assert set(np.unique(mode)) <= {0, 1, 2}
    assert abs(off.std() - 5.0) < 0.5
    assert abs(rot.max()) <= 180.0 and rot.std() > 80.0
    assert abs(sc.mean() - 1.0) < 0.01
