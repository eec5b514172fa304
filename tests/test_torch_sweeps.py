"""The port's randomized differential sweeps (deepprior_tpu_torch/prof/sweeps.py)
on the CPU, against the independent numpy twins and the JAX package.

The root probes prof_{crop,aug,detect}_sweep.py run their whole sweep at
import and import jax, so they are never imported here: their ``def``
nodes are compiled with ``ast`` into a namespace holding the module-global
``rng`` they read, and the port's copies, given a generator of the same
seed, must draw the same scenes and compute the same twins bit for bit.

Then the port's functions go over random scenes at the probes' tolerances
(each stated at its check in sweeps.py): crop3d in the three resize modes
against HandCropper (nearest bit for bit, and against the JAX gather crop
bit for bit), augment_batch through params= against the augmentation
twin (and the JAX augment_batch on its own draws against the same twin),
sample_random_poses against the prior twin (relative 1e-5), and
calculate_com / refine_com_iterative / detect against HandCropper (and
against the JAX functions within rtol 1e-4 / atol 1e-2, tests/
test_torch_com.py's bound).  A small N runs in tier-1; the ``slow`` cases
run a larger one.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from deepprior_tpu.camera import ICVL_CAMERA as J_ICVL
from deepprior_tpu.camera import MSRA15_CAMERA as J_MSRA
from deepprior_tpu.camera import NYU_CAMERA as J_NYU

from deepprior_tpu_torch.camera import ICVL_CAMERA, MSRA15_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.ops.augment import NV_VAL, augment_batch
from deepprior_tpu_torch.ops.crop import clamp_depth, crop3d
from deepprior_tpu_torch.prior import sample_random_poses
from deepprior_tpu_torch.prof import sweeps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = {"nyu": (NYU_CAMERA, J_NYU), "icvl": (ICVL_CAMERA, J_ICVL)}


def _probe(script, seed, **names):
    """The ``def`` nodes of a root probe, compiled into a namespace with
    numpy, the module-global ``rng`` seeded ``seed`` and ``names``."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    tree.body = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    ns = {"np": np, "rng": np.random.default_rng(seed), **names}
    exec(compile(tree, script, "exec"), ns)
    return ns


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the copies
@pytest.mark.parametrize("cam", ["nyu", "icvl"])
def test_scene_generators_match_the_probes(cam):
    """Same seed, same scenes: the crop probe's depths, CoMs and cubes and
    the detection probe's scenes, seeds and cubes, in the probes' draw
    order (their main loops: n scenes, then n CoMs, then the cubes)."""
    tcam, jcam = CAMS[cam]
    n = 12
    crop = _probe("prof_crop_sweep.py", 20260819)
    r = crop["rng"]
    want = (np.stack([crop["random_depth"](jcam, int(r.integers(0, 4))) for _ in range(n)]),
            np.stack([crop["random_com"](jcam, int(r.integers(0, 4))) for _ in range(n)]),
            r.uniform(100.0, 400.0, (n, 1)).repeat(3, 1).astype(np.float32))
    got = sweeps.crop_scenes(np.random.default_rng(20260819), tcam, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    det = _probe("prof_detect_sweep.py", 20260821)
    r = det["rng"]
    want = (np.stack([det["random_scene"](jcam, int(r.integers(0, 7))) for _ in range(n)]),
            np.stack([det["random_seed_com"](jcam, int(r.integers(0, 4))) for _ in range(n)]),
            r.uniform(150.0, 350.0, (n, 1)).repeat(3, 1).astype(np.float32))
    got = sweeps.detect_scenes(np.random.default_rng(20260821), tcam, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_augment_twin_matches_the_probe():
    """The augmentation twin, bit for bit, over every mode and both
    normalizations, on random samples of both cameras."""
    probe = _probe("prof_aug_sweep.py", 0, NV_VAL=NV_VAL)
    rng = np.random.default_rng(3)
    for cam in ("nyu", "icvl"):
        tcam, jcam = CAMS[cam]
        for zero_one in (False, True):
            crops_n, gt3d, com, cube, m = sweeps.augment_inputs(rng, tcam, 4, zero_one)
            for i, mode in enumerate(("com", "rot", "sc", "none")):
                args = (crops_n[i], gt3d[i], com[i], cube[i], m[i], mode,
                        rng.normal(0, 5, 3).astype(np.float32), np.float32(rng.uniform(-180, 180)),
                        np.float32(abs(1 + 0.02 * rng.normal())))
                got = sweeps.twin_augment_one(tcam, *args, norm_zero_one=zero_one)
                want = probe["twin_augment_one"](jcam, *args, norm_zero_one=zero_one)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)


def test_prior_twin_matches_the_probe():
    """The prior twin, bit for bit, on the prior probe's own draws."""
    probe = _probe("prof_prior_sweep.py", 0, N_SCENES=0)  # run_sweep's default
    rng = np.random.default_rng(4)
    for (tcam, jcam) in ((NYU_CAMERA, J_NYU), (MSRA15_CAMERA, J_MSRA)):
        base_poses = rng.normal(0.0, 60.0, (5, 14, 3))
        base_com = np.stack([rng.uniform(20, 300, 5), rng.uniform(20, 220, 5),
                             rng.uniform(250, 1400, 5)], axis=1)
        base_cube = rng.uniform(150, 400, (5, 1)) * np.ones((1, 3))
        for mset in sweeps.PRIOR_MODE_SETS:
            for rot3d in (False, True):
                draws = (rng.integers(0, len(mset), 16), rng.integers(0, 5, 16),
                         rng.normal(0, 5, (16, 3)), np.abs(rng.normal(1, 0.02, 16)),
                         rng.uniform(-180, 180, (16, 3)))
                got = sweeps.twin_sample(tcam, base_poses, base_com, base_cube, mset, *draws,
                                         rot3d)
                want = probe["twin_sample"](jcam, base_poses, base_com, base_cube, mset,
                                            *draws, rot3d)
                for g, w in zip(got, want):
                    if w is None:
                        assert g is None
                    else:
                        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the sweeps
def _crop_sweep(cam, n, seed):
    from deepprior_tpu.ops.crop import crop3d as jcrop3d

    tcam, jcam = CAMS[cam]
    dpts, coms, cubes = sweeps.crop_scenes(np.random.default_rng(seed), tcam, n)
    dpt_c = clamp_depth(torch.from_numpy(dpts))[0]
    crops = {}
    for mode in ("nearest", "linear", "nd_bilinear"):
        c, m = crop3d(dpt_c, torch.from_numpy(coms), torch.from_numpy(cubes), tcam.fx, tcam.fy,
                      resize=mode)
        crops[mode] = c.numpy()
        if mode == "nearest":
            m_near = m.numpy()
    bad = sweeps.check_crops(tcam, dpt_c.numpy(), coms, cubes, crops, m_near)
    assert not bad, bad[:5]
    # the JAX gather crop on the same clamped frames: bit for bit
    jc, jm = jcrop3d(dpt_c.numpy(), coms, cubes, jcam.fx, jcam.fy, method="gather")
    np.testing.assert_array_equal(crops["nearest"], np.asarray(jc))
    np.testing.assert_array_equal(m_near, np.asarray(jm))


@pytest.mark.parametrize("cam", ["nyu", "icvl"])
def test_crop_sweep(cam):
    _crop_sweep(cam, 6, 42)


@pytest.mark.slow
@pytest.mark.parametrize("cam", ["nyu", "icvl"])
def test_crop_sweep_large(cam):
    _crop_sweep(cam, 48, 43)


def _augment_sweep(n_batches, b, seed, jax_batches):
    from deepprior_tpu.ops.augment import augment_batch as jaugment
    from deepprior_tpu.ops.augment import sample_augment_params as jsample

    rng = np.random.default_rng(seed)
    for bi in range(n_batches):
        tcam, jcam = (CAMS["nyu"], CAMS["icvl"])[bi % 2]
        zero_one = bi % 3 == 2
        modes = sweeps.AUG_MODE_SETS[bi % len(sweeps.AUG_MODE_SETS)]
        inputs = sweeps.augment_inputs(rng, tcam, b, zero_one)
        gen = torch.Generator().manual_seed(seed + bi)
        from deepprior_tpu_torch.ops.augment import sample_augment_params

        params = sample_augment_params(gen, b, len(modes))
        got = augment_batch(None, *(torch.from_numpy(a) for a in inputs), tcam,
                            aug_modes=modes, norm_zero_one=zero_one, params=params)
        bad = sweeps.check_augment(tcam, inputs, [p.numpy() for p in params],
                                   [t.numpy() for t in got], modes, zero_one, f"batch={bi}")
        assert not bad, bad[:5]
        if bi >= jax_batches:
            continue
        # the JAX augment_batch on its own draws, against the same twin
        key = jax.random.key(1000 + bi)
        jgot = jaugment(key, *inputs, jcam, aug_modes=modes, norm_zero_one=zero_one,
                        use_pallas=False)
        jparams = [np.asarray(x) for x in jsample(key, b, len(modes))]
        bad = sweeps.check_augment(tcam, inputs, jparams, [np.asarray(t) for t in jgot], modes,
                                   zero_one, f"jax batch={bi}")
        assert not bad, bad[:5]


def test_augment_sweep():
    _augment_sweep(3, 8, 20260820, jax_batches=1)


@pytest.mark.slow
def test_augment_sweep_large():
    _augment_sweep(10, 16, 20260822, jax_batches=10)


def test_prior_sweep():
    """sample_random_poses against the per-pose twin: relative 1e-5 (the
    twin rounds to float32 per step, the port once at the end)."""
    n, worst = sweeps.prior_sweep((NYU_CAMERA, ICVL_CAMERA, MSRA15_CAMERA), 3,
                                  sample_random_poses, poses_per_set=16)
    assert n > 0 and worst < 1e-5, worst


@pytest.mark.slow
def test_prior_sweep_large():
    n, worst = sweeps.prior_sweep((NYU_CAMERA, ICVL_CAMERA, MSRA15_CAMERA), 12,
                                  sample_random_poses)
    assert n > 0 and worst < 1e-5, worst


def _detect_sweep(cam, n, seed, against_jax):
    from deepprior_tpu.ops import com as jcom

    tcam, jcam = CAMS[cam]
    raws, seeds, cubes = sweeps.detect_scenes(np.random.default_rng(seed), tcam, n)
    got = sweeps.run_detection(raws, seeds, cubes, tcam, "cpu")
    bad = sweeps.check_detection(tcam, raws, seeds, cubes, got)
    assert not bad, bad[:5]
    if against_jax:
        want = np.asarray(jax.jit(lambda d, c: jcom.detect(d, c, jcam.fx, jcam.fy))(raws, cubes))
        np.testing.assert_allclose(got["detect20_200"], want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("cam", ["nyu", "icvl"])
def test_detect_sweep(cam):
    _detect_sweep(cam, 6, 7, against_jax=cam == "icvl")


@pytest.mark.slow
@pytest.mark.parametrize("cam", ["nyu", "icvl"])
def test_detect_sweep_large(cam):
    _detect_sweep(cam, 24, 8, against_jax=True)
