"""The port's serving path against the JAX package, end to end on the CPU.

JAX: FusedEstimator(crop_method='pallas'), the Pallas crop kernel in
interpret mode, a float32 flax PoseRegNet (hidden=64) and a (30, 42) PCA
prior.  Port: FusedEstimator on the CPU (the plain crop), the same
weights converted, the same prior.  Required: crops bit-exact, com3d
within rtol 1e-6, joints within 1e-3 mm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.camera import ICVL_CAMERA as JAX_ICVL
from deepprior_tpu.camera import NYU_CAMERA as JAX_NYU
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
from deepprior_tpu.realtime.fused import FusedEstimator as JaxFusedEstimator

from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_depth_frame
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
from deepprior_tpu_torch.realtime.fused import FusedEstimator
from deepprior_tpu_torch.utils.convert import poseregnet_state_dict_from_flax

B = 4


@pytest.fixture(scope="module")
def setup():
    flax_model = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64))
    variables = flax_model.init(jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(0)
    comps = (rng.standard_normal((30, 42)) * 0.05).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, 42).astype(np.float32)
    jax_est = JaxFusedEstimator(flax_model, JAX_NYU, prior=JaxPCAPrior(comps, mean),
                                crop_method="pallas")

    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    model.load_state_dict(poseregnet_state_dict_from_flax(params))
    est = FusedEstimator(model, NYU_CAMERA, prior=PCAPrior(comps, mean),
                         device="cpu")

    frames = [make_frame(JAX_NYU, np.random.default_rng(40 + i)) for i in range(B)]
    depth = np.stack([f.extraData["dpt_full"] for f in frames])
    com = np.stack([f.com for f in frames])
    return jax_est, variables, est, depth, com


CALLS = {
    "default": {},
    "cube": dict(cube=np.array([[250, 250, 250], [300, 300, 300],
                                [200, 240, 220], [400, 400, 400]], np.float32)),
    "mirror": dict(mirror=np.array([True, False, True, False])),
    "invx": dict(invx=True),
    "invy": dict(invy=True, mirror=np.array([False, True, False, True])),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_fused_matches_jax_pallas(setup, call):
    jax_est, variables, est, depth, com = setup
    kw = CALLS[call]
    with pltpu.force_tpu_interpret_mode():
        j_want, c3_want, cr_want = jax_est(variables, depth, com, **kw)
    j_got, c3_got, cr_got = est(depth, com, **kw)
    assert est.crop_method == "gather"
    np.testing.assert_array_equal(cr_got.numpy(), np.asarray(cr_want))
    np.testing.assert_allclose(c3_got.numpy(), np.asarray(c3_want), rtol=1e-6)
    assert j_got.shape == (B, 14, 3)
    np.testing.assert_allclose(j_got.numpy(), np.asarray(j_want), rtol=0, atol=1e-3)


def test_crop_methods_agree_on_cpu(setup):
    """'pallas'/'hopper' on the CPU run the wrapper's plain path, and
    'onehot' is the same gather: all bit-equal to 'auto'."""
    _, _, est, depth, com = setup
    j0, _, c0 = est(depth, com, mirror=np.array([True, False, False, True]))
    for method in ("pallas", "hopper", "onehot", "gather"):
        other = FusedEstimator(est.model, NYU_CAMERA, prior=est.prior,
                               crop_method=method, min_depth_mm=500.0)
        j1, _, c1 = other(depth, com, mirror=np.array([True, False, False, True]))
        np.testing.assert_array_equal(c1.numpy(), c0.numpy())
        np.testing.assert_array_equal(j1.numpy(), j0.numpy())


def test_unported_modes_raise(setup):
    """The modes the port does not have raise: the JAX estimator's XLA
    crop method and a resize method the reference does not offer.  (The
    detect, refine_iters and resize modes are held against the JAX
    estimator in test_torch_realtime.py.)"""
    _, _, est, _, _ = setup
    with pytest.raises(ValueError):
        FusedEstimator(est.model, NYU_CAMERA, crop_method="xla")
    with pytest.raises(ValueError, match="cubic"):
        FusedEstimator(est.model, NYU_CAMERA, resize="cubic")


@pytest.mark.parametrize("cam_name", ["nyu", "icvl"])
def test_make_depth_frame_matches_make_frame(cam_name):
    jcam, tcam = {"nyu": (JAX_NYU, NYU_CAMERA), "icvl": (JAX_ICVL, ICVL_CAMERA)}[cam_name]
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        f = make_frame(jcam, r1)
        dpt, com = make_depth_frame(tcam, r2)
        np.testing.assert_array_equal(dpt, f.extraData["dpt_full"])
        np.testing.assert_array_equal(com, f.com)
        assert dpt.dtype == np.float32 and com.dtype == np.float32


def test_micro_batch_server_round_trip(setup):
    """Requests with and without per-request cube/mirror, batched and
    tail-padded by the server, against one direct estimator call on the
    same padded batch."""
    _, _, est, depth, com = setup
    cubes = [None, np.array([300, 300, 300], np.float32), None, None]
    mirrors = [False, False, True, False]
    with MicroBatchServer(est, max_batch=8, max_wait_ms=50) as srv:
        futs = [srv.submit(depth[i], com[i], cube=cubes[i], mirror=mirrors[i])
                for i in range(B)]
        got = np.stack([f.result(timeout=60) for f in futs])
        with pytest.raises(ValueError):
            srv.submit(depth[0][:100], com[0])
    assert srv.stats["frames"] == B and srv.stats["errors"] == 0
    assert 0.0 < srv.occupancy() <= 1.0

    pad = 8 - B
    cube = np.stack([c if c is not None else np.full(3, 250.0, np.float32)
                     for c in cubes] + [np.full(3, 250.0, np.float32)] * pad)
    want, _, _ = est(
        np.concatenate([depth, np.repeat(depth[-1:], pad, 0)]),
        np.concatenate([com, np.repeat(com[-1:], pad, 0)]),
        cube=cube, mirror=np.array(mirrors + [False] * pad),
    )
    np.testing.assert_allclose(got, want.numpy()[:B], rtol=0, atol=1e-3)
