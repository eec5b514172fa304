"""The port's ScaleNet and CNN CoM refiner against the JAX package.

flax ScaleNet (hidden 64, float32) and the port's with the same weights,
converted by utils/convert.py::scalenet_state_dict_from_flax, for both
``shared_conv`` values: outputs within rtol 1e-4.  CNNComRefiner: the
refined CoMs within rtol 1e-4, atol 1e-2 px/mm of the JAX refiner on the
same frames (the crops are bit-exact; the model and the projection
round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepprior_tpu.camera import ICVL_CAMERA as JAX_ICVL
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.models.scalenet import ScaleNet as FlaxScaleNet
from deepprior_tpu.models.scalenet import ScaleNetConfig as FlaxConfig
from deepprior_tpu.models.scalenet import multiscale_center_crops as jax_crops
from deepprior_tpu.ops.crop import clamp_depth
from deepprior_tpu.ops.refine_cnn import CNNComRefiner as JaxRefiner

from deepprior_tpu_torch.camera import ICVL_CAMERA
from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
from deepprior_tpu_torch.models.scalenet import multiscale_center_crops, tower_sides
from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
from deepprior_tpu_torch.utils.convert import (
    _nhwc_rows_to_nchw,
    scalenet_state_dict_from_flax,
)


def _flax(shared, seed=1):
    model = FlaxScaleNet(FlaxConfig(shared_conv=shared, hidden=64))
    variables = model.init(jax.random.key(seed), jnp.zeros((1, 128, 128, 1)))
    return model, variables, jax.tree.map(np.asarray, variables["params"])


def _port(shared, params):
    model = ScaleNet(ScaleNetConfig(shared_conv=shared, hidden=64)).eval()
    model.load_state_dict(scalenet_state_dict_from_flax(params))
    return model


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(0).uniform(-1.0, 1.0, (3, 128, 128)).astype(np.float32)


@pytest.mark.parametrize("shared", [False, True])
def test_scalenet_matches_flax(crops, shared):
    fmodel, variables, params = _flax(shared)
    want = np.asarray(fmodel.apply(variables, crops[..., None]))
    model = _port(shared, params)
    with torch.no_grad():
        got = model(torch.from_numpy(crops)[:, None]).numpy()
        # the three scale inputs given explicitly
        xs = multiscale_center_crops(torch.from_numpy(crops)[:, None])
        listed = model(xs).numpy()
    assert got.shape == (3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(listed, got)
    n_convs = sum(1 for k in model.state_dict() if k.endswith("conv.weight"))
    assert n_convs == (3 if shared else 9)


def test_center_crops_match_jax(crops):
    want = jax_crops(crops[..., None])
    got = multiscale_center_crops(torch.from_numpy(crops)[:, None])
    assert [tuple(g.shape[-2:]) for g in got] == [(128, 128), (64, 64), (32, 32)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, 0].numpy(), np.asarray(w)[..., 0])


def test_head_rows_permute_per_tower(crops):
    """The first Dense reads 968 + 968 + 512 rows from three maps: one
    permutation of the whole matrix is refused (2448 rows are not C*H*H),
    and leaving the rows in flax's order changes the output."""
    assert tower_sides() == (11, 11, 8)
    fmodel, variables, params = _flax(False)
    kern = params["MLPHead_0"]["Dense_0"]["kernel"]
    assert kern.shape[0] == 8 * (11 * 11 + 11 * 11 + 8 * 8)
    with pytest.raises(ValueError, match="C\\*H\\*H"):
        _nhwc_rows_to_nchw(kern, 8)
    model = _port(False, params)
    sd = scalenet_state_dict_from_flax(params)
    sd["head.dense.0.weight"] = torch.tensor(kern.T.copy())  # no permutation
    model.load_state_dict(sd)
    want = np.asarray(fmodel.apply(variables, crops[..., None]))
    with torch.no_grad():
        got = model(torch.from_numpy(crops)[:, None]).numpy()
    assert np.abs(got - want).max() > 1e-3


def test_cnn_com_refiner_matches_jax():
    rng = np.random.default_rng(4)
    frames = [make_frame(JAX_ICVL, rng) for _ in range(3)]
    raw = np.stack([f.extraData["dpt_full"] for f in frames])
    com = np.stack([f.com for f in frames]).astype(np.float32)
    com[:, :2] += 6.0
    cube = np.full(3, 250.0, np.float32)
    fmodel, variables, params = _flax(False, seed=3)
    dc = np.array(clamp_depth(raw)[0])
    want = np.asarray(JaxRefiner(fmodel, variables, JAX_ICVL)(dc, com, cube))
    refiner = CNNComRefiner(_port(False, params), ICVL_CAMERA)
    got = refiner(torch.from_numpy(dc), torch.from_numpy(com), cube).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    assert np.abs(got - com).max() > 0.1  # it moved the CoM
    # a CoM at zero depth (the centred-crop fallback of the crop)
    zero = np.zeros((1, 3), np.float32)
    out = refiner(torch.from_numpy(dc[:1]), torch.from_numpy(zero), cube).numpy()
    np.testing.assert_allclose(out, np.asarray(
        JaxRefiner(fmodel, variables, JAX_ICVL)(dc[:1], zero, cube)), rtol=1e-4, atol=1e-2)
