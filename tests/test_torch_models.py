"""The port's PoseRegNet against the flax PoseRegNet on converted weights.

A narrow flax model (hidden=64, float32) is initialised, its biases and
learned activation slopes randomised so that every parameter matters, and
its parameters converted with poseregnet_state_dict_from_flax.  Both
models see the same crops (NHWC for flax, NCHW for torch).  Tolerance
rtol 1e-4, atol 1e-5: the conv and dense sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
from deepprior_tpu.models.layers import prelu as jax_prelu

from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.models.layers import prelu
from deepprior_tpu_torch.utils.convert import poseregnet_state_dict_from_flax

CASES = {
    # flagship embedding regressor (decoded by the PCA prior)
    "plain": dict(num_joints=1, n_dims=30),
    # type 11: the 30-D bottleneck inside the head
    "embedding": dict(num_joints=14, n_dims=3, embedding=30),
    # learned-parameter activation (per-unit c0, c1)
    "prelu": dict(num_joints=14, n_dims=3, activation="prelu"),
}


def _randomise(params, rng):
    """Give zero-initialised leaves (biases) and the constant prelu
    slopes random values, so a wrong mapping of any of them shows."""
    def leaf(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if "bias" in name or "'c0'" in name or "'c1'" in name:
            return (x + rng.uniform(-0.2, 0.2, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def make_pair(case, seed=0, hidden=64):
    """(flax model, its params as numpy, the port's model) on the same
    weights."""
    kw = dict(CASES[case])
    act = kw.pop("activation", None)
    flax_model = FlaxPoseRegNet(FlaxConfig(
        hidden=hidden, **kw, **({"activation": jax_prelu} if act else {})
    ))
    variables = flax_model.init(jax.random.key(seed), jnp.zeros((1, 128, 128, 1)))
    params = _randomise(variables["params"], np.random.default_rng(seed))
    model = PoseRegNet(PoseRegNetConfig(
        hidden=hidden, **kw, **({"activation": prelu} if act else {})
    ))
    model.load_state_dict(poseregnet_state_dict_from_flax(params), strict=True)
    return flax_model, params, model.eval()


def _crops(seed, b=3):
    """Crops that are not symmetric under any transpose of the trunk's
    feature maps."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (b, 128, 128)).astype(np.float32)
    x[:, :40, :] -= 0.5  # a gradient along rows, none along columns
    return x


@pytest.mark.parametrize("case", list(CASES))
def test_poseregnet_matches_flax(case):
    flax_model, params, model = make_pair(case)
    x = _crops(1)
    want = np.asarray(flax_model.apply({"params": params}, x[..., None]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None]).numpy()
    assert got.shape == want.shape == (3, flax_model.cfg.out_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_flatten_permutation_is_needed():
    """Converting the first Dense kernel without reordering its rows from
    NHWC to NCHW flatten order must give a different output."""
    flax_model, params, model = make_pair("plain", seed=3)
    x = _crops(2)
    want = np.asarray(flax_model.apply({"params": params}, x[..., None]))
    sd = poseregnet_state_dict_from_flax(params)
    sd["head.dense.0.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["MLPHead_0"]["Dense_0"]["kernel"]).T)
    )
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None]).numpy()
    assert not np.allclose(got, want, rtol=1e-2, atol=1e-3)


def test_generator_init_is_seeded_and_scaled():
    """Init draws only from the given generator: He-normal convs and
    hidden layers, Xavier-uniform output layers, zero biases."""
    cfg = PoseRegNetConfig(num_joints=1, n_dims=30)
    a = PoseRegNet(cfg, generator=torch.Generator().manual_seed(7))
    b = PoseRegNet(cfg, generator=torch.Generator().manual_seed(7))
    c = PoseRegNet(cfg, generator=torch.Generator().manual_seed(8))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name.endswith("weight"):
            assert not torch.equal(pa, pc), name
        else:
            assert not pa.any(), name
    w = a.head.dense[0].weight  # He normal, fan_in 968
    assert abs(w.std().item() - (2.0 / 968) ** 0.5) < 0.05 * (2.0 / 968) ** 0.5
    w = a.head.dense[2].weight  # Xavier uniform, fan 1024 + 30
    limit = (6.0 / (1024 + 30)) ** 0.5
    assert w.abs().max().item() <= limit
    assert w.abs().max().item() > 0.95 * limit


def test_bf16_compute_keeps_float32_params_and_output():
    cfg = PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64, dtype=torch.bfloat16)
    model = PoseRegNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.from_numpy(_crops(3))[:, None]
    ref = PoseRegNet(cfg._replace(dtype=torch.float32))
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = model(x)
        want = ref.eval()(x)
    assert out.dtype == torch.float32 and out.shape == (3, 30)
    # bf16 keeps about 3 significant digits through 5 layers
    torch.testing.assert_close(out, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kind", ["max", "avg", "subsample", "none"])
@pytest.mark.parametrize("window", [(2, 2), (3, 2), (1, 1)])
def test_pool2d_matches_jax(kind, window):
    """The standalone pooling kinds on an odd-sized NCHW map against the
    JAX NHWC pool2d: bit-equal (max and subsample pick, avg sums its window
    in either order within rtol 1e-6)."""
    from deepprior_tpu.models.layers import pool2d as jax_pool2d
    from deepprior_tpu_torch.models.layers import pool2d

    x = np.random.default_rng(2).standard_normal((2, 3, 11, 13)).astype(np.float32)
    want = np.asarray(jax_pool2d(jnp.asarray(x.transpose(0, 2, 3, 1)), window, kind))
    got = pool2d(torch.from_numpy(x), window, kind).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6 if kind == "avg" else 0, atol=0)
    with pytest.raises(ValueError, match="unknown pool kind"):
        pool2d(torch.from_numpy(x), (2, 2), "median")


@pytest.mark.parametrize("shape", [(64, 968), (968, 64), (32, 8, 3, 3), (16, 16)])
def test_orthogonal_init_is_orthogonal(shape):
    """The orthogonal init: the shape kept, rows orthonormal where there
    are at most as many as columns, columns otherwise (flax's
    initializers.orthogonal() on the transposed kernel has the same law;
    bits cannot match across RNGs), within 1e-5; deterministic per seed."""
    from deepprior_tpu.models.layers import orthogonal_init
    from deepprior_tpu_torch.models.layers import orthogonal_init_

    w = orthogonal_init_(torch.empty(shape), generator=torch.Generator().manual_seed(0))
    assert w.shape == shape
    m = w.reshape(shape[0], -1).double()
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]), atol=1e-5)
    again = orthogonal_init_(torch.empty(shape), generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, again)
    # flax's init of the same matrix as a (rest, out) kernel: the same Gram
    kern = np.asarray(orthogonal_init(jax.random.key(0), (m.shape[1], m.shape[0])))
    k = kern.astype(np.float64)
    jgram = k.T @ k if k.shape[1] <= k.shape[0] else k @ k.T
    np.testing.assert_allclose(jgram, np.eye(jgram.shape[0]), atol=1e-5)
    assert jgram.shape == gram.shape
