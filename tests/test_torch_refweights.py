"""The port's reference-pickle loaders (utils/refweights.py), the cases of
tests/test_refweights.py, with the pickles built in tmp_path from the
port's own weights.

Each family's loader is also held against the JAX loader on the same
pickle: the JAX variables, through utils/convert.py, give the port's
state_dict exactly.  Round trips and imports: forwards bit-equal where the
same weights run the same ops, rtol 1e-5 / atol 1e-4 for the ResNet's
converted BatchNorm (as the JAX test), rtol 1e-4 / atol 2e-4 against the
independent numpy forward of the reference's semantics.
"""

import gzip
import pickle

import jax
import numpy as np
import pytest
import torch

from deepprior_tpu.models import ResNetConfig as FlaxResNetConfig
from deepprior_tpu.utils import refweights as jref

from deepprior_tpu_torch.models import (PoseRegNet, PoseRegNetConfig, ResNet,
                                        ResNetConfig, ScaleNet, ScaleNetConfig)
from deepprior_tpu_torch.models.layers import BatchNorm
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.utils import convert
from deepprior_tpu_torch.utils.refweights import (
    load_reference_pickle,
    model_from_reference_pickle,
    poseregnet_state_dict_from_reference,
    reference_pickle_from_state_dict,
    resnet_state_dict_from_reference,
    scalenet_state_dict_from_reference,
)


def _x(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 1, 128, 128)).astype(np.float32))


def _dump(state, path, gz=False):
    with (gzip.open if gz else open)(path, "wb") as fh:
        pickle.dump(state, fh, 2)  # the py2-era protocol, as netbase.py:417
    return str(path)


def _assert_same_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _randomise(model, seed):
    """Biases and BatchNorm parameters and statistics away from 0 / 1."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith(("bias", "running_mean")) or ".bn" in name or name.startswith("bn."):
                t.add_(torch.from_numpy(rng.uniform(-0.2, 0.2, t.shape).astype(np.float32)))
    return model.eval()


def test_poseregnet_roundtrip(tmp_path):
    """state_dict -> reference pickle layout -> state_dict keeps every weight
    and the network function (the conv flip is its own inverse, the NCHW
    flatten needs no permutation); the JAX loader reads the same pickle
    into the same numbers."""
    model = _randomise(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30),
                                  generator=torch.Generator().manual_seed(0)), 0)
    path = _dump(reference_pickle_from_state_dict(model.state_dict(), "poseregnet"),
                 tmp_path / "net.pkl.gz", gz=True)
    layers = load_reference_pickle(path)
    assert layers[4] == [] and layers[6] == []  # dropout layers: no params
    restored = poseregnet_state_dict_from_reference(layers)
    _assert_same_sd(restored, model.state_dict())
    via_jax = jref.poseregnet_params_from_reference(layers)["params"]
    _assert_same_sd(convert.poseregnet_state_dict_from_flax(via_jax), restored)
    other = PoseRegNet(model.cfg).eval()
    other.load_state_dict(restored)
    with torch.no_grad():
        assert torch.equal(other(_x(2, 1)), model(_x(2, 1)))


def test_scalenet_import_structure(tmp_path):
    """A reference-layout ScaleNet (9 tower convs + the FC head with dropout
    gaps) maps onto the port's towers with a working forward; the JAX
    loader agrees."""
    model = _randomise(ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3),
                                generator=torch.Generator().manual_seed(0)), 1)
    state = reference_pickle_from_state_dict(model.state_dict(), "scalenet")
    layers = load_reference_pickle(_dump(state, tmp_path / "comref.pkl"))
    assert layers[10] == [] and layers[12] == []
    restored = scalenet_state_dict_from_reference(layers)
    _assert_same_sd(restored, model.state_dict())
    via_jax = jref.scalenet_params_from_reference(layers)["params"]
    _assert_same_sd(convert.scalenet_state_dict_from_flax(via_jax), restored)
    other = ScaleNet(model.cfg).eval()
    other.load_state_dict(restored)
    with torch.no_grad():
        assert torch.equal(other(_x(2, 2)), model(_x(2, 2)))


def _np_reference_convpool(x_nchw, w_oihw, b, pool):
    """The reference ConvPoolLayer forward in plain numpy
    (convpoollayer.py:39-305): Theano conv2d is a true convolution
    (filter_flip=True) in OIHW over NCHW, valid padding; the bias before the
    pool; pool_2d(ignore_border=True) floors odd extents; then ReLU.
    Independent of utils/refweights.py, so that the two can disagree."""
    from numpy.lib.stride_tricks import sliding_window_view

    wf = w_oihw[:, :, ::-1, ::-1]  # true convolution = flipped correlation
    win = sliding_window_view(x_nchw, wf.shape[-2:], axis=(2, 3))
    y = np.einsum("bchwuv,ocuv->bohw", win, wf, optimize=True)
    y = y + b[None, :, None, None]
    ph, pw = pool
    if (ph, pw) != (1, 1):
        n, o, h, w = y.shape
        y = y[:, :, : h // ph * ph, : w // pw * pw]
        y = y.reshape(n, o, h // ph, ph, w // pw, pw).max(axis=(3, 5))
    return np.maximum(y, 0.0)


def test_poseregnet_numpy_reference_forward():
    """A random reference-layout net through an independent numpy forward of
    the reference's own semantics (true conv, NCHW, bias before the pool,
    NCHW flatten into the FC stack; poseregnet.py:61-143) and through the
    import + the port's forward.  A round trip stays green under a
    self-consistent but wrong flip or flatten; this does not."""
    rng = np.random.default_rng(11)
    conv_specs = [(8, 1, 5, 5, (4, 4)), (8, 8, 5, 5, (2, 2)), (8, 8, 3, 3, (1, 1))]
    layers, num = {}, 0
    for o, i, kh, kw, _ in conv_specs:
        layers[num] = [(rng.standard_normal((o, i, kh, kw)) * 0.2).astype(np.float32),
                       rng.standard_normal((o,)).astype(np.float32)]
        num += 1
    for j, (fi, fo) in enumerate([(968, 1024), (1024, 1024), (1024, 42)]):
        layers[num] = [(rng.standard_normal((fi, fo)) / np.sqrt(fi)).astype(np.float32),
                       (rng.standard_normal((fo,)) * 0.1).astype(np.float32)]
        num += 1
        if j < 2:
            layers[num] = []  # dropout: no params
            num += 1
    x = rng.uniform(-1.0, 1.0, (2, 1, 128, 128)).astype(np.float32)
    y = x
    for (_, _, _, _, pool), n in zip(conv_specs, range(3)):
        y = _np_reference_convpool(y, layers[n][0], layers[n][1], pool)
    assert y.shape == (2, 8, 11, 11)
    y = y.reshape(2, -1)  # NCHW flatten order
    for j, n in enumerate([3, 5, 7]):
        y = y @ layers[n][0] + layers[n][1]
        if j < 2:
            y = np.maximum(y, 0.0)
    model = PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3)).eval()
    model.load_state_dict(poseregnet_state_dict_from_reference(layers))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), y, rtol=1e-4, atol=2e-4)


def test_bn_invstd_reference_formula():
    """The reference BatchNorm applies gamma * (x - mean) * inv_std + beta
    with inv_std = 1 / sqrt(var + 1e-4) (batchnormlayer.py:141-155); the
    importer's var' = inv_std^-2 - 1e-5 makes the port's BatchNorm (eps
    1e-5) reproduce it.  Held against the reference formula itself; and
    var -> inv_std -> var' comes back within float32 ulps."""
    rng = np.random.default_rng(5)
    c = 16
    mean = rng.uniform(-1, 1, c).astype(np.float32)
    var_ref = rng.uniform(0.2, 2.0, c).astype(np.float32)
    inv_std = (1.0 / np.sqrt(var_ref + 1e-4)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    x = rng.standard_normal((4, c, 7, 7)).astype(np.float32)
    want = (gamma[:, None, None] * (x - mean[:, None, None]) * inv_std[:, None, None]
            + beta[:, None, None])
    layers = {0: [beta, gamma, mean, inv_std]}
    bn = BatchNorm(c).eval()
    sd = {}
    for name, src in (("bias", 0), ("weight", 1), ("running_mean", 2)):
        sd[name] = torch.from_numpy(layers[0][src])
    sd["running_var"] = torch.from_numpy(1.0 / np.square(inv_std) - np.float32(1e-5))
    bn.load_state_dict(sd)
    with torch.no_grad():
        got = bn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = 1.0 / np.sqrt(sd["running_var"].numpy() + np.float32(1e-5))
    np.testing.assert_array_max_ulp(back.astype(np.float32), inv_std, maxulp=4)


def test_resnet_import_roundtrip(tmp_path):
    """The ResNet pickle mapping (the emission-order walk of BN/NL/Conv
    blocks and the projection shortcut, BN inv_std -> var, the head) on a
    small 9n+2 instance: the restored net reproduces the forward, and the
    JAX loader on the same pickle, through resnet_state_dict_from_flax,
    gives the same numbers exactly."""
    kw = dict(num_joints=1, n_dims=30, depth=11, stages=(8, 16, 16, 16, 16))
    model = _randomise(ResNet(ResNetConfig(**kw), generator=torch.Generator().manual_seed(0)), 7)
    state = reference_pickle_from_state_dict(model.state_dict(), "resnet")
    layers = load_reference_pickle(_dump(state, tmp_path / "resnet.pkl"))
    restored = resnet_state_dict_from_reference(layers, cfg=model.cfg)
    via_jax = convert.resnet_state_dict_from_flax(
        jref.resnet_params_from_reference(layers, cfg=FlaxResNetConfig(**kw)))
    _assert_same_sd(restored, via_jax)
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):  # through inv_std and back
            np.testing.assert_array_max_ulp(restored[k].numpy(), v.numpy(), maxulp=8)
        else:
            assert torch.equal(restored[k], v), k
    other = ResNet(model.cfg).eval()
    other.load_state_dict(restored)
    with torch.no_grad():
        np.testing.assert_allclose(other(_x(2, 3)).numpy(), model(_x(2, 3)).numpy(),
                                   rtol=1e-5, atol=1e-4)


def test_model_from_reference_pickle_infers_head(tmp_path):
    """A network_prior-style pickle (the decode appended, 4 denses): the head
    is inferred and the outputs match the source net."""
    src = PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, embedding=30,
                                      dropout=False),
                     generator=torch.Generator().manual_seed(3)).eval()
    path = _dump(reference_pickle_from_state_dict(src.state_dict(), "poseregnet"),
                 tmp_path / "network_prior.pkl")
    model, needs_prior = model_from_reference_pickle(path, "poseregnet")
    assert not needs_prior and not model.training
    assert (model.cfg.num_joints, model.cfg.n_dims, model.cfg.embedding) == (14, 3, 30)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (4, 1, 128, 128)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), src(x).numpy(), rtol=0, atol=1e-5)


def test_model_from_reference_pickle_flags_embedding_net(tmp_path):
    """A 3-dense, 30-D-output pickle is the pre-decode embedding net: the
    caller brings the PCA prior."""
    src = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, dropout=False))
    path = _dump(reference_pickle_from_state_dict(src.state_dict(), "poseregnet"),
                 tmp_path / "net.pkl")
    model, needs_prior = model_from_reference_pickle(path, "poseregnet")
    assert needs_prior
    assert model.cfg.num_joints * model.cfg.n_dims == 30


def test_model_from_reference_pickle_embedding_override(tmp_path, capsys):
    """A bare 42-dim output is ambiguous (NYU 14x3 direct regression or a
    non-default 42-D PCA embedding): the heuristic picks regression and
    warns, and out_is_embedding=True forces the embedding reading."""
    src = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=42, dropout=False))
    path = _dump(reference_pickle_from_state_dict(src.state_dict(), "poseregnet"),
                 tmp_path / "net42.pkl")
    model, needs_prior = model_from_reference_pickle(path, "poseregnet")
    assert not needs_prior and model.cfg.num_joints == 14
    assert "WARNING" in capsys.readouterr().out
    model, needs_prior = model_from_reference_pickle(path, "poseregnet",
                                                     out_is_embedding=True)
    assert needs_prior
    assert model.cfg.num_joints == 1 and model.cfg.n_dims == 42


def test_out_is_embedding_false_rejects_non_multiple_of_3(tmp_path):
    """out_is_embedding=False with an out % 3 != 0 head is an impossible
    direct-regression net: it fails at the override, not later as a
    reshape error."""
    src = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=40, dropout=False))
    path = _dump(reference_pickle_from_state_dict(src.state_dict(), "poseregnet"),
                 tmp_path / "net40.pkl")
    with pytest.raises(ValueError, match="multiple-of-3"):
        model_from_reference_pickle(path, "poseregnet", out_is_embedding=False)
    _, needs_prior = model_from_reference_pickle(path, "poseregnet")
    assert needs_prior
    with pytest.raises(ValueError, match="unknown family"):
        model_from_reference_pickle(path, "scalenet")


def test_resnet_network_prior_pickle_at_full_width(tmp_path):
    """ResNet-47 type 0 with the PCA decode appended, as the reference mains
    save network_prior.pkl: model_from_reference_pickle('resnet') infers 14
    joints behind a 30-D embedding and gives the source net's decoded pose
    within rtol 1e-4."""
    src = _randomise(ResNet(ResNetConfig(num_joints=1, n_dims=30),
                            generator=torch.Generator().manual_seed(4)), 4)
    rng = np.random.default_rng(6)
    prior = PCAPrior(rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
                     rng.standard_normal(42).astype(np.float32) * 0.1)
    path = _dump(reference_pickle_from_state_dict(src.state_dict(), "resnet", decode=prior),
                 tmp_path / "network_prior.pkl")
    model, needs_prior = model_from_reference_pickle(path, "resnet")
    assert not needs_prior and isinstance(model, ResNet)
    assert (model.cfg.num_joints, model.cfg.n_dims, model.cfg.embedding) == (14, 3, 30)
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, (2, 1, 128, 128)).astype(np.float32))
    with torch.no_grad():
        got = model(x).numpy()
        want = prior.inverse_transform(src(x)).numpy()
    # the randomised statistics leave 61 BatchNorms unnormalised and the
    # pose large: the variances' round trip through inv_std (a few ulps each)
    # and the decode as a Linear move it by parts in 1e5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_jax_resnet_variables_convert_exactly():
    """resnet_state_dict_from_flax maps every flax leaf once: a flax
    ResNet's variables and the port's state_dict hold the same numbers."""
    from deepprior_tpu.models import ResNet as FlaxResNet

    kw = dict(num_joints=1, n_dims=30, depth=11, stages=(8, 8, 16, 32, 32), hidden=32)
    variables = jax.eval_shape(FlaxResNet(FlaxResNetConfig(**kw)).init, jax.random.key(0),
                               np.zeros((1, 128, 128, 1), np.float32))
    leaves = jax.tree.leaves(variables)
    sd = convert.resnet_state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), variables))
    assert sum(t.numel() for t in sd.values()) == sum(int(np.prod(s.shape)) for s in leaves)
    assert len(sd) == len(leaves)
    model = ResNet(ResNetConfig(**kw))
    assert set(sd) == set(model.state_dict())
