"""The port's ResNet and BatchNorm against the flax ones, on the CPU.

A small ResNet (depth 11, stages (8, 8, 16, 32, 32): stage 4's first block
keeps the identity path's stride quirk, hidden 32, 128x128 input) gets
flax variables drawn from a seed, its biases, BatchNorm parameters and
statistics away from 0 / 1 so that every leaf matters, converted with
resnet_state_dict_from_flax.  Tolerances:
- forward in eval and train mode (no dropout): rtol 1e-4, atol 1e-5 (the
  conv and dense sums run in another order);
- running statistics after train-mode calls: rtol 1e-5, atol 1e-7 for
  the means near 0, where the conv sums' order shows (BatchNorm2d's own
  update, which stores the unbiased variance, misses it);
- bf16 compute against flax's bf16: rtol and atol 5e-2, as
  test_torch_models.py holds PoseRegNet's;
- three ``Trainer._train_step_core`` steps against the JAX step, both in
  float64, at test_torch_train.py's tolerances with the running statistics
  at rtol 1e-4 and the update itself held, and the port's float32 steps
  against its float64 ones at the same bounds.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepprior_tpu import prior as jprior
from deepprior_tpu.camera import NYU_CAMERA as J_NYU
from deepprior_tpu.data.synthetic import make_sequence as j_make_sequence
from deepprior_tpu.models import ResNet as FlaxResNet
from deepprior_tpu.models import ResNetConfig as FlaxConfig
from deepprior_tpu.ops.augment import sample_augment_params
from deepprior_tpu.train import trainer as jtrainer
from deepprior_tpu.utils.flops import xla_flops

from deepprior_tpu_torch import prior as tprior
from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.models import ResNet, ResNetConfig
from deepprior_tpu_torch.models.layers import BatchNorm
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer, _l2_penalty
from deepprior_tpu_torch.utils.convert import resnet_state_dict_from_flax, train_state_from_flax
from deepprior_tpu_torch.utils.flops import model_flops

SMALL = dict(depth=11, stages=(8, 8, 16, 32, 32), hidden=32)


def _crops(n, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 128, 128)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax_variables(seed):
    """Variables of the small flax ResNet's shapes (``jax.eval_shape``: no
    init runs, which takes seconds eagerly), drawn from ``seed``: He-normal
    kernels, and biases, BatchNorm parameters and statistics away from
    their initial 0 / 1, so that a wrong mapping of any of them shows."""
    model = FlaxResNet(FlaxConfig(num_joints=1, n_dims=30, **SMALL))
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            v = rng.standard_normal(x.shape) * np.sqrt(2.0 / fan_in)
        elif "'var'" in name:
            v = rng.uniform(0.5, 1.5, x.shape)
        else:
            v = rng.uniform(-0.2, 0.2, x.shape) + ("'scale'" in name)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_pair(seed=0, bf16=False):
    """(flax model, its variables as numpy, the port's model) on the same
    weights and statistics."""
    cfg = dict(num_joints=1, n_dims=30, **SMALL)
    flax_model = FlaxResNet(FlaxConfig(**cfg, **({"dtype": jnp.bfloat16} if bf16 else {})))
    variables = _flax_variables(seed)
    model = ResNet(ResNetConfig(**cfg, **({"dtype": torch.bfloat16} if bf16 else {})))
    model.load_state_dict(resnet_state_dict_from_flax(variables), strict=True)
    return flax_model, variables, model


def test_small_config_keeps_the_stage4_quirk():
    _, variables, model = make_pair()
    # stage 1 (8 == 8) and stage 4 (32 == 32) take the identity path: the
    # trunk halves twice after the stem's pool, 128 / 2 / 4 = 16
    assert [b.identity for b in model.blocks] == [True, False, False, True]
    assert model.head.dense[0].in_features == 32 * 16 * 16
    assert np.asarray(variables["params"]["Dense_0"]["kernel"]).shape[0] == 32 * 16 * 16


def test_eval_forward_matches_flax():
    flax_model, variables, model = make_pair()
    x = _crops(3)
    want = flax_model.apply(variables, x[..., None], train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)[:, None])
    assert got.dtype == torch.float32 and got.shape == (3, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_train_forward_and_running_stats_match_flax():
    """Two train-mode calls: the outputs, and the running statistics flax
    keeps in batch_stats (the biased batch variance, momentum 0.9)."""
    flax_model, variables, model = make_pair()
    model.train()
    for seed in (2, 3):
        x = _crops(3, seed)
        want, upd = flax_model.apply(variables, x[..., None], train=True,
                                     mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        with torch.no_grad():
            got = model(torch.from_numpy(x)[:, None])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want_sd = resnet_state_dict_from_flax(jax.tree.map(np.asarray, variables))
    got_sd = model.state_dict()
    names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (3 * 4 + 1)
    for k in names:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_batchnorm_matches_flax_and_not_batchnorm2d():
    """One layer, two train-mode calls, then eval: the forward agrees with
    flax's BatchNorm, and so do the running statistics; nn.BatchNorm2d's own
    update (the unbiased variance, n / (n - 1) larger) does not."""
    rng = np.random.default_rng(4)
    c = 6
    xs = [(rng.standard_normal((2, 7, 7, c)) * rng.uniform(0.5, 3.0, c)
           + rng.uniform(-2, 2, c)).astype(np.float32) for _ in range(2)]
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jax.tree.map(np.asarray, flax_bn.init(jax.random.key(0), xs[0]))
    ours = BatchNorm(c).train()
    theirs = torch.nn.BatchNorm2d(c, eps=1e-5, momentum=0.1).train()
    for x in xs:
        want, upd = flax_bn.apply(variables, x, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        with torch.no_grad():
            got = ours(xt)
            theirs(xt)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(ours.running_mean.numpy(), stats["mean"], rtol=1e-5)
    np.testing.assert_allclose(ours.running_var.numpy(), stats["var"], rtol=1e-5)
    assert not np.allclose(theirs.running_var.numpy(), stats["var"], rtol=1e-5, atol=0)
    assert "num_batches_tracked" not in ours.state_dict()
    x = xs[0]
    want = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(variables, x)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_bf16_matches_flax_bf16():
    """Eval mode against flax's bf16; a train-mode call keeps the parameters
    and the statistics float32 (in train mode the batch statistics of bf16
    maps amplify each framework's own rounding: both sit 0.06-0.07 from
    float32 at this size, so the pair is not held to 5e-2 there)."""
    flax_model, variables, model = make_pair(bf16=True)
    x = _crops(2, 5)
    want = flax_model.apply(variables, x[..., None], train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)[:, None])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)
    with torch.no_grad():
        out = model.train()(torch.from_numpy(x)[:, None])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 and torch.isfinite(b).all()
               for b in model.buffers())


def test_full_width_structure_and_flops():
    """ResNet-47 type 0 with 30 outputs: FC1 reads 256 x 8 x 8 = 16,384
    features, 18,713,150 parameters (the flax model's count), and
    FlopCounterMode reads 249,622,528 flops per frame (2 x MAC of its 64
    convs and 3 dense layers), where XLA's cost analysis of the JAX model
    counts 245,840,544."""
    model = ResNet(ResNetConfig(num_joints=1, n_dims=30),
                   generator=torch.Generator().manual_seed(0))
    assert tuple(model.head.dense[0].weight.shape) == (1024, 16384)
    assert sum(p.numel() for p in model.parameters()) == 18_713_150
    assert len(model.blocks) == 20
    assert sum(isinstance(m, torch.nn.Conv2d) for m in model.modules()) == 64
    with torch.no_grad():
        flops = model_flops(model.eval(), torch.zeros((1, 1, 128, 128)))
    assert flops == 249_622_528
    flax_model = FlaxResNet(FlaxConfig(num_joints=1, n_dims=30))
    x = jax.ShapeDtypeStruct((1, 128, 128, 1), jnp.float32)
    variables = jax.eval_shape(flax_model.init, jax.random.key(0), x)
    assert xla_flops(lambda v, x: flax_model.apply(v, x), variables, x) == 245_840_544


def _flax_variables_from_state_dict(sd, num_blocks):
    """The inverse of resnet_state_dict_from_flax (numpy leaves)."""
    sd = {k: v.numpy() for k, v in sd.items()}

    def conv(pfx):
        return {"kernel": sd[f"{pfx}.weight"].transpose(2, 3, 1, 0), "bias": sd[f"{pfx}.bias"]}

    def bn(pfx):
        return ({"scale": sd[f"{pfx}.weight"], "bias": sd[f"{pfx}.bias"]},
                {"mean": sd[f"{pfx}.running_mean"], "var": sd[f"{pfx}.running_var"]})

    params, stats = {"Conv_0": conv("stem")}, {}
    for i in range(num_blocks):
        bp, bs = {}, {}
        for j in range(3):
            bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"] = bn(f"blocks.{i}.bn{j}")
            bp[f"Conv_{j}"] = conv(f"blocks.{i}.conv{j}")
        if f"blocks.{i}.shortcut.weight" in sd:
            bp["Conv_3"] = conv(f"blocks.{i}.shortcut")
        params[f"_Bottleneck_{i}"], stats[f"_Bottleneck_{i}"] = bp, bs
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("bn")
    c = sd["bn.weight"].shape[0]
    i = 0
    while f"head.dense.{i}.weight" in sd:
        kern = sd[f"head.dense.{i}.weight"].T
        if i == 0:  # NCHW rows -> NHWC rows
            side = int(round((kern.shape[0] // c) ** 0.5))
            kern = kern.reshape(c, side, side, -1).transpose(1, 2, 0, 3).reshape(
                kern.shape[0], -1)
        params[f"Dense_{i}"] = {"kernel": kern, "bias": sd[f"head.dense.{i}.bias"]}
        i += 1
    return {"params": params, "batch_stats": stats}


def test_full_width_bf16_gap_is_flax_bf16_gap():
    """The bf16 serving net's distance from float32 at full width, with flax
    as the witness: load_serving_net('resnet') (random weights from its
    seed) calibrated on the crops of 16 NYU frames, in float32 and bf16,
    and the flax ResNet-47 on the same variables in float32 and bf16, all
    through one FusedEstimator on the CPU.  The float32 joints agree within
    0.01 mm; the port's bf16 joints are no further from its float32 ones
    than 1.5x flax's bf16 joints are from flax's float32 ones (24.95 and
    22.17 mm at a 130 mm pose extent here), so the gap is the random net's
    amplification of bf16 rounding, which flax shows too, not the port's."""
    from deepprior_tpu_torch.camera import NYU_CAMERA as CAM
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models.layers import calibrate_batchnorm
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    rng = np.random.default_rng(27)
    depth, com = (torch.from_numpy(np.stack(a))
                  for a in zip(*[make_depth_frame(CAM, rng) for _ in range(16)]))
    net32, prior = load_serving_net("resnet", device="cpu")
    crops = FusedEstimator(net32, CAM, prior=prior, device="cpu")(depth, com)[2]
    calibrate_batchnorm(net32, crops[:, None])
    net16 = ResNet(net32.cfg._replace(dtype=torch.bfloat16))
    net16.load_state_dict(net32.state_dict())
    variables = _flax_variables_from_state_dict(net32.state_dict(), len(net32.blocks))
    back = resnet_state_dict_from_flax(variables)
    assert all(torch.equal(back[k], v) for k, v in net32.state_dict().items())

    class FlaxNet(torch.nn.Module):
        def __init__(self, dtype):
            super().__init__()
            self.anchor = torch.nn.Parameter(torch.zeros(()))  # the estimator's device
            model = FlaxResNet(FlaxConfig(num_joints=1, n_dims=30, dtype=dtype))
            self.apply_fn = jax.jit(lambda v, x: model.apply(v, x, train=False))

        def forward(self, x):
            out = self.apply_fn(variables, x.numpy().transpose(0, 2, 3, 1))
            return torch.from_numpy(np.array(out, np.float32))

    joints = {}
    with torch.no_grad():
        for name, net in (("port32", net32), ("port16", net16),
                          ("flax32", FlaxNet(jnp.float32)), ("flax16", FlaxNet(jnp.bfloat16))):
            joints[name], com3d, _ = FusedEstimator(net, CAM, prior=prior, device="cpu")(
                depth, com)

    def gap(a, b):
        return (joints[a] - joints[b]).abs().max().item()

    extent = (joints["port32"] - com3d[:, None]).abs().max().item()
    print(f"pose extent {extent:.4f} mm; bf16 - float32: port {gap('port16', 'port32'):.4f}, "
          f"flax {gap('flax16', 'flax32'):.4f} mm; port - flax: float32 "
          f"{gap('port32', 'flax32'):.6f}, bf16 {gap('port16', 'flax16'):.4f} mm")
    assert gap("port32", "flax32") <= 0.01
    assert gap("port16", "port32") <= 1.5 * gap("flax16", "flax32")


@pytest.mark.parametrize("rtype", range(5))
def test_from_reference_type_matches_jax(rtype):
    want = FlaxConfig.from_reference_type(rtype, num_joints=1, n_dims=30)
    got = ResNetConfig.from_reference_type(rtype, num_joints=1, n_dims=30)
    for field in ("num_joints", "n_dims", "depth", "stages", "dropout", "embedding",
                  "hidden"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.out_dim == want.out_dim == 30


def test_calibrate_batchnorm():
    """calibrate_batchnorm gives each layer its input's batch statistics: the
    calibrated eval-mode forward is the train-mode one.  At full width the
    random serving net (load_serving_net('resnet'), statistics 0 / 1) puts
    the pose thousands of mm from the CoM; calibrated on the frames' crops,
    hundreds."""
    from deepprior_tpu_torch.camera import NYU_CAMERA as CAM
    from deepprior_tpu_torch.data.synthetic import make_depth_frame
    from deepprior_tpu_torch.mains.common import load_serving_net
    from deepprior_tpu_torch.models.layers import calibrate_batchnorm
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    model = ResNet(ResNetConfig(num_joints=1, n_dims=30, **SMALL),
                   generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_crops(3))[:, None]
    calibrate_batchnorm(model, x)
    assert not model.training
    with torch.no_grad():
        calibrated = model(x)
        torch.testing.assert_close(model.train()(x), calibrated, rtol=1e-4, atol=1e-5)

    rng = np.random.default_rng(0)
    depth, com = (np.stack(a) for a in zip(*[make_depth_frame(CAM, rng) for _ in range(4)]))
    net, prior = load_serving_net("resnet", device="cpu")
    est = FusedEstimator(net, CAM, prior=prior, device="cpu")
    joints, com3d, crops = est(depth, com)
    assert (joints - com3d[:, None]).abs().max() > 5000.0
    calibrate_batchnorm(net, crops[:, None])
    joints, com3d, _ = est(depth, com)
    assert (joints - com3d[:, None]).abs().max() < 1000.0


def test_reset_parameters_resets_batchnorm():
    model = ResNet(ResNetConfig(num_joints=1, n_dims=30, **SMALL))
    model.train()(torch.from_numpy(_crops(2))[:, None])
    assert not torch.equal(model.bn.running_var, torch.ones_like(model.bn.running_var))
    model.reset_parameters(torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
        elif isinstance(m, torch.nn.Conv2d):
            assert not m.bias.any() and m.weight.std() > 0


B = 8


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, JAX state, port trainer, data) on one dropout-free
    small ResNet type 0, its biases and statistics randomised."""
    data = jtrainer.TrainData.from_sequence(j_make_sequence(J_NYU, 13, seed=7))
    jp = jprior.fit_pose_prior(J_NYU, np.random.default_rng(2), data.gt3d_crop,
                               data.com, data.cube, num_poses=3000)
    flax_model, variables, _ = make_pair(3)
    cfg = dict(batch_size=B, aug_modes=("com", "rot", "sc", "none"),
               model_has_dropout=False)
    jt = jtrainer.Trainer(flax_model, jtrainer.TrainConfig(**cfg), J_NYU, prior=jp)
    params = jax.tree.map(jnp.asarray, variables["params"])
    # init_state's fresh optimizer on these variables (its flax init is slow)
    jstate = jtrainer.TrainState(params=params,
                                 batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                 opt_state=jt.tx.init(params), step=jnp.zeros((), jnp.int32))
    tt = Trainer(ResNet(ResNetConfig(num_joints=1, n_dims=30, **SMALL)),
                 TrainConfig(**cfg), NYU_CAMERA,
                 prior=tprior.PCAPrior(jp.components, jp.mean), device="cpu")
    return jt, jstate, tt, data


def _three_steps(trainer, state, data, lr, jax_pair=None):
    """Three ``_train_step_core`` steps on rows step..step+B of ``data`` with
    the augmentation JAX's sample_augment_params draws from the keys the
    JAX step uses; with ``jax_pair`` (JAX trainer, state) the JAX steps too.
    Returns (state, losses, JAX state, JAX losses)."""
    tdata = TrainData(*data).to("cpu")
    jstep = jtstate = None
    if jax_pair is not None:
        jstep, jtstate = jax.jit(jax_pair[0]._train_step_core), jax_pair[1]
    losses, jlosses = [], []
    for step in range(3):
        idx = np.arange(step, step + B) % data.n
        aug_key = jax.random.key(100 + step)
        params = [np.array(a) for a in sample_augment_params(aug_key, B, 4)]
        state, loss = trainer._train_step_core(state, tdata.take(torch.from_numpy(idx)),
                                               params, None, lr)
        losses.append(float(loss))
        if jstep is not None:
            jbatch = {k: jnp.asarray(getattr(data, k)[idx])
                      for k in ("crops", "gt3d_crop", "com", "cube", "m")}
            jtstate, jloss = jstep(jtstate, jbatch, aug_key, jax.random.key(7), lr)
            jlosses.append(float(jloss))
    return state, losses, jtstate, jlosses


LR = float(np.float32(1e-4))


def test_train_steps_match_jax(pair):
    """Three steps of the JAX trainer and of the port from the same
    variables, both computing in float64 (``jax.enable_x64`` and a float64
    flax model beside the port's float64 ResNet, whose parameters stay
    float32): losses rtol 1e-4, 99.9% of the parameters within rtol 1e-4
    (test_torch_train.py's bounds for PoseRegNet) and the running
    statistics within rtol 1e-4.  In float32 the JAX step's own error
    (flax's fast variance cancels over the crops' constant background) is
    larger than these bounds; test_train_steps_match_float64 holds the
    port's float32 steps to its float64 ones.

    The update itself is held too: Adam's first steps move a weight by
    about lr, so the parameters' change over the three steps, the port's
    against the JAX one, agrees within 1% of its norm, and within 1% of the
    largest change in every tensor that moved by more than lr (a conv bias
    in front of a train-mode BatchNorm has a zero gradient up to rounding
    and stays put).  A skipped or reversed update fails both."""
    jt, jstate, tt, data = pair
    flax_sd = (jax.tree.map(np.asarray, jstate.params),
               jax.tree.map(np.asarray, jstate.batch_stats))
    with jax.enable_x64(True):
        flax64 = FlaxResNet(FlaxConfig(num_joints=1, n_dims=30, dtype=jnp.float64, **SMALL))
        jt64 = jtrainer.Trainer(flax64, jt.cfg, J_NYU, prior=jt.prior)
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
                         for v in flax_sd)
        j64 = jtrainer.TrainState(params=params, batch_stats=stats,
                                  opt_state=jt64.tx.init(params),
                                  step=jnp.zeros((), jnp.int32))
        t64 = Trainer(ResNet(ResNetConfig(num_joints=1, n_dims=30, dtype=torch.float64,
                                          **SMALL)), tt.cfg, NYU_CAMERA, prior=tt.prior,
                      device="cpu")
        tstate = train_state_from_flax(t64, *flax_sd)
        start = {k: v.clone() for k, v in tstate.model.state_dict().items()}
        tstate, tl, j64, jl = _three_steps(t64, tstate, data, LR, (jt64, j64))
    print("loss trace JAX", jl, "port", tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tstate.step == 3 and int(j64.step) == 3
    want = resnet_state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": j64.params, "batch_stats": j64.batch_stats}))
    ours = tstate.model.state_dict()
    assert set(ours) == set(want)
    n_tot = n_close = n_moved = 0
    d_err = d_norm = 0.0
    for k, w in want.items():
        a, b = ours[k].double().numpy(), w.double().numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)
            continue
        n_tot += a.size
        n_close += int(np.isclose(a, b, rtol=1e-4, atol=1e-7).sum())
        d_ours, d_jax = a - start[k].double().numpy(), b - start[k].double().numpy()
        d_err += float(np.square(d_ours - d_jax).sum())
        d_norm += float(np.square(d_jax).sum())
        if np.abs(d_jax).max() > LR:
            n_moved += 1
            assert np.abs(d_ours - d_jax).max() <= 1e-2 * np.abs(d_jax).max(), k
    print(f"{n_close} of {n_tot} params within rtol 1e-4; {n_moved} tensors moved; "
          f"update error {np.sqrt(d_err / d_norm):.3g} of its norm")
    assert n_close >= 0.999 * n_tot
    assert n_moved >= len(want) // 2
    assert np.sqrt(d_err) <= 1e-2 * np.sqrt(d_norm)


def test_train_steps_match_float64(pair):
    """The same three steps computed in float64 (BatchNorm promotes its
    statistics to at least float32, as flax does, so a float64 model is
    float64 throughout): the port's float32 losses within rtol 1e-4 (as
    test_torch_train.py holds PoseRegNet's against JAX), 99.9% of its
    parameters within rtol 1e-4, and its running variances within rtol
    1e-4.  The JAX step's float32 losses are up to 3e-4 off the float64
    ones here."""
    jt, jstate, tt, data = pair
    flax_sd = (jax.tree.map(np.asarray, jstate.params),
               jax.tree.map(np.asarray, jstate.batch_stats))
    t64 = Trainer(ResNet(ResNetConfig(num_joints=1, n_dims=30, dtype=torch.float64,
                                      **SMALL)), tt.cfg, NYU_CAMERA, prior=tt.prior,
                  device="cpu")
    s32, l32, _, _ = _three_steps(tt, train_state_from_flax(tt, *flax_sd), data, LR)
    s64, l64, _, _ = _three_steps(t64, train_state_from_flax(t64, *flax_sd), data, LR)
    print("float64", l64, "port float32 rel", np.abs(np.subtract(l32, l64)) / l64)
    np.testing.assert_allclose(l32, l64, rtol=1e-4)
    sd32, sd64 = s32.model.state_dict(), s64.model.state_dict()
    n_tot = n_close = 0
    for k in sd32:
        a, b = sd32[k].numpy(), sd64[k].numpy()
        if k.endswith("running_var"):
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)
        elif not k.endswith("running_mean"):
            np.testing.assert_allclose(a, b, atol=2 * LR * 3, rtol=0, err_msg=k)
            n_tot += a.size
            n_close += int(np.isclose(a, b, rtol=1e-4, atol=1e-7).sum())
    print(f"{n_close} of {n_tot} params within rtol 1e-4 of float64")
    assert n_close >= 0.999 * n_tot


def test_l2_penalty_leaves_batchnorm_out(pair):
    jt, jstate, tt, _ = pair
    tstate = train_state_from_flax(tt, jax.tree.map(np.asarray, jstate.params),
                                   jax.tree.map(np.asarray, jstate.batch_stats))
    want = float(jtrainer._l2_penalty(jstate.params))
    with torch.no_grad():
        got = float(_l2_penalty(tstate.model))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluate_and_predict_use_running_stats(pair):
    jt, jstate, tt, data = pair
    tstate = train_state_from_flax(tt, jax.tree.map(np.asarray, jstate.params),
                                   jax.tree.map(np.asarray, jstate.batch_stats))
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    want = jt.evaluate(jstate, data)
    got = tt.evaluate(tstate, TrainData(*data))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    pw = jt.predict(jstate, data.crops, batch_size=5)
    pg = tt.predict(tstate, data.crops, batch_size=5)
    np.testing.assert_allclose(pg, pw, rtol=1e-4, atol=1e-5)
    after = tstate.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
