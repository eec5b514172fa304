"""The 'sp' axis of the port (deepprior_tpu_torch/parallel/spatial.py, the
halo exchange and the sp gather of parallel/collectives.py, and the sp path
of DistributedTrainer) on the CPU.

- The layout arithmetic: PoseRegNet's row blocks at sp = 2 and 4 (the
  worked example: 31 pooled rows as 16 + 15, then 13 as 7 + 6 with rows
  14-17 crossing, then 11 as 6 + 5 with one halo row each way); ResNet's
  and ScaleNet's blocks non-empty and pool-aligned; sp = 16 on PoseRegNet
  raises.
- The split forward and backward in one process: each sp rank a thread,
  the exchange's all-reduce replaced by the threads handing each other
  their rows.  For the three trunks against the whole trunk: outputs
  within 1e-12 in float64 and 1e-5 in float32; the trunk's gradients
  summed over the ranks and the head's (whole on every rank) within rtol
  1e-4 (atol 1e-6 of the largest gradient, for the biases before a
  BatchNorm whose gradient is 0 up to rounding); ResNet's running
  statistics within 1e-12 / 1e-6.
- One 4-rank gloo spawn at dp x sp x tp = 1 x 2 x 2, against the port's
  plain Trainer on the same seeds: PoseRegNet (hidden 64) loss traces
  within rtol 1e-4; the gradients of one step under ADAM and under
  sgd_momentum, with weight decay, within rtol 1e-4, for PoseRegNet and
  ScaleNet; a depth-11 ResNet (BatchNorm statistics and running buffers
  within 1e-5); ScaleNet; the augmented epoch (com/rot/none, dropout,
  hidden 512 so that tp splits the head); evaluate/predict; one
  sharded-snapshot resume bit for bit; and the JAX DistributedTrainer on
  make_mesh(n_devices=4, dp=1, sp=2, tp=2) within rtol 1e-3
  (tests/test_parallel.py:103-128's bound) for PoseRegNet, the ResNet and
  ScaleNet.
"""

import os
import threading

import numpy as np
import pytest
import torch

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_sequence
from deepprior_tpu_torch.models import (
    PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig, ScaleNet, ScaleNetConfig)
from deepprior_tpu_torch.models.layers import BatchNorm
from deepprior_tpu_torch.parallel import collectives, spatial
from deepprior_tpu_torch.parallel.multihost import spawn_cpu
from deepprior_tpu_torch.prior import fit_pose_prior
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

B = 16
CFG = TrainConfig(batch_size=B, learning_rate=0.003, n_epochs=2, use_early_stopping=False)
PLAIN_CFG = CFG._replace(aug_modes=None, model_has_dropout=False, weightreg_factor=1e-3)
# the ResNet legs compute in float64: a BatchNorm after the stem cancels the
# stem's weight gradient over the crops' flat background to a few 1e-4 of
# its terms, so float32 sums in two orders differ there by more than rtol
# 1e-4 (measured 7.6e-4 of the largest entry); and ADAM's first steps are
# sign-like, moving a weight whose gradient is rounding noise (a bias before
# a BatchNorm) by up to lr either way, so the ResNet fit takes sgd_momentum
RES_CFG = PLAIN_CFG._replace(optimizer="sgd_momentum")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(hidden=64, dropout=False, dtype=torch.float32):
    return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=hidden,
                                       dropout=dropout, dtype=dtype))


def _resnet(dtype=torch.float32):
    return ResNet(ResNetConfig(num_joints=1, n_dims=30, depth=11, stages=(8, 16, 16, 16, 16),
                               hidden=32, dtype=dtype))


def _scalenet(dtype=torch.float32, shared=False):
    return ScaleNet(ScaleNetConfig(hidden=32, dropout=False, shared_conv=shared, dtype=dtype))


# --------------------------------------------------------------- layout
def test_poseregnet_layout_worked_example():
    """The three ConvPool layers of PoseRegNet over 2 sp ranks: the row
    blocks of each pooled output and the input rows each reads."""
    from deepprior_tpu_torch.models import poseregnet

    convs = [(k, p) for _, (k, _), (p, _) in poseregnet._TRUNK]
    l1, l2, l3 = spatial.chain_layout(128, convs, 2)
    assert (l1.h_out, l1.out, l1.need, l1.own_in) == (31, ((0, 16), (16, 31)),
                                                      ((0, 68), (64, 128)), None)
    assert (l2.h_out, l2.out, l2.need) == (13, ((0, 7), (7, 13)), ((0, 18), (14, 30)))
    # rank 1 takes rows 14-15 from rank 0 and drops its row 30 (the floor
    # pool's dropped conv row 26 reads no further); rank 0 takes 16-17
    assert (l2.lo, l2.hi) == ((0, 2), (2, -1))
    assert (l3.h_out, l3.out, l3.need) == (11, ((0, 6), (6, 11)), ((0, 8), (6, 13)))
    assert (l3.lo, l3.hi) == ((0, 1), (1, 0))
    assert [layer.halo_rows(r) for layer in (l1, l2, l3) for r in (0, 1)] == [0, 0, 2, 2, 1, 1]
    l1, l2, l3 = spatial.chain_layout(128, convs, 4)
    assert l1.out == ((0, 8), (8, 16), (16, 24), (24, 31))
    assert l2.out == ((0, 4), (4, 7), (7, 10), (10, 13))
    assert (l2.lo, l2.hi) == ((0, 0, 2, 4), (4, 2, 0, -1))
    assert l3.out == ((0, 3), (3, 6), (6, 9), (9, 11))
    with pytest.raises(ValueError, match="do not split over 16 sp ranks"):
        spatial.chain_layout(128, convs, 16)


@pytest.mark.parametrize("size", [2, 4])
def test_resnet_and_scalenet_layouts(size):
    """ResNet-47's blocks start at even rows (every stride-2 projection reads
    only its rank's rows) and cover each map; each 3x3 convolution takes one
    row each way; every ScaleNet tower's blocks are non-empty and cover its
    pooled rows."""
    plan = spatial.plan_for(ResNet(ResNetConfig(num_joints=1, n_dims=30)),
                            spatial.SpatialContext(None, 0, size))
    (stem, *blocks), = plan.layers
    assert stem.out == spatial.split_rows(64, size) and stem.own_in is None
    assert stem.need[0][0] == -2 and stem.need[-1][1] == 130
    assert len(blocks) == 20
    for block in blocks:
        assert all(a % 2 == 0 and b > a for a, b in block.out)
        assert block.out[0][0] == 0 and block.out[-1][1] == block.h_in
        assert set(block.lo) == {1} and set(block.hi) == {1}
    assert blocks[-1].out == spatial.split_rows(8, size)
    plan = spatial.plan_for(ScaleNet(), spatial.SpatialContext(None, 0, size))
    for layers, side in zip(plan.layers, (11, 11, 8)):
        assert layers[-1].h_out == side
        for layer in layers:
            assert layer.out[0][0] == 0 and layer.out[-1][1] == layer.h_out
            assert all(b > a for a, b in layer.out)


# ---------------------------------------------------- one process, threads
class _Threads:
    """sp ranks as threads of this process: each collective call hands every
    rank the others' tensors (the test's stand-in for the all-reduce)."""

    def __init__(self, n):
        self.barrier, self.box, self.local = threading.Barrier(n), [None] * n, threading.local()

    def stack(self, x):
        self.box[self.local.rank] = x.detach().clone()
        self.barrier.wait()
        out = torch.stack(self.box)
        self.barrier.wait()
        return out


@pytest.fixture
def threads(monkeypatch):
    """The collectives of the sp path between ``_Threads`` ranks."""

    def gather_slots(x, context):
        return context.group.stack(x)

    def sum_(x, groups):
        for g in groups:
            x.copy_(g.stack(x).sum(0))
        return x

    monkeypatch.setattr(collectives, "_gather_slots", gather_slots)
    monkeypatch.setattr(collectives, "_sum_", sum_)
    monkeypatch.setattr(collectives, "_rank_and_size", lambda g: (g.local.rank, len(g.box)))


def _split_run(make, x, size, w):
    """Every sp rank's (output, gradients, state dict) of a ``make()`` model
    in training mode on x, the loss sum(out * w)."""
    group, res, errors = _Threads(size), [None] * size, []

    def rank(r):
        try:
            group.local.rank = r
            torch.set_num_threads(1)
            m = make().train()
            spatial.attach(m, spatial.SpatialContext(group, r, size))
            for mod in m.modules():
                if isinstance(mod, BatchNorm):
                    mod.groups = (group,)
            out = m(x)
            (out * w).sum().backward()
            res[r] = (out.detach(), {n: p.grad for n, p in m.named_parameters()},
                      m.state_dict())
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            group.barrier.abort()

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(size)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return res


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", ["poseregnet", "resnet", "scalenet", "scalenet_shared"])
def test_split_trunk_matches_whole(threads, family, dtype, size):
    make = {"poseregnet": lambda: _pose(dtype=dtype), "resnet": lambda: _resnet(dtype),
            "scalenet": lambda: _scalenet(dtype),
            "scalenet_shared": lambda: _scalenet(dtype, shared=True)}[family]
    torch.manual_seed(0)
    x = torch.randn(3, 1, 128, 128, dtype=dtype)
    whole = make().to(dtype).train()
    sd0 = {k: v.clone() for k, v in whole.state_dict().items()}
    out = whole(x)
    w = torch.linspace(-1.0, 1.0, out.numel(), dtype=dtype).view_as(out)
    (out * w).sum().backward()

    def fresh():
        m = make().to(dtype)
        m.load_state_dict(sd0)
        return m

    res = _split_run(fresh, x, size, w)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for r in range(size):
        np.testing.assert_allclose(res[r][0].numpy(), out.detach().numpy(), rtol=0,
                                   atol=tol * float(out.detach().abs().max()))
    grads = {n: p.grad for n, p in whole.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, want in grads.items():
        got = res[0][1][n] if n.startswith("head.") else sum(rr[1][n] for rr in res)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=n)
    for k, v in whole.state_dict().items():
        if "running" in k:
            for rr in res:
                np.testing.assert_allclose(rr[2][k].numpy(), v.numpy(), rtol=0,
                                           atol=1e-12 if dtype == torch.float64 else 1e-6,
                                           err_msg=k)


def test_split_batchnorm_is_exact_on_a_flat_background(threads):
    """BatchNorm over two ranks' blocks of rows, float32, on maps of mean
    10 and spread 0.01 (a crop's flat background): the output and the
    gradients of the input, the scale and the bias within 1e-3 of one
    device's ``F.batch_norm``.  The fast variance E[x^2] - E[x]^2 is 18%
    off here in float32; the ranks' centred sums are within 5e-7."""
    torch.manual_seed(0)
    x = 10.0 + 0.01 * torch.randn(4, 3, 16, 8)
    w = torch.randn_like(x)
    whole = BatchNorm(3).train()
    xw = x.clone().requires_grad_(True)
    out = whole(xw)
    (out * w).sum().backward()
    group, res, errors = _Threads(2), [None] * 2, []

    def rank(r):
        try:
            group.local.rank = r
            bn = BatchNorm(3).train()
            bn.groups = (group,)
            xr = x[..., 8 * r:8 * r + 8, :].clone().requires_grad_(True)
            y = bn(xr)
            (y * w[..., 8 * r:8 * r + 8, :]).sum().backward()
            res[r] = (y.detach(), xr.grad, bn.weight.grad, bn.bias.grad)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            group.barrier.abort()

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    for got, want in ((torch.cat([res[0][0], res[1][0]], dim=-2), out.detach()),
                      (torch.cat([res[0][1], res[1][1]], dim=-2), xw.grad),
                      (res[0][2] + res[1][2], whole.weight.grad),
                      (res[0][3] + res[1][3], whole.bias.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-3 * float(want.abs().max()))


# ------------------------------------------------------ 4 ranks, dp1 x sp2 x tp2
def _grads_of_one_step(tr, sd, batch):
    """The gradients one step of ``tr`` from weights ``sd`` applies, whole
    (a tensor-parallel block gathered), by parameter name."""
    st = tr.init_state(state_dict=sd)
    tr._train_step_core(st, batch, None, None, 1e-3)
    return {n: tr._leaf_out(n, p.grad, False).clone() for n, p in st.model.named_parameters()}


def _sp_rank(rank, world, tmp):
    """dp x sp x tp = 1 x 2 x 2: the mesh, the fits, one step's gradients,
    evaluation, a sharded-snapshot resume."""
    from deepprior_tpu_torch.parallel import DistributedTrainer, batch_sharding, make_mesh

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    data, val, prior = inp["data"], inp["val"], inp["prior"]
    mesh = make_mesh(dp=1, sp=2, tp=2)

    def trainer(model, cfg=PLAIN_CFG, p=prior):
        return DistributedTrainer(model, cfg, NYU_CAMERA, mesh, prior=p)

    def fit(tr, sd=None, n_epochs=None, d=data, **kw):
        st = tr.init_state(state_dict=sd)
        st, hist = tr.fit(st, d, n_epochs=n_epochs, log=lambda m: None, **kw)
        return np.asarray(hist["train_cost"]), {k: v.clone() for k, v in
                                                tr.full_state_dict(st).items()}, st

    tr = trainer(_pose())
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "placements": [str(p) for p in batch_sharding(mesh)],
           "rows": (tr.row0, tr.local_batch, tr.spatial.rank, tr.spatial.size)}
    cost, sd, st = fit(tr, inp["pose_weights"])
    out["pose"] = (cost, sd, tr.evaluate(st, val), tr.predict(st, val.crops))
    batch = data.to("cpu").take(torch.arange(B))
    out["grads"] = {opt: _grads_of_one_step(trainer(_pose(), PLAIN_CFG._replace(optimizer=opt)),
                                            inp["pose_weights"], batch)
                    for opt in ("adam", "sgd_momentum")}
    tr = trainer(_resnet(torch.float64), RES_CFG)
    out["resnet"] = fit(tr, inp["resnet_weights"])[:2]
    out["resnet_adam"] = fit(trainer(_resnet(torch.float64)), inp["resnet_weights"])[0]
    out["resnet_grads"] = _grads_of_one_step(trainer(_resnet(torch.float64)),
                                             inp["resnet_weights"], batch)
    tr = trainer(_scalenet(), PLAIN_CFG, None)
    out["scalenet"] = fit(tr, inp["scalenet_weights"], d=inp["com_data"])[:2]
    com_batch = inp["com_data"].to("cpu").take(torch.arange(B))
    out["scalenet_grads"] = {opt: _grads_of_one_step(
        trainer(_scalenet(), PLAIN_CFG._replace(optimizer=opt), None),
        inp["scalenet_weights"], com_batch) for opt in ("adam", "sgd_momentum")}
    tr = trainer(_pose(512, dropout=True), CFG)
    out["aug"] = fit(tr, inp["aug_weights"])[:2]
    # a sharded snapshot after epoch 0, resumed by a fresh trainer
    tr = trainer(_pose())
    tr.sharded_snapshots = True
    fit(tr, inp["pose_weights"], n_epochs=1, snapshot_path=os.path.join(tmp, "snap"))
    tr = trainer(_pose())
    st, start = tr.load_train_state(os.path.join(tmp, "snap_last.ckpt"), tr.init_state())
    st, _ = tr.fit(st, data, start_epoch=start, log=lambda m: None)
    out["resumed"] = (start, {k: v.clone() for k, v in tr.full_state_dict(st).items()})
    torch.save(out, os.path.join(tmp, f"sp_{rank}.pt"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp_ranks"))
    data = TrainData.from_sequence(make_sequence(NYU_CAMERA, 2 * B, num_joints=14, seed=12))
    val = TrainData.from_sequence(make_sequence(NYU_CAMERA, 8, num_joints=14, seed=13))
    prior = fit_pose_prior(NYU_CAMERA, np.random.default_rng(12), data.gt3d_crop, data.com,
                           data.cube, 30, num_poses=3000)

    def weights(model, seed):
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.state_dict()

    # ScaleNet regresses one joint's offset (mains/common.py::run_com_refine)
    inp = {"data": data, "val": val, "prior": prior,
           "com_data": data._replace(gt3d_crop=data.gt3d_crop[:, :1]),
           "pose_weights": weights(_pose(), 1), "resnet_weights": weights(_resnet(), 2),
           "scalenet_weights": weights(_scalenet(), 3),
           "aug_weights": weights(_pose(512, dropout=True), 4)}
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    return tmp, inp


@pytest.fixture(scope="module")
def ranks(inputs):
    """The 4 ranks, spawned in the background while the JAX reference runs."""
    from concurrent.futures import ThreadPoolExecutor

    tmp, _ = inputs
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(spawn_cpu, _sp_rank, 4, (tmp,), os.path.join(tmp, "store"))
        yield run
        run.result()


@pytest.fixture(scope="module")
def sp_runs(ranks, inputs):
    ranks.result()
    return [torch.load(os.path.join(inputs[0], f"sp_{r}.pt"), weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def single(inputs):
    """The plain Trainer on the same weights and data."""
    _, inp = inputs

    def fit(model, sd, cfg=PLAIN_CFG, prior=inp["prior"], data=inp["data"]):
        tr = Trainer(model, cfg, NYU_CAMERA, prior=prior, device="cpu")
        st = tr.init_state(state_dict=sd)
        st, hist = tr.fit(st, data, log=lambda m: None)
        return np.asarray(hist["train_cost"]), st.model.state_dict(), tr, st

    batch = inp["data"].to("cpu").take(torch.arange(B))
    out = {"pose": fit(_pose(), inp["pose_weights"]),
           "resnet": fit(_resnet(torch.float64), inp["resnet_weights"], RES_CFG),
           "scalenet": fit(_scalenet(), inp["scalenet_weights"], prior=None,
                           data=inp["com_data"]),
           "aug": fit(_pose(512, dropout=True), inp["aug_weights"], CFG)}
    out["grads"] = {opt: _grads_of_one_step(
        Trainer(_pose(), PLAIN_CFG._replace(optimizer=opt), NYU_CAMERA, prior=inp["prior"],
                device="cpu"), inp["pose_weights"], batch) for opt in ("adam", "sgd_momentum")}
    out["resnet_grads"] = _grads_of_one_step(
        Trainer(_resnet(torch.float64), PLAIN_CFG, NYU_CAMERA, prior=inp["prior"],
                device="cpu"),
        inp["resnet_weights"], batch)
    com_batch = inp["com_data"].to("cpu").take(torch.arange(B))
    out["scalenet_grads"] = {opt: _grads_of_one_step(
        Trainer(_scalenet(), PLAIN_CFG._replace(optimizer=opt), NYU_CAMERA, prior=None,
                device="cpu"), inp["scalenet_weights"], com_batch)
        for opt in ("adam", "sgd_momentum")}
    return out


def _jax_sp_fit(flax_model, variables, cfg, data, prior=None, tp=2):
    """The JAX DistributedTrainer on a dp1 x sp2 x tp mesh of the 8 virtual
    devices (GSPMD's halo exchanges) from the flax ``variables`` (numpy
    leaves, cast to the model's dtype), placed as its init_state places
    them: (loss trace, final params as numpy)."""
    import jax
    import jax.numpy as jnp

    from deepprior_tpu.camera import NYU_CAMERA as J_NYU
    from deepprior_tpu.parallel import DistributedTrainer as JaxDistributedTrainer
    from deepprior_tpu.parallel import make_mesh as jax_mesh
    from deepprior_tpu.parallel.mesh import param_shardings, replicated
    from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
    from deepprior_tpu.train import trainer as jtrainer

    mesh = jax_mesh(n_devices=2 * tp, dp=1, sp=2, tp=tp)
    jt = JaxDistributedTrainer(
        flax_model, jtrainer.TrainConfig(**cfg._asdict()), J_NYU, mesh,
        prior=None if prior is None else JaxPCAPrior(prior.components.numpy(),
                                                     prior.mean.numpy()))
    params, stats = (jax.tree.map(lambda a: jnp.asarray(a, flax_model.cfg.dtype), variables[k])
                     for k in ("params", "batch_stats"))
    params = jax.device_put(params, param_shardings(params, mesh))
    st = jtrainer.TrainState(params=params, batch_stats=jax.device_put(stats, replicated(mesh)),
                             opt_state=jt.tx.init(params), step=jnp.zeros((), jnp.int32))
    jdata = jtrainer.TrainData(*(np.asarray(a) for a in data))
    st, hist = jt.fit(st, jt.place_data(jdata), log=lambda m: None)
    return np.asarray(hist["train_cost"]), jax.tree.map(np.asarray, st.params)


def _flax_pose():
    from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
    from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig

    return FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64, dropout=False))


def test_sp_matches_jax_distributed_trainer(inputs, ranks, request):
    """The JAX DistributedTrainer on a dp1 x sp2 x tp2 mesh from the same
    weights, data and prior, no augmentation, no dropout: the port's
    PoseRegNet loss trace within rtol 1e-3 (computed while the ranks run)."""
    from test_torch_parallel import _flax_params

    _, inp = inputs
    want, _ = _jax_sp_fit(_flax_pose(), {"params": _flax_params(inp["pose_weights"]),
                                         "batch_stats": {}},
                          PLAIN_CFG, inp["data"], inp["prior"])
    runs = request.getfixturevalue("sp_runs")
    np.testing.assert_allclose(runs[0]["pose"][0], want, rtol=1e-3)


def test_sp_resnet_and_scalenet_match_jax_distributed_trainer(inputs, ranks, request):
    """The same for the depth-11 ResNet (float64 on both sides, as
    test_torch_resnet.py compares the trainers: flax's float32 BatchNorm
    variance cancels over the crops' flat background) and for ScaleNet (the
    CoM-refinement net, one joint, no prior): the port's loss traces within
    rtol 1e-3 of the JAX DistributedTrainer's on dp1 x sp2 x tp2 under
    ADAM.  The ResNet's sgd_momentum trace is held to the JAX trainer on
    dp1 x sp2: on dp1 x sp2 x tp2 the JAX package scales the conv kernels'
    gradients by tp (test_jax_sp_with_tp_scales_conv_gradients), which only
    ADAM does not see."""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from deepprior_tpu.models import ResNet as FlaxResNet
    from deepprior_tpu.models import ResNetConfig as FlaxResNetConfig
    from deepprior_tpu.models import ScaleNet as FlaxScaleNet
    from deepprior_tpu.models import ScaleNetConfig as FlaxScaleNetConfig

    _, inp = inputs
    res, sca = _resnet(), _scalenet()
    res.load_state_dict(inp["resnet_weights"])
    sca.load_state_dict(inp["scalenet_weights"])
    with jax.enable_x64(True):
        flax = FlaxResNet(FlaxResNetConfig(num_joints=1, n_dims=30, depth=11,
                                           stages=(8, 16, 16, 16, 16), hidden=32,
                                           dtype=jnp.float64))
        want_adam = _jax_sp_fit(flax, chip_smoke.flax_variables(res), PLAIN_CFG, inp["data"],
                                inp["prior"])[0]
        want_sgd = _jax_sp_fit(flax, chip_smoke.flax_variables(res), RES_CFG, inp["data"],
                               inp["prior"], tp=1)[0]
    flax = FlaxScaleNet(FlaxScaleNetConfig(hidden=32, dropout=False))
    want_sca = _jax_sp_fit(flax, chip_smoke.flax_variables(sca), PLAIN_CFG, inp["com_data"])[0]
    runs = request.getfixturevalue("sp_runs")
    np.testing.assert_allclose(runs[0]["resnet_adam"], want_adam, rtol=1e-3)
    np.testing.assert_allclose(runs[0]["resnet"][0], want_sgd, rtol=1e-3)
    np.testing.assert_allclose(runs[0]["scalenet"][0], want_sca, rtol=1e-3)


def test_jax_sp_with_tp_scales_conv_gradients(inputs, ranks):
    """A fault of the JAX package, pinned (ROADMAP Queue 3): its
    DistributedTrainer on dp1 x sp2 x tp2 (not on dp1 x sp2, nor on dp x
    tp) moves every conv kernel by tp = 2 times the single-device update of
    one sgd_momentum step, and the dense layers by the same update.  The
    port's sp step takes the single-device gradients on that mesh
    (test_sp_gradients_match_one_device)."""
    import jax
    import jax.numpy as jnp

    from deepprior_tpu.camera import NYU_CAMERA as J_NYU
    from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
    from deepprior_tpu.train import trainer as jtrainer
    from test_torch_parallel import _flax_params

    def kernels(params):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(params)[0]
                if jax.tree_util.keystr(k).endswith("['kernel']")}

    _, inp = inputs
    cfg = PLAIN_CFG._replace(optimizer="sgd_momentum", weightreg_factor=0.0, n_epochs=1)
    data, prior = [np.asarray(a)[:B] for a in inp["data"]], inp["prior"]
    start = _flax_params(inp["pose_weights"])
    jt = jtrainer.Trainer(_flax_pose(), jtrainer.TrainConfig(**cfg._asdict()), J_NYU,
                          prior=JaxPCAPrior(prior.components.numpy(), prior.mean.numpy()))
    params = jax.tree.map(jnp.asarray, start)
    st = jtrainer.TrainState(params=params, batch_stats={}, opt_state=jt.tx.init(params),
                             step=jnp.zeros((), jnp.int32))
    st, _ = jt.fit(st, jtrainer.TrainData(*data), log=lambda m: None)
    a, b = kernels(start), kernels(st.params)
    for tp, conv_scale in ((2, 2.0), (1, 1.0)):
        w = kernels(_jax_sp_fit(_flax_pose(), {"params": start, "batch_stats": {}}, cfg, data,
                                prior, tp=tp)[1])
        for k in a:
            scale = conv_scale if "ConvPool" in k else 1.0
            np.testing.assert_allclose(w[k] - a[k], scale * (b[k] - a[k]), rtol=1e-3,
                                       atol=1e-3 * np.abs(b[k] - a[k]).max(),
                                       err_msg=f"tp={tp} {k}")


def test_sp_mesh_and_rows(sp_runs):
    """make_mesh(dp=1, sp=2, tp=2) lays ranks out row-major: ranks 0-1 and
    2-3 share a tp group, ranks {0, 2} and {1, 3} an sp group; an sp rank
    does not shift the batch rows (data_rank runs over dp only), and a
    batch is whole along sp and tp."""
    for r, run in enumerate(sp_runs):
        assert run["mesh"] == {"dp": 1, "sp": 2, "tp": 2}
        assert run["placements"] == ["S(0)", "R", "R"]
        assert run["rows"] == (0, B, r // 2, 2)


def test_sp_fit_matches_plain_trainer(sp_runs, single):
    """PoseRegNet with weight decay, a depth-11 ResNet (BatchNorm over the
    row blocks; float64, sgd_momentum) and ScaleNet at sp = 2: the plain Trainer's
    loss traces within rtol 1e-4 on every rank, the parameters within 1e-4
    and ResNet's running statistics within 1e-5."""
    for key in ("pose", "resnet", "scalenet"):
        want_cost, want_sd = single[key][:2]
        for run in sp_runs:
            np.testing.assert_allclose(run[key][0], want_cost, rtol=1e-4, err_msg=key)
            for k, v in want_sd.items():
                np.testing.assert_allclose(run[key][1][k].numpy(), v.numpy(), rtol=0,
                                           atol=1e-5 if "running" in k else 1e-4,
                                           err_msg=f"{key} {k}")


def test_sp_gradients_match_one_device(sp_runs, single):
    """One step's gradients, compared directly (ADAM's step is nearly blind
    to a head gradient summed over sp instead of taken once): under ADAM
    and sgd_momentum for PoseRegNet with weight decay and for ScaleNet,
    and for the ResNet (float64), within rtol 1e-4 of the plain step's on
    every rank."""
    pairs = [(f"{net} {opt}", sp[key][opt], single[key][opt])
             for sp in sp_runs for opt in ("adam", "sgd_momentum")
             for net, key in (("pose", "grads"), ("scalenet", "scalenet_grads"))]
    pairs += [("resnet", sp["resnet_grads"], single["resnet_grads"]) for sp in sp_runs]
    for label, got, want in pairs:
        scale = max(float(g.abs().max()) for g in want.values())
        for n, g in want.items():
            np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-6 * scale, err_msg=f"{label} {n}")


def test_sp_augmented_epoch_matches_plain_trainer(sp_runs, single):
    """The augmentation (com/rot/none) and the dropout drawn for the whole
    batch on every sp rank, hidden 512 so that tp splits the head: the
    plain Trainer's loss trace within rtol 1e-4 and its parameters within
    1e-4."""
    want_cost, want_sd = single["aug"][:2]
    for run in sp_runs:
        np.testing.assert_allclose(run["aug"][0], want_cost, rtol=1e-4)
        for k, v in want_sd.items():
            np.testing.assert_allclose(run["aug"][1][k].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)


def test_sp_evaluate_and_predict(sp_runs, single, inputs):
    """Evaluation and prediction run the same split forward: the plain
    Trainer's numbers of the same weights on every rank."""
    _, inp = inputs
    tr = Trainer(_pose(), PLAIN_CFG, NYU_CAMERA, prior=inp["prior"], device="cpu")
    st = tr.init_state(state_dict=sp_runs[0]["pose"][1])
    want_obs, want_pred = tr.evaluate(st, inp["val"]), tr.predict(st, inp["val"].crops)
    for run in sp_runs:
        obs, pred = run["pose"][2], run["pose"][3]
        for k in want_obs:
            np.testing.assert_allclose(obs[k], want_obs[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(pred, want_pred, rtol=1e-5, atol=1e-6)


def test_sp_sharded_snapshot_resume_is_bit_identical(sp_runs):
    """A sharded snapshot after epoch 0, resumed by a fresh trainer: the
    uninterrupted run's parameters bit for bit."""
    for run in sp_runs:
        start, got = run["resumed"]
        assert start == 1
        for k, v in run["pose"][1].items():
            assert torch.equal(got[k], v), k
