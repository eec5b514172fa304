"""The port's scale-out (deepprior_tpu_torch/parallel/) on the CPU: gloo
ranks spawned in the test, held against the port on one device and against
the JAX package's 8-virtual-device mesh (tests/conftest.py).

Two groups are spawned once for the module and every case reads their
results: 2 ranks (dp = 2) and 4 ranks (dp x tp = 2 x 2).  The inputs (a
synthetic NYU set, a PCA prior, flax-initialized weights) are made here and
handed to the ranks.  Tolerances, each with the deviation measured on this
CPU when it was set:

- a dp = 2 PoseRegNet fit with the augmentation and dropout on against the
  port's single-device fit on the same seed: loss trace rtol 1e-4
  (measured 2.1e-7; parameters within 1.5e-6);
- the same dp = 2 trainer from flax weights with aug_modes=None against
  the JAX DistributedTrainer on a dp = 2 mesh: rtol 1e-4, the single-device
  bound of tests/test_torch_train.py:178;
- dp x tp = 2 x 2 and a depth-11 ResNet with BatchNorm against one device:
  rtol 1e-3, the JAX tests' own (measured 2.7e-7 and 2.5e-7);
- place_data(shard=True) and fit_streamed under dp against the replicated
  fit: equal;
- ShardedEstimator over ['cpu', 'cpu'] against FusedEstimator: equal; over
  a dp = 2 or a tp = 2 process group: joints within 1e-3 mm; against the
  JAX ShardedEstimator on the same weights: crops equal, joints within
  1e-3 mm (tests/test_torch_fused.py's bound).
"""

import os

import numpy as np
import pytest
import torch

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_depth_frame, make_sequence
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
from deepprior_tpu_torch.parallel import mesh as tmesh
from deepprior_tpu_torch.parallel.multihost import spawn_cpu
from deepprior_tpu_torch.prior import PCAPrior, fit_pose_prior
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

B = 16
CFG = TrainConfig(batch_size=B, learning_rate=0.003, n_epochs=2, use_early_stopping=False)
RES_CFG = CFG._replace(model_has_dropout=False, weightreg_factor=1e-3)
HIDDEN = 512  # the narrowest head param_shardings splits (min_width)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here, as in every spawned rank: these runs are
    small, and the ranks and the parallel test workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(hidden=HIDDEN, dropout=True):
    return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=hidden,
                                       dropout=dropout))


def _resnet():
    return ResNet(ResNetConfig(num_joints=1, n_dims=30, depth=11, stages=(8, 16, 16, 16, 16)))


def _fit(trainer, data, shard=False, streamed=False, state_dict=None, val=None):
    """(loss trace, whole state dict, evaluation of val, predictions of val)."""
    st = trainer.init_state(state_dict=state_dict)
    if streamed:
        arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
        st, hist = trainer.fit_streamed(st, arrays, chunk_steps=2, log=lambda m: None)
    else:
        placed = trainer.place_data(data, shard=True) if shard else data
        st, hist = trainer.fit(st, placed, log=lambda m: None)
    full = getattr(trainer, "full_state_dict", None)
    sd = full(st) if full is not None else st.model.state_dict()
    out = [np.asarray(hist["train_cost"]), {k: v.detach().clone() for k, v in sd.items()}]
    if val is not None:
        out += [trainer.evaluate(st, val), trainer.predict(st, val.crops)]
    return out


def _load(path):
    return torch.load(path, weights_only=False)


def _flax_params(sd):
    """A PoseRegNet state dict as flax ``variables["params"]``: the inverse
    of utils/convert.py::poseregnet_state_dict_from_flax (the tests check
    the round trip)."""
    params, head = {}, {}
    n_conv = len([k for k in sd if k.endswith("conv.weight")])
    for i in range(n_conv):
        params[f"ConvPool_{i}"] = {"Conv_0": {
            "kernel": sd[f"convs.{i}.conv.weight"].numpy().transpose(2, 3, 1, 0),
            "bias": sd[f"convs.{i}.conv.bias"].numpy()}}
    c = sd[f"convs.{n_conv - 1}.conv.weight"].shape[0]
    for i in range(len([k for k in sd if k.startswith("head.dense.") and k.endswith("weight")])):
        kern = sd[f"head.dense.{i}.weight"].numpy().T
        if i == 0:  # NCHW flatten rows -> NHWC
            side = int(round((kern.shape[0] // c) ** 0.5))
            kern = kern.reshape(c, side, side, -1).transpose(1, 2, 0, 3).reshape(kern.shape)
        head[f"Dense_{i}"] = {"kernel": np.ascontiguousarray(kern),
                              "bias": sd[f"head.dense.{i}.bias"].numpy()}
    params["MLPHead_0"] = head
    return params


# --------------------------------------------------------------- ranks
def _dp2_rank(rank, world, tmp):
    """dp = 2: the fits, the sharded data, fit_streamed, evaluation, the
    JAX-weights fit, a tp = 2 and a dp = 2 ShardedEstimator, make_trainer's
    refusal."""
    from deepprior_tpu_torch.mains.common import make_trainer
    from deepprior_tpu_torch.parallel import DistributedTrainer, ShardedEstimator, make_mesh
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    inp = _load(os.path.join(tmp, "inputs.pt"))
    data, val, prior = inp["data"], inp["val"], inp["prior"]
    mesh = make_mesh(dp=2)

    def trainer(model, cfg=CFG, p=prior):
        return DistributedTrainer(model, cfg, NYU_CAMERA, mesh, prior=p)

    out = {
        "aug": _fit(trainer(_pose()), data, val=val),
        "shard": _fit(trainer(_pose()), data, shard=True),
        "streamed": _fit(trainer(_pose()), data, streamed=True),
        "jax": _fit(trainer(_pose(64, dropout=False), CFG._replace(aug_modes=None),
                            inp["jax_prior"]), inp["jax_data"],
                    state_dict=inp["jax_weights"]),
    }
    # wrap-around padding: 31 frames over 2 ranks hold 16 rows each
    sub = TrainData(*(np.asarray(a)[:31] for a in data))
    tr = trainer(_pose())
    placed = tr.place_data(sub, shard=True)
    out["pad"] = (placed.n, placed.shard.crops.cpu().numpy(),
                  _fit(tr, sub, shard=True)[0])
    # a host batch and a macro chunk staged as this rank's rows
    host = {"crops": np.asarray(data.crops[:B])}
    out["stream_put"] = (tr.stream_put(host)["crops"].numpy(),
                         tr.stream_put_chunk({"crops": host["crops"][None]})["crops"].numpy())
    # make_trainer refuses a world that is not dp x tp, naming the launcher
    try:
        make_trainer(_pose(), CFG, NYU_CAMERA, dp=3, tp=1)
    except RuntimeError as exc:
        out["refused"] = str(exc)
    # serving over the group: rows split over dp = 2, and the FC stack
    # split over tp = 2
    model = _pose(1024)
    model.load_state_dict(inp["serve_weights"])
    est = FusedEstimator(model, NYU_CAMERA, prior=inp["serve_prior"], device="cpu")
    out["serve_dp"] = ShardedEstimator(est, mesh=mesh)(inp["depth"], inp["com"])
    est = FusedEstimator(model, NYU_CAMERA, prior=inp["serve_prior"], device="cpu")
    out["serve_tp"] = ShardedEstimator(est, mesh=make_mesh(dp=1, tp=2))(
        inp["depth"], inp["com"])
    torch.save(out, os.path.join(tmp, f"dp2_{rank}.pt"))


def _dp2tp2_rank(rank, world, tmp):
    """dp x tp = 2 x 2: mesh shapes, the plan, PoseRegNet and ResNet fits,
    the ('dcn', 'dp', 'tp') mesh."""
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh

    inp = _load(os.path.join(tmp, "inputs.pt"))
    data, prior = inp["data"], inp["prior"]
    shapes = {}
    for key, kw in (("dp2tp2", dict(dp=2, tp=2)), ("tp2", dict(tp=2)),
                    ("n4", dict(n_devices=4, tp=1)), ("dcn", dict(slices=2, tp=2))):
        m = make_mesh(**kw)
        shapes[key] = dict(zip(m.mesh_dim_names, m.shape))
    mesh = make_mesh(dp=2, tp=2)

    def fit(model, cfg, m=mesh, **kw):
        return _fit(DistributedTrainer(model, cfg, NYU_CAMERA, m, prior=prior), data, **kw)

    tr = DistributedTrainer(_pose(), CFG, NYU_CAMERA, mesh, prior=prior)
    tr.init_state()
    # a batch split over the data axes as a DTensor: its whole is the batch
    from torch.distributed.tensor import DTensor

    from deepprior_tpu_torch.parallel import batch_sharding, replicated

    crops = torch.as_tensor(np.asarray(data.crops[:B]))
    rows = crops[tr.row0:tr.row0 + tr.local_batch]
    whole = DTensor.from_local(rows, mesh, batch_sharding(mesh), run_check=False).full_tensor()
    rep = DTensor.from_local(crops, mesh, replicated(mesh), run_check=False).full_tensor()
    out = {
        "placements": (torch.equal(whole, crops), torch.equal(rep, crops),
                       [str(p) for p in batch_sharding(mesh)]),
        "shapes": shapes,
        "layout": dict(tr.layout),
        "local_shapes": {k: tuple(v.shape) for k, v in tr.model.state_dict().items()},
        "pose": fit(_pose(), CFG),
        "resnet": fit(_resnet(), RES_CFG),
        "dcn": fit(_pose(), CFG, m=make_mesh(slices=2, tp=2), shard=True),
    }
    torch.save(out, os.path.join(tmp, f"dp2tp2_{rank}.pt"))


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every rank and reference reads, written to a file."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    data = TrainData.from_sequence(make_sequence(NYU_CAMERA, 32, num_joints=14, seed=9))
    val = TrainData.from_sequence(make_sequence(NYU_CAMERA, 12, num_joints=14, seed=10))
    prior = fit_pose_prior(NYU_CAMERA, np.random.default_rng(1), data.gt3d_crop, data.com,
                           data.cube, 30, num_poses=3000)
    jax_model = _pose(64, dropout=False)
    jax_model.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(5)
    frames = [make_depth_frame(NYU_CAMERA, rng) for _ in range(4)]
    serve_model = _pose(1024)
    serve_model.reset_parameters(torch.Generator().manual_seed(6))
    inp = {
        "data": data, "val": val, "prior": prior,
        "jax_data": data, "jax_prior": prior,
        "jax_weights": jax_model.state_dict(),
        "depth": np.stack([f[0] for f in frames]), "com": np.stack([f[1] for f in frames]),
        "serve_weights": serve_model.state_dict(),
        "serve_prior": PCAPrior(rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
                                np.zeros(42, np.float32)),
    }
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    return tmp, inp


@pytest.fixture(scope="module")
def groups(inputs):
    """Both groups, spawned at once in the background (2 + 4 processes of
    one thread each): the first cases of the module, which need no rank,
    run meanwhile.  Returns the runs' futures."""
    from concurrent.futures import ThreadPoolExecutor

    tmp, _ = inputs
    pool = ThreadPoolExecutor(2)
    runs = [pool.submit(spawn_cpu, fn, n, (tmp,), os.path.join(tmp, f"store{n}"))
            for fn, n in ((_dp2_rank, 2), (_dp2tp2_rank, 4))]
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def dp2(groups, inputs):
    groups[0].result()
    return [_load(os.path.join(inputs[0], f"dp2_{r}.pt")) for r in range(2)]


@pytest.fixture(scope="module")
def dp2tp2(groups, inputs):
    groups[1].result()
    ranks = [_load(os.path.join(inputs[0], f"dp2tp2_{r}.pt")) for r in range(4)]
    return dict(ranks[0], ranks=ranks)


@pytest.fixture(scope="module")
def single(inputs):
    """The port on one device: the references of the rank runs."""
    _, inp = inputs
    data, prior = inp["data"], inp["prior"]

    def trainer(model, cfg=CFG):
        return Trainer(model, cfg, NYU_CAMERA, prior=prior, device="cpu")

    return {"pose": _fit(trainer(_pose()), data, val=inp["val"]),
            "resnet": _fit(trainer(_resnet(), RES_CFG), data)}


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol)
    print("max rel deviation", float(np.max(np.abs(got - want) / np.abs(want))))


# --------------------------------------------------------------- mesh
def test_param_shardings_megatron_pattern(groups):
    """The JAX assignment (tests/test_parallel.py:38-50): Dense_0 column-
    parallel, Dense_1 row-parallel, the convolutions and the narrow layers
    whole; ResNet-47's 16384x1024 FC1 column-parallel too.  (Its fixture
    starts the rank groups in the background.)"""
    from jax.sharding import PartitionSpec as P
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    from deepprior_tpu.parallel import make_mesh as jax_mesh
    from deepprior_tpu.parallel import param_shardings as jax_shardings

    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30))
    jparams = _flax_params(model.state_dict())
    jhead = jax_shardings(jparams, jax_mesh(dp=4, tp=2))["MLPHead_0"]
    assert jax_shardings(jparams, jax_mesh(dp=4, tp=2))["ConvPool_0"]["Conv_0"][
        "kernel"].spec == P()
    plan = tmesh.param_shardings(model, 2)
    kinds = {P(None, "tp"): ColwiseParallel, P("tp", None): RowwiseParallel}
    assert len(jhead) == 3
    for i in range(3):
        spec = jhead[f"Dense_{i}"]["kernel"].spec
        want = kinds.get(spec)
        got = plan.get(f"head.dense.{i}")
        assert (got is None) if want is None else isinstance(got, want), (i, spec, got)
    assert set(plan) == {"head.dense.0", "head.dense.1"}
    rplan = tmesh.param_shardings(ResNet(ResNetConfig(num_joints=1, n_dims=30)), 2)
    assert isinstance(rplan["head.dense.0"], ColwiseParallel)
    assert isinstance(rplan["head.dense.1"], RowwiseParallel)
    assert tmesh.param_shardings(_pose(), 1) == {}


def test_sharded_estimator_matches_jax(inputs, groups):
    """The JAX ShardedEstimator (dp = 2 mesh, shard_map over the Pallas
    crop in interpret mode) on the same weights: crops equal, joints within
    1e-3 mm."""
    from jax.experimental.pallas import tpu as pltpu

    from deepprior_tpu.camera import NYU_CAMERA as J_NYU
    from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
    from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
    from deepprior_tpu.parallel import ShardedEstimator as JaxShardedEstimator
    from deepprior_tpu.parallel import make_mesh as jax_mesh
    from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
    from deepprior_tpu.realtime.fused import FusedEstimator as JaxFusedEstimator
    from deepprior_tpu_torch.parallel import ShardedEstimator
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    _, inp = inputs
    flax = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64))
    model = _pose(64)
    model.reset_parameters(torch.Generator().manual_seed(7))
    variables = {"params": _flax_params(model.state_dict())}
    prior = inp["serve_prior"]
    jprior = JaxPCAPrior(prior.components.numpy(), prior.mean.numpy())
    jest = JaxShardedEstimator(JaxFusedEstimator(flax, J_NYU, prior=jprior,
                                                 crop_method="pallas"),
                               jax_mesh(n_devices=2, dp=2), variables)
    with pltpu.force_tpu_interpret_mode():
        jj, jc3, jcr = jest(inp["depth"], inp["com"])
    est = ShardedEstimator(FusedEstimator(model, NYU_CAMERA, prior=prior, device="cpu"),
                           devices=["cpu", "cpu"])
    j, c3, cr = est(inp["depth"], inp["com"])
    np.testing.assert_array_equal(cr.numpy(), np.asarray(jcr))
    np.testing.assert_allclose(c3.numpy(), np.asarray(jc3), rtol=1e-6)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-3)


def test_dp2_matches_jax_distributed_trainer(inputs, groups, request):
    """The same weights, data and prior, no augmentation and no dropout: the
    port's dp = 2 loss trace against the JAX DistributedTrainer on a dp = 2
    mesh (computed while the ranks run)."""
    import jax

    from deepprior_tpu.camera import NYU_CAMERA as J_NYU
    from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
    from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
    from deepprior_tpu.parallel import DistributedTrainer as JaxDistributedTrainer
    from deepprior_tpu.parallel import make_mesh as jax_mesh
    from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
    from deepprior_tpu.train import trainer as jtrainer
    from deepprior_tpu_torch.utils.convert import poseregnet_state_dict_from_flax

    _, inp = inputs
    d = inp["jax_data"]
    jdata = jtrainer.TrainData(*(np.asarray(a) for a in d))
    prior = inp["jax_prior"]
    flax = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64, dropout=False))
    cfg = jtrainer.TrainConfig(**CFG._replace(aug_modes=None)._asdict())
    jt = JaxDistributedTrainer(flax, cfg, J_NYU, jax_mesh(n_devices=2, dp=2),
                               prior=JaxPCAPrior(prior.components.numpy(), prior.mean.numpy()))
    params = _flax_params(inp["jax_weights"])
    back = poseregnet_state_dict_from_flax(params)
    assert all(torch.equal(back[k], v) for k, v in inp["jax_weights"].items())
    st = jt.init_state(jdata.crops[:B])
    st = st.replace(params=jax.device_put(params, jax.tree.map(
        lambda a: a.sharding, st.params)))
    st, hist = jt.fit(st, jt.place_data(jdata), log=lambda m: None)
    dp2 = request.getfixturevalue("dp2")
    _close(dp2[0]["jax"][0], np.asarray(hist["train_cost"]), rtol=1e-4)


def test_make_mesh_shapes(dp2tp2):
    """The JAX size rules (tests/test_parallel.py:25-36) on 8 devices, and
    the DeviceMeshes of a 4-rank group; sp > 1 raises naming the ROADMAP."""
    assert dict(tmesh.mesh_dims(8, dp=4, tp=2)) == {"dp": 4, "tp": 2}
    assert dict(tmesh.mesh_dims(8, tp=2)) == {"dp": 4, "tp": 2}
    assert dict(tmesh.mesh_dims(4, tp=1)) == {"dp": 4, "tp": 1}
    assert tmesh.mesh_dims(8, slices=2, dp=2, tp=2) == (("dcn", 2), ("dp", 2), ("tp", 2))
    with pytest.raises(AssertionError):
        tmesh.mesh_dims(8, dp=3, tp=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 19"):
        tmesh.mesh_dims(8, sp=2, tp=2)
    assert dp2tp2["placements"] == (True, True, ["S(0)", "R"])
    assert dp2tp2["shapes"] == {"dp2tp2": {"dp": 2, "tp": 2}, "tp2": {"dp": 2, "tp": 2},
                                "n4": {"dp": 4, "tp": 1},
                                "dcn": {"dcn": 2, "dp": 1, "tp": 2}}


def test_ranks_hold_their_blocks(dp2tp2):
    """A dp x tp = 2 x 2 rank's split layers hold its block; the rest whole."""
    assert dp2tp2["layout"] == {"head.dense.0.weight": 0, "head.dense.0.bias": 0,
                                "head.dense.1.weight": 1}
    shapes = dp2tp2["local_shapes"]
    assert shapes["head.dense.0.weight"] == (HIDDEN // 2, 968)
    assert shapes["head.dense.1.weight"] == (HIDDEN, HIDDEN // 2)
    assert shapes["convs.0.conv.weight"] == (8, 1, 5, 5)


# --------------------------------------------------------------- training
def test_dp2_fit_matches_single_device(dp2, single):
    """Global augmentation and dropout draws, the gradient averaged over dp:
    the single-device loss trace and parameters; every rank reports them."""
    for r in range(2):
        _close(dp2[r]["aug"][0], single["pose"][0], rtol=1e-4)
    for k, v in single["pose"][1].items():
        np.testing.assert_allclose(dp2[0]["aug"][1][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        assert torch.equal(dp2[0]["aug"][1][k], dp2[1]["aug"][1][k]), k


def test_dp2_evaluate_and_predict_gather_the_rows(dp2, single, inputs):
    """Evaluation and prediction split each batch over the ranks and gather
    it back: the single-device numbers of the same weights, on every rank."""
    _, inp = inputs
    tr = Trainer(_pose(), CFG, NYU_CAMERA, prior=inp["prior"], device="cpu")
    st = tr.init_state(state_dict=dp2[0]["aug"][1])
    want_obs, want_pred = tr.evaluate(st, inp["val"]), tr.predict(st, inp["val"].crops)
    for r in range(2):
        obs, pred = dp2[r]["aug"][2], dp2[r]["aug"][3]
        for k in want_obs:
            np.testing.assert_allclose(obs[k], want_obs[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(pred, want_pred, rtol=1e-5, atol=1e-6)



def test_dp_tp_fit_matches_single_device(dp2tp2, single):
    """dp x tp = 2 x 2 (Megatron FC head, dropout columns cut per tp rank)
    and the ('dcn', 'dp', 'tp') mesh with sharded data: the single-device
    loss trace; the gathered parameters too."""
    _close(dp2tp2["pose"][0], single["pose"][0], rtol=1e-3)
    _close(dp2tp2["dcn"][0], single["pose"][0], rtol=1e-3)
    for k, v in single["pose"][1].items():
        assert dp2tp2["pose"][1][k].shape == v.shape, k
        np.testing.assert_allclose(dp2tp2["pose"][1][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_resnet_batchnorm_matches_single_device(dp2tp2, single):
    """A depth-11 ResNet (tests/test_parallel.py:208-209) with weight decay:
    BatchNorm's statistics over the global batch.  The running statistics
    are equal on every rank, and within 1e-3 of one device's (measured
    1.9e-4: Adam's first steps are sign-like, so the weights, and the
    statistics of their activations, move by up to lr where a gradient is
    near 0, as tests/test_torch_train.py:180-186 allows)."""
    _close(dp2tp2["resnet"][0], single["resnet"][0], rtol=1e-3)
    sd, want = dp2tp2["resnet"][1], single["resnet"][1]
    running = [k for k in want if "running" in k]
    assert len(running) == 26  # mean and variance of 13 BatchNorm layers
    for k in running:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=0, atol=1e-3,
                                   err_msg=k)
        for other in dp2tp2["ranks"][1:]:
            assert torch.equal(other["resnet"][1][k], sd[k]), k


def test_sharded_data_matches_replicated(dp2):
    """place_data(shard=True): each rank holds N / dp rows, the steps see
    the replicated run's batches; fit_streamed under dp stages only each
    rank's rows and gives fit's trace."""
    np.testing.assert_array_equal(dp2[0]["shard"][0], dp2[0]["aug"][0])
    np.testing.assert_array_equal(dp2[0]["streamed"][0], dp2[0]["aug"][0])
    for k, v in dp2[0]["aug"][1].items():
        assert torch.equal(dp2[0]["shard"][1][k], v), k
        assert torch.equal(dp2[0]["streamed"][1][k], v), k


def test_stream_put_stages_this_ranks_rows(dp2, inputs):
    """stream_put and stream_put_chunk hand each rank its block of rows."""
    _, inp = inputs
    crops = np.asarray(inp["data"].crops[:B])
    for r in range(2):
        batch, chunk = dp2[r]["stream_put"]
        np.testing.assert_array_equal(batch, crops[8 * r:8 * (r + 1)])
        np.testing.assert_array_equal(chunk, crops[None, 8 * r:8 * (r + 1)])


def test_sharded_data_pads_with_wraparound(dp2, inputs):
    """31 frames over 2 ranks: padded to 32 with the first frame, 16 rows a
    rank, and the fit stays finite."""
    _, inp = inputs
    crops = np.asarray(inp["data"].crops)
    padded = np.concatenate([crops[:31], crops[:1]])
    for r in range(2):
        n, shard, costs = dp2[r]["pad"]
        assert n == 32
        np.testing.assert_array_equal(shard, padded[16 * r:16 * (r + 1)])
        assert np.isfinite(costs).all()


def test_world_must_match_dp_tp(dp2):
    """No quiet fall back: a group of 2 ranks asked for dp 3 raises naming
    the launcher; so does dp 2 without a group."""
    from deepprior_tpu_torch.mains.common import make_trainer

    assert "torchrun" in dp2[0]["refused"] and "2 ranks" in dp2[0]["refused"]
    with pytest.raises(RuntimeError, match="torchrun"):
        make_trainer(_pose(), CFG, NYU_CAMERA, dp=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_trainer(_pose(), CFG, NYU_CAMERA, sp=2, device="cpu")
    assert isinstance(make_trainer(_pose(), CFG, NYU_CAMERA, device="cpu"), Trainer)


def test_world_of_one_is_the_plain_trainer(inputs, tmp_path):
    """A DistributedTrainer on a group of one rank (what the card runs):
    the plain Trainer's loss trace and parameters bit for bit."""
    import torch.distributed as dist

    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh
    from deepprior_tpu_torch.parallel.multihost import initialize

    _, inp = inputs
    cfg = RES_CFG._replace(n_epochs=1)
    want = _fit(Trainer(_resnet(), cfg, NYU_CAMERA, prior=inp["prior"], device="cpu"),
                inp["data"])
    initialize(store=dist.FileStore(str(tmp_path / "store"), 1), num_processes=1,
               process_id=0, device="cpu")
    try:
        tr = DistributedTrainer(_resnet(), cfg, NYU_CAMERA, make_mesh(),
                                prior=inp["prior"], device="cpu")
        got = _fit(tr, inp["data"])
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got[0], want[0])
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


# --------------------------------------------------------------- serving
def _serving(inp, **kw):
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    model = _pose(1024)
    model.load_state_dict(inp["serve_weights"])
    return FusedEstimator(model, NYU_CAMERA, prior=inp["serve_prior"], device="cpu", **kw)


def test_sharded_estimator_matches_fused(inputs, dp2):
    """Two replicas on 'cpu': FusedEstimator's outputs bit for bit, in the
    batch's order; over a dp = 2 and a tp = 2 process group, every rank
    returns the whole batch within 1e-3 mm."""
    from deepprior_tpu_torch.parallel import ShardedEstimator

    _, inp = inputs
    est = _serving(inp)
    sharded = ShardedEstimator(est, devices=["cpu", "cpu"])
    assert sharded.dp == 2 and not sharded.graph
    want = est(inp["depth"], inp["com"])
    for got in (sharded(inp["depth"], inp["com"]), sharded.eager(inp["depth"], inp["com"])):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for r in range(2):
        for key in ("serve_dp", "serve_tp"):
            got = dp2[r][key]
            np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="multiple"):
        sharded(inp["depth"][:3], inp["com"][:3])


def test_sharded_estimator_needs_com_unless_detect(inputs):
    """com=None needs detect=True (deepprior_tpu/parallel/serve.py:117-133)."""
    from deepprior_tpu_torch.parallel import ShardedEstimator

    _, inp = inputs
    with pytest.raises(ValueError, match="detect=True"):
        ShardedEstimator(_serving(inp), devices=["cpu", "cpu"])(inp["depth"])
    est = _serving(inp, detect=True)
    got = ShardedEstimator(est, devices=["cpu", "cpu"])(inp["depth"])
    want = est(inp["depth"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))



def test_server_pads_to_a_multiple_of_dp(inputs):
    """MicroBatchServer around a ShardedEstimator pads every batch to its
    max_batch, which must be a multiple of dp; serve_http --dp 2 builds it."""
    from deepprior_tpu_torch.mains import serve_http
    from deepprior_tpu_torch.parallel import ShardedEstimator
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer

    _, inp = inputs
    est = _serving(inp)
    sharded = ShardedEstimator(est, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="multiple"):
        MicroBatchServer(sharded, max_batch=3)
    with MicroBatchServer(sharded, max_batch=4, max_wait_ms=50) as srv:
        futs = [srv.submit(inp["depth"][i], inp["com"][i]) for i in range(3)]
        got = np.stack([f.result(timeout=120) for f in futs])
        with pytest.raises(ValueError, match="fixed-config"):
            srv.submit(inp["depth"][0], inp["com"][0], mirror=True)
    padded = (np.concatenate([inp["depth"][:3], inp["depth"][2:3]]),
              np.concatenate([inp["com"][:3], inp["com"][2:3]]))
    np.testing.assert_array_equal(got, est(*padded)[0][:3].numpy())
    args = serve_http.build_parser().parse_args(["--dp", "2", "--device", "cpu",
                                                 "--max-batch", "4", "--max-wait-ms", "50"])
    srv = serve_http.build_server(args)
    try:
        assert isinstance(srv.est, ShardedEstimator) and srv.est.dp == 2
        assert srv.submit(inp["depth"][0], inp["com"][0]).result(timeout=120).shape == (14, 3)
    finally:
        srv.close()
