"""V2V-PoseNet on the port (models/v2v.py, ops/voxel.py, the trainer's
hooks) held against the plain reference ``tests/plain_v2v.py`` on the CPU:
the network at the published channel widths on a 24^3 grid (levels 12^3,
6^3 and 3^3, the lowest odd like the published 11^3), with seeded random
weights, in float32; the grid, the targets and the decode bit for bit at
the published 88^3 / 44^3; one Trainer step against the reference's step;
``--model v2v`` through the NYU main; the checkpoint; the serving path
(``FusedEstimator`` eager and under ``MicroBatchServer``, ``load_serving_net``,
``serve_http``) against the benchmark's plain serving reference
``bench_torch/reference/serve_v2v.py``; the refusals of the sharded and
frozen entry points."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch import nn

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.mains import common, main_nyu_posereg_embedding
from deepprior_tpu_torch.models import V2VConfig, V2VPoseNet
from deepprior_tpu_torch.ops import voxel
from deepprior_tpu_torch.ops.crop import crop_transform
from deepprior_tpu_torch.train.trainer import TrainConfig, Trainer, _l2_penalty
from deepprior_tpu_torch.utils import profiling

_spec = importlib.util.spec_from_file_location(
    "plain_v2v", os.path.join(os.path.dirname(__file__), "plain_v2v.py"))
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

SMALL = dict(grid=24, cube_voxels=32)  # the published margin of 4 voxels a side
CAM = (NYU_CAMERA.fx, NYU_CAMERA.fy, NYU_CAMERA.ux, NYU_CAMERA.uy, NYU_CAMERA.flip_y)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Small CPU runs beside other test workers: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_net(seed=0, **cfg):
    """A V2V-PoseNet with He-normal convolutions and random BatchNorm
    scales and shifts (not V2V's 0.001 init, which leaves the output near
    zero), float32."""
    net = V2VPoseNet(V2VConfig(**{**SMALL, **cfg}))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, float(np.sqrt(2.0 / (p.numel() // p.shape[0]))), generator=gen)
            elif name.endswith("weight"):
                p.uniform_(0.5, 1.5, generator=gen)
            else:
                p.normal_(0.0, 0.1, generator=gen)
    return net


def batch(b=3, seed=1, grid_frac=0.35):
    """Random normalized crops with a background, CoMs, cubes and the crop
    transforms of those CoMs and cubes."""
    g = torch.Generator().manual_seed(seed)
    crops = torch.rand((b, 128, 128), generator=g) * 1.6 - 0.8
    crops[torch.rand((b, 128, 128), generator=g) > grid_frac] = 1.0
    crops[:, 0, :4] = -1.0  # on the near face: background too
    com = torch.stack([torch.rand(b, generator=g) * 200 + 220, torch.rand(b, generator=g) * 160
                       + 160, torch.rand(b, generator=g) * 400 + 500], dim=1)
    cube = (torch.rand(b, generator=g) * 80 + 260)[:, None].expand(b, 3).contiguous()
    m = crop_transform(com, cube, NYU_CAMERA.fx, NYU_CAMERA.fy, (480, 640), (128, 128))
    labels = torch.rand((b, 14, 3), generator=g) * 1.8 - 0.9
    return crops, com, cube, m, labels


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def test_published_size_counts_parameters_and_flops():
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = V2VPoseNet()
        x = torch.empty((1, 1, 88, 88, 88))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        out = net(x)
    assert sum(p.numel() for p in net.parameters()) == 3_410_222
    assert counter.get_total_flops() == 72_759_402_496
    assert out.shape == (1, 14, 44, 44, 44)


@pytest.mark.parametrize("train", [True, False], ids=["batch_stats", "running_stats"])
def test_network_matches_the_plain_reference(train):
    """Float32 on both sides; the port's BatchNorm is one F.batch_norm, the
    reference's an explicit mean and centred variance, so the heatmaps
    part by float32 round-off through 24 normalized layers: at most 1e-5
    of the output's largest magnitude."""
    net = random_net()
    x = (torch.rand((3, 1, 24, 24, 24), generator=torch.Generator().manual_seed(2)) > 0.9).float()
    net.train()
    with torch.no_grad():
        got = net(x)  # in training mode this also sets the running statistics
    if not train:
        net.eval()
        with torch.no_grad():
            got = net(x)
    want = plain.net({k: v.detach() for k, v in net.state_dict().items()}, x, train=train)
    assert got.shape == want.shape == (3, 14, 12, 12, 12)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_batchnorm_reduces_every_spatial_dim_of_a_3d_map():
    from deepprior_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(4).train()
    x = torch.randn((2, 4, 3, 5, 6), generator=torch.Generator().manual_seed(3)) * 3 + 1
    y = bn(x)
    assert torch.allclose(y.mean(dim=(0, 2, 3, 4)), torch.zeros(4), atol=1e-5)
    assert torch.allclose(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3, 4)), atol=1e-6)


def test_l2_penalty_counts_3d_and_transposed_conv_weights_only():
    net = random_net()
    kernels = [m.weight for m in net.modules()
               if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))]
    assert any(isinstance(m, nn.ConvTranspose3d) for m in net.modules())
    want = sum(float(torch.sum(w.detach().double() ** 2)) for w in kernels)
    assert float(_l2_penalty(net).detach()) == pytest.approx(want, rel=1e-6)
    with torch.no_grad():  # biases and BatchNorm parameters are not counted
        for m in net.modules():
            if hasattr(m, "bias") and isinstance(m.bias, torch.Tensor):
                m.bias.add_(5.0)
        for name, p in net.named_parameters():
            if ".bn" in name:
                p.add_(3.0)
    assert float(_l2_penalty(net).detach()) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the grid, the targets, the decode
# ---------------------------------------------------------------------------
def _port_and_plain(name, b):
    crops, com, cube, m, labels = b
    if name == "voxelize":
        return (voxel.voxelize(crops, com, cube, m, NYU_CAMERA),
                plain.voxelize(crops, com, cube, m, CAM))
    if name == "heatmap_targets":
        return voxel.heatmap_targets(labels), plain.heatmap_targets(labels)
    heat = torch.rand((len(crops), 14, 44, 44, 44), generator=torch.Generator().manual_seed(4))
    c3 = NYU_CAMERA.img_to_3d(com)
    return (voxel.decode_heatmaps(heat, c3, cube),
            plain.decode_heatmaps(heat, plain.img_to_3d(com, *CAM), cube))


@pytest.mark.parametrize("name", ["voxelize", "heatmap_targets", "decode_heatmaps"])
def test_grid_targets_and_decode_equal_the_reference_bit_for_bit(name):
    got, want = _port_and_plain(name, batch())
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    if name == "voxelize":  # a hand's points, not an empty or a full grid
        share = float(got.mean())
        assert 0.001 < share < 0.1


def test_decode_of_the_targets_gives_the_voxel_centres():
    crops, com, cube, m, labels = batch()
    c3 = NYU_CAMERA.img_to_3d(com)
    got = voxel.decode_heatmaps(voxel.heatmap_targets(labels), c3, cube)
    edge = (cube[:, 2] / 96.0)[:, None, None]
    t = (labels * 48.0 + 43.0) / 2.0  # each joint's centre on the 44^3 grid
    want = c3[:, None, :] + (2.0 * torch.round(t) - 43.0) * edge
    assert torch.allclose(got, want, atol=1e-3)
    # each within a voxel pair's half-width of its label
    assert float(((got - c3[:, None, :]) - labels * (cube[:, 2] / 2.0)[:, None, None])
                 .abs().max()) <= float(edge.max()) + 1e-3


@pytest.mark.parametrize("family", ["crop_regression", "v2v"])
def test_predict_joints_decodes_each_family_about_the_com(family):
    """``Trainer.predict_joints``, the main's decode for every family, at
    B = 2 over 5 rows (a padded tail), against the family's decode written
    out on the same batches: PoseRegNet's embedding through the PCA prior,
    scaled by cube_z / 2, plus the CoM (the main's decode before it took
    this path); V2V-PoseNet's argmax voxels about the CoM.  Both sides run
    the same float32 operations but for the CoM's sum: 1e-3 mm."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.models.family import CropRegression
    from deepprior_tpu_torch.train.trainer import TrainData

    crops, com, cube, m, _ = batch(b=5, seed=8)
    data = TrainData(crops, torch.zeros((5, 14, 3)), com, cube, m)
    c3 = NYU_CAMERA.img_to_3d(com)
    g = torch.Generator().manual_seed(9)
    prior = None
    if family == "v2v":
        net = random_net(seed=9)
    else:
        net = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30), generator=g)
        prior = PCAPrior(torch.randn((30, 42), generator=g) * 0.1,
                         torch.randn(42, generator=g) * 0.1)
    cfg = TrainConfig(batch_size=2, optimizer="rmsprop", seed=1)
    trainer = Trainer(net, cfg, NYU_CAMERA, prior=prior, device="cpu")
    assert isinstance(trainer.family, CropRegression) == (family != "v2v")
    state = trainer.init_state(state_dict=net.state_dict())
    got = trainer.predict_joints(state, data)
    net.eval()
    want = []
    with torch.no_grad():
        for rows in ([0, 1], [2, 3], [4, 4]):
            r = torch.tensor(rows)
            if family == "v2v":
                heat = net(voxel.voxelize(crops[r], com[r], cube[r], m[r], NYU_CAMERA,
                                          **SMALL)[:, None])
                want.append(voxel.decode_heatmaps(heat, c3[r], cube[r], SMALL["cube_voxels"]))
            else:
                d3 = prior.inverse_transform(net(crops[r][:, None])).reshape(2, -1, 3)
                want.append(d3 * (cube[r, 2] / 2.0)[:, None, None] + c3[r][:, None, :])
    want = torch.cat(want)[:5].numpy()
    assert got.shape == (5, 14, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _step(dtype):
    """One Trainer step of a random V2V-PoseNet computing in ``dtype`` at
    B = 4 (no augmentation, so the reference gets the same rows), with the
    spans recorded, and the reference's step from the same weights in the
    same precision."""
    net = random_net(seed=5, dtype=dtype)
    crops, com, cube, m, _ = batch(b=4, seed=6)
    gt3d = torch.rand((4, 14, 3), generator=torch.Generator().manual_seed(7)) * 200 - 100
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    cfg = TrainConfig(batch_size=4, optimizer="rmsprop", aug_modes=None, seed=1)
    trainer = Trainer(net, cfg, NYU_CAMERA, device="cpu")
    state = trainer.init_state(state_dict=start)
    rows = {"crops": crops, "gt3d_crop": gt3d, "com": com, "cube": cube, "m": m}
    lr = 2.5e-4
    profiling.clear()
    with profiling.recording():
        state, loss = trainer.train_step(state, rows, None, None, lr)
    spans = [s for s in profiling.spans() if s.name.startswith("train.")]
    grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
    after = {k: p.detach().clone() for k, p in state.model.named_parameters()}

    params = {k: start[k].to(dtype).requires_grad_(True) for k in after}
    w = dict({k: v.to(dtype) for k, v in start.items()}, **params)
    x = plain.voxelize(crops, com, cube, m, CAM, **SMALL)
    y = plain.heatmap_targets(gt3d / (cube[:, 2] / 2.0)[:, None, None], **SMALL)
    with torch.no_grad():
        ref_loss = plain.loss(plain.net(w, x[:, None].to(dtype), train=True), y)
    with torch.enable_grad():
        out = plain.net(w, x[:, None].to(dtype), train=True)
        ref_grads = dict(zip(params, torch.autograd.grad(plain.loss(out, y.to(dtype)),
                                                         list(params.values()))))
    # the reference RMSProp in float64 from the port's own gradients: the
    # optimizer's formula, apart from the gradients' gap
    moved = {k: start[k].double() for k in after}
    plain.RMSProp(moved).step({k: g.double() for k, g in grads.items()}, lr)
    return dict(loss=float(loss), ref_loss=float(ref_loss), grads=grads, ref_grads=ref_grads,
                start=start, after=after, ref_after=moved, stats=trainer.stats, x=x,
                spans=spans)


@pytest.fixture(scope="module")
def step32():
    return _step(torch.float32)


@pytest.fixture(scope="module")
def step64():
    """The same step computing in float64 (the parameters, gradients and
    RMSProp state stay float32 in the port): in float32 a random net's
    gradients are about 1e-3 off their float64 values in the worst leaf,
    more than any bound that would still catch a wrong formula."""
    return _step(torch.float64)


def _leaf_gap(got, want):
    """The worst leaf's norm of the difference, over the larger of the
    reference's norm of that leaf and of the median leaf (a conv bias in
    front of a train-mode BatchNorm has a zero gradient up to rounding)."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return max(float((got[k].double() - want[k].double()).norm()) / max(norms[k], med)
               for k in want)


@pytest.mark.parametrize("what", ["loss", "gradients", "update", "counters", "spans"])
def test_trainer_step_matches_the_reference_step(step32, step64, what):
    r = step32
    if what == "loss":
        # float32 on both sides, the same grid and targets bit for bit; the
        # network parts by round-off (BatchNorm's two forms): 1e-5 relative
        assert r["loss"] == pytest.approx(r["ref_loss"], rel=1e-5)
    elif what == "gradients":
        # float64 compute on both sides; the port's heatmaps are rounded to
        # float32 for the loss and its gradients stored in float32: 1e-6
        r = step64
        assert r["loss"] == pytest.approx(r["ref_loss"], rel=1e-6)
        assert _leaf_gap(r["grads"], r["ref_grads"]) < 1e-6
    elif what == "update":
        # the reference RMSProp from the same gradients in float64, the
        # port's in float32: each new parameter within two float32 ulps of
        # the largest of the old value, the new one and the change (the
        # float32 change carries an ulp of itself, the sum rounds once);
        # every kernel moved (a conv bias in front of a
        # train-mode BatchNorm has a gradient of rounding and may not)
        r = step64
        for k, got in r["after"].items():
            want = r["ref_after"][k].float()
            change = (r["ref_after"][k] - r["start"][k].double()).float()
            big = torch.maximum(torch.maximum(want.abs(), r["start"][k].abs()), change.abs())
            ulp = torch.nextafter(big, torch.tensor(float("inf"))) - big
            assert torch.all((got - want).abs() <= 2 * ulp), k
            assert r["start"][k].dim() < 2 or not torch.equal(got, r["start"][k]), k
    elif what == "counters":
        st = r["stats"]
        assert st["voxels_set"].dtype == torch.int64 and st["voxels_set"].dim() == 0
        assert int(st["voxels_set"]) == int(r["x"].sum())
        assert int(st["voxels_seen"]) == 4 * 24 ** 3
    else:
        names = [s.name for s in r["spans"]]
        for name in ("train.voxelize", "train.targets"):
            assert names.count(name) == 1
            s = next(s for s in r["spans"] if s.name == name)
            assert s.attrs == {"batch": 4, "grid": 24, "joints": 14}
        outer = next(s for s in r["spans"] if s.name == "train.step")
        inner = [s for s in r["spans"] if s.name in ("train.voxelize", "train.targets")]
        assert all(outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns for s in inner)


# ---------------------------------------------------------------------------
# the main, the checkpoint, the refusals
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``--model v2v`` through the NYU main on 16 synthetic frames at B = 8
    for one epoch (two steps), on a 24^3 grid."""
    out = tmp_path_factory.mktemp("v2v_main")
    state, results, hist = main_nyu_posereg_embedding.main(
        ["--synthetic", "--model", "v2v", "--epochs", "1", "--nmax", "16", "--out",
         str(out), "--device", "cpu"], v2v=SMALL)
    return out, state, results, hist


def test_main_trains_v2v_through_fit(trained):
    out, state, results, hist = trained
    assert state.step == 2 and len(hist["train_cost"]) == 2
    assert np.isfinite(hist["train_cost"]).all() and len(hist["val_error_mm"]) == 1
    assert isinstance(state.optimizer, __import__(
        "deepprior_tpu_torch.train.optimizer", fromlist=["ReferenceRMSProp"]).ReferenceRMSProp)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(2.5e-5)  # lr_of_ep(0)
    assert set(results) == {"test_1", "test_2"}
    for ev in results.values():  # the decoded joints lie inside the cube
        assert 0.0 < ev.getMeanError() < 300.0


def test_checkpoint_round_trip(trained):
    from deepprior_tpu_torch.train.checkpoint import load_checkpoint, read_checkpoint

    out, state, _, _ = trained
    path = os.path.join(str(out), "train_V2V", "network_prior.ckpt")
    stored = read_checkpoint(path)
    assert stored[2] == "v2v"
    fresh = V2VPoseNet(V2VConfig(**SMALL))
    tree, exact = load_checkpoint(path, {"params": fresh.state_dict()}, stored=stored)
    fresh.load_state_dict(tree["params"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v.cpu()), k


@pytest.mark.parametrize("entry", ["distributed"])
def test_serving_and_distributed_entry_points_refuse_v2v(trained, entry):
    net = V2VPoseNet(V2VConfig(**SMALL))
    with pytest.raises(ValueError, match="one device only"):
        from deepprior_tpu_torch.parallel import DistributedTrainer

        DistributedTrainer(net, TrainConfig(batch_size=8, optimizer="rmsprop"),
                           NYU_CAMERA, mesh=None, device="cpu")


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
CUBE = (300.0, 300.0, 300.0)
SERVE_CFG = {  # the benchmark's configuration at the small grid
    "model": dict(SMALL), "input_hw": 128, "cube_mm": list(CUBE),
    "camera": {"fx": NYU_CAMERA.fx, "fy": NYU_CAMERA.fy, "ux": NYU_CAMERA.ux,
               "uy": NYU_CAMERA.uy, "flip_y": NYU_CAMERA.flip_y, "width": 640, "height": 480}}


def frames(n=3, seed=11):
    from deepprior_tpu_torch.data.synthetic import make_depth_frame

    rng = np.random.default_rng(seed)
    made = [make_depth_frame(NYU_CAMERA, rng) for _ in range(n)]
    return (torch.from_numpy(np.stack([d for d, _ in made])),
            torch.from_numpy(np.stack([c for _, c in made])))


@pytest.fixture(scope="module")
def served():
    """A random V2V-PoseNet (random BatchNorm statistics too) in eval mode
    behind a CPU FusedEstimator with the 300 mm cube, and three rendered
    NYU frames."""
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    net = random_net(seed=12)
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.5, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    est = FusedEstimator(net, NYU_CAMERA, cube=CUBE, device="cpu")
    return est, net, *frames()


@pytest.mark.parametrize("mirrored", [False, True], ids=["plain", "mirror"])
def test_estimator_matches_the_serving_reference(served, mirrored):
    """The eager estimator against the plain reference on the same weights:
    the grids bit for bit (the same float32 operations), the heatmaps within
    1e-5 of their largest magnitude (BatchNorm's two forms, as above), the
    joints bit for bit (the same argmax voxels; none is close here).  A
    mirrored row's heatmaps are the network's on the grid flipped along x,
    and its relative x is negated."""
    from bench_torch.reference import serve_v2v

    est, net, depth, com = served
    mirror = torch.tensor([True, False, True]) if mirrored else None
    joints, com3d, crops, grid, heat = est(depth, com, mirror=mirror)
    weights = {k: v.detach() for k, v in net.state_dict().items()}
    cube = torch.tensor(CUBE).expand(3, 3)
    ref_grid, ref_heat, ref_joints = serve_v2v.pipeline(SERVE_CFG, weights, depth, com, cube,
                                                         mirror=mirror)
    assert grid.shape == (3, 24, 24, 24) and heat.shape == (3, 14, 12, 12, 12)
    assert torch.equal(grid, ref_grid) and 0.001 < float(grid.mean()) < 0.2
    scale = float(ref_heat.abs().max())
    assert float((heat - ref_heat).abs().max()) <= 1e-5 * scale
    assert torch.equal(joints, ref_joints)
    if mirrored:
        with torch.no_grad():
            flipped = net(grid[0:1, None].flip(2))
        assert float((heat[0:1] - flipped).abs().max()) <= 1e-6 * scale
        rel = voxel.decode_heatmaps(flipped, torch.zeros((1, 3)), cube[:1], 32)
        assert torch.equal(joints[0, :, 0], com3d[0, 0] - rel[0, :, 0])
        assert torch.equal(joints[0, :, 1:], com3d[0, 1:] + rel[0, :, 1:])


def test_server_answers_equal_the_eager_estimator(served):
    """MicroBatchServer (graph=False, max_batch 4) over the estimator, five
    requests in padded batches, two of them mirrored and one with its own
    cube: each answer equals the eager estimator's on a batch of that
    request alone, repeated to the server's batch."""
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer

    est, _, depth, com = served
    reqs = [(0, False, None), (1, True, None), (2, False, (280.0,) * 3), (0, True, None),
            (2, False, None)]
    with MicroBatchServer(est, max_batch=4, max_wait_ms=50.0, graph=False) as server:
        futs = [server.submit(depth[i].numpy(), com[i].numpy(), cube=c, mirror=m)
                for i, m, c in reqs]
        got = [f.result(timeout=300) for f in futs]
        batches = server.stats["batches"]
    assert batches >= 2  # at least one batch was padded
    for (i, m, c), answer in zip(reqs, got):
        want = est(depth[[i] * 4], com[[i] * 4], cube=c, mirror=[m] * 4)[0][0]
        assert np.array_equal(answer, want.numpy()), (i, m, c)


def test_estimator_counts_rows_and_voxels(served):
    """``stats`` after two calls: the rows computed and the grids' occupied
    and offered voxels, 0-d int64 tensors on the estimator's device."""
    est, _, depth, com = served
    for v in est.stats.values():
        v.zero_()
    grids = [est(depth, com)[3], est(depth[:2], com[:2])[3]]
    st = est.stats
    assert all(v.dtype == torch.int64 and v.dim() == 0 for v in st.values())
    assert int(st["rows"]) == 5
    assert int(st["voxels_set"]) == sum(int(torch.count_nonzero(g)) for g in grids) > 0
    assert int(st["voxels_seen"]) == 5 * 24 ** 3


@pytest.mark.parametrize("family", ["posereg", "v2v"])
def test_family_declares_the_estimators_outputs_and_whether_it_freezes(served, family):
    """The estimator returns (joints, com3d, crops) and the family's
    ``extras``: nothing for a crop regressor, which an artifact may freeze;
    V2V-PoseNet's grids and heatmaps, which it may not."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.models.family import CropRegression
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    est, net, depth, com = served
    if family == "posereg":
        net = PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=42),
                         generator=torch.Generator().manual_seed(16)).eval()
        est = FusedEstimator(net, NYU_CAMERA, cube=CUBE, device="cpu")
    out = est(depth[:1], com[:1])
    fam = est.family
    assert isinstance(fam, CropRegression) == (family == "posereg")
    assert fam.freezes == (family == "posereg")
    assert len(out) == (3 if family == "posereg" else 5)
    assert [t.shape[1:] for t in out[1:3]] == [(3,), (128, 128)] and out[0].shape[2] == 3


@pytest.mark.parametrize("case", ["plain", "mirror_invx_invy"])
def test_crop_regressors_joints_through_the_family_equal_the_old_formula(case):
    """PoseRegNet with a PCA prior through ``CropRegression``: the joints
    bit-equal to the estimator's formula before the family seam (the pose
    flipped by +-1, then scaled by cube_z / 2, plus the CoM)."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
    from deepprior_tpu_torch.ops.crop import clamp_depth, normalized_crop
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    g = torch.Generator().manual_seed(14)
    net = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30), generator=g).eval()
    prior = PCAPrior(torch.randn((30, 42), generator=g) * 0.1, torch.randn(42, generator=g) * 0.1)
    est = FusedEstimator(net, NYU_CAMERA, cube=CUBE, prior=prior, device="cpu")
    depth, com = frames(seed=15)
    flips = dict(mirror=[True, False, True], invx=True, invy=True) if case != "plain" else {}
    joints, com3d, crops = est(depth, com, **flips)
    mirror = torch.tensor(flips.get("mirror", [False] * 3))
    cube = torch.tensor(CUBE).expand(3, 3)
    want_crops, _ = normalized_crop(clamp_depth(depth)[0], com, cube, NYU_CAMERA.fx,
                                    NYU_CAMERA.fy, (128, 128), method="gather")
    net_in = torch.where(mirror[:, None, None], want_crops.flip(-1), want_crops)
    with torch.no_grad():
        pose = prior.inverse_transform(net(net_in[:, None])).reshape(3, -1, 3)
    flip = torch.ones((3, 3))
    if flips:
        flip[:, 1] = -1.0
        flip[:, 0] = -1.0
    flip[:, 0] = flip[:, 0] * torch.where(mirror, -1.0, 1.0)
    want = (pose * flip[:, None, :]) * (cube[:, 2] / 2.0)[:, None, None] + com3d[:, None, :]
    assert torch.equal(crops, want_crops)
    assert torch.equal(joints, want)


@pytest.mark.parametrize("case", ["checkpoint", "other_family"])
def test_load_serving_net_builds_v2v_from_its_checkpoint(trained, case):
    """``load_serving_net("v2v", checkpoint=)`` builds the checkpoint's
    V2V-PoseNet (its grid and joints) with its weights and no prior, which
    ``serve_http --model v2v`` serves; the checkpoint under another family's
    name raises ValueError naming it."""
    from deepprior_tpu_torch.mains import serve_http

    out, state = trained[:2]
    path = os.path.join(str(out), "train_V2V", "network_prior.ckpt")
    if case == "other_family":
        with pytest.raises(ValueError, match="holds a v2v"):
            common.load_serving_net("poseregnet", device="cpu", checkpoint=path)
        return
    model, prior = common.load_serving_net("v2v", device="cpu", checkpoint=path)
    assert prior is None and isinstance(model, V2VPoseNet)
    assert (model.cfg.grid, model.cfg.cube_voxels, model.cfg.num_joints) == (24, 32, 14)
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v.cpu()), k
    args = serve_http.build_parser().parse_args(
        ["--model", "v2v", "--checkpoint", path, "--device", "cpu", "--max-batch", "2"])
    server = serve_http.build_server(args)
    try:
        depth, com = frames(n=1, seed=16)
        answer = server.submit(depth[0].numpy(), com[0].numpy()).result(timeout=300)
    finally:
        server.close()
    assert answer.shape == (14, 3)
    want = server.est(depth[[0, 0]], com[[0, 0]])[0][0]
    assert np.array_equal(answer, want.numpy())


@pytest.mark.parametrize("entry", ["export", "dp"])
def test_frozen_and_sharded_serving_refuse_v2v(tmp_path, entry):
    """The artifact export and ``serve_http --dp`` (ShardedEstimator) raise
    ValueError naming V2VPoseNet."""
    from deepprior_tpu_torch.mains import serve_http
    from deepprior_tpu_torch.realtime import export
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    with pytest.raises(ValueError, match="V2VPoseNet"):
        if entry == "export":
            est = FusedEstimator(V2VPoseNet(V2VConfig(**SMALL)), NYU_CAMERA, device="cpu")
            export.export_serving(est, 2, (480, 640), str(tmp_path / "v2v.dpx"))
        else:
            serve_http.build_server(serve_http.build_parser().parse_args(
                ["--model", "v2v", "--device", "cpu", "--dp", "2", "--max-batch", "4"]))
