"""A2J on the port (models/a2j.py, the trainer's family seam, Adam's weight
decay, ``--model a2j``) held against the benchmark's plain reference
``bench_torch/reference/a2j.py`` on the CPU: the network at the published
widths on a 64x64 crop (a 4x4 map of 256 anchors) with J = 3, B = 2 and
seeded random weights.  The network, the vote, the loss and one Trainer
step with Adam's decay run in float64 on both sides, so that their
tolerances speak of the arithmetic, not of float32's rounding through 60
BatchNorm layers; the targets' round trip through the crop transform and
the camera runs in float32, as the program does.  Also: the published size,
the zero decay's bits and launches, the crop regressors' and V2V-PoseNet's
bits through the widened seam, the NYU main, and the refusals of the
serving and sharded entry points."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench_torch.models import a2j_flops
from bench_torch.reference import a2j as plain
from bench_torch.reference import geometry as G
from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.mains import common, main_nyu_posereg_embedding
from deepprior_tpu_torch.models.a2j import A2J, A2JConfig, anchors
from deepprior_tpu_torch.ops.crop import crop_transform
from deepprior_tpu_torch.train.optimizer import ReferenceAdam
from deepprior_tpu_torch.train.trainer import TrainConfig, Trainer

HW, J, B = 64, 3, 2
SIDE = HW // 16
CAM = G.Camera(NYU_CAMERA.fx, NYU_CAMERA.fy, NYU_CAMERA.ux, NYU_CAMERA.uy, NYU_CAMERA.flip_y,
               640, 480)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Small CPU runs beside other test workers: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_net(seed=0, dtype=torch.float64, hw=HW, joints=J):
    """An A2J with He-normal convolutions (``reset_parameters``) and random
    BatchNorm scales and shifts and head biases, so that every leaf's
    gradient is exercised."""
    net = A2J(A2JConfig(num_joints=joints, input_hw=hw, dtype=dtype),
              generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1 and name.endswith("weight"):
                p.uniform_(0.5, 1.5, generator=gen)
            elif p.dim() == 1:
                p.normal_(0.0, 0.1, generator=gen)
    return net.to(dtype)


def crop_batch(b=B, seed=1, hw=HW, dtype=torch.float32):
    """Random normalized crops, CoMs, cubes, their crop transforms and
    labels normalized by cube_z / 2."""
    g = torch.Generator().manual_seed(seed)
    crops = torch.rand((b, hw, hw), generator=g) * 2.0 - 1.0
    com = torch.stack([torch.rand(b, generator=g) * 200 + 220, torch.rand(b, generator=g) * 160
                       + 160, torch.rand(b, generator=g) * 400 + 500], dim=1)
    cube = torch.tensor([220.0, 220.0, 300.0]).expand(b, 3).contiguous()
    m = crop_transform(com, cube, NYU_CAMERA.fx, NYU_CAMERA.fy, (480, 640), (hw, hw))
    labels = torch.rand((b, J, 3), generator=g) * 1.2 - 0.6
    return {k: v.to(dtype) for k, v in dict(crops=crops, com=com, cube=cube, m=m,
                                             labels=labels).items()}


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def test_published_size_counts_parameters_and_flops():
    """At 176x176 and J = 14: 42,687,424 parameters, 12.30 GFLOP a forward
    sample and 36.76 a training step's, counted on the reference and on the
    port alike; the configuration states both numbers."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = A2J()
    assert sum(p.numel() for p in net.parameters()) == 42_687_424
    layout = net.state_dict()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        out = net(torch.empty((1, 1, 176, 176), device="meta"))
    assert counter.get_total_flops() == a2j_flops.forward_flops(layout, 1)
    assert round(a2j_flops.forward_flops(layout, 1) / 1e9, 2) == 12.30
    assert round(a2j_flops.train_step_flops(layout, 1) / 1e9, 2) == 36.76
    assert [tuple(t.shape) for t in out] == [(1, 1936, 14), (1, 1936, 14, 2), (1, 1936, 14)]
    with open(os.path.join(os.path.dirname(__file__), "..", "bench_torch", "configs",
                           "a2j_nyu.json")) as fh:
        cfg = json.load(fh)
    assert (cfg["model"]["params"], cfg["model"]["forward_gflop"]) == (42_687_424, 12.30)


@pytest.fixture(scope="module")
def stepped():
    """One Trainer step (Adam, weight decay 1e-4, no augmentation) of a
    float64 A2J, and the reference's forward, loss, gradients and decayed
    Adam step on the same weights and batch, in float64."""
    net = random_net(seed=3)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    bt = crop_batch(seed=4, dtype=torch.float64)
    gt3d = bt["labels"] * (bt["cube"][:, 2] / 2.0)[:, None, None]
    batch = {k: bt[k] for k in ("crops", "com", "cube", "m")}
    batch["gt3d_crop"] = gt3d
    lr = 3.5e-5
    cfg = TrainConfig(batch_size=B, optimizer="adam", aug_modes=None)
    trainer = Trainer(net, cfg, NYU_CAMERA, device="cpu", weight_decay=1e-4)
    state = trainer.init_state(state_dict=start)
    # the targets the step made (the camera projects in float32, whatever
    # the model's precision), which the reference then trains on
    made = []
    targets = net.targets
    net.targets = lambda *a, **k: made.append(targets(*a, **k)) or made[-1]
    state, loss = trainer.train_step(state, batch, None, None, lr)
    del net.targets
    prog = {"loss": float(loss),
            "grads": {k: p.grad.clone() for k, p in state.model.named_parameters()},
            "params": {k: p.detach().clone() for k, p in state.model.named_parameters()}}

    params = {k: start[k].clone().requires_grad_(True) for k in prog["grads"]}
    y = made[0]
    out = plain.net(params, bt["crops"][:, None], J)
    value = plain.loss(out, y, SIDE)
    grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
    opt = plain.DecayedAdam(params, weight_decay=1e-4)
    opt.step(grads, lr)
    ref = {"loss": float(value.detach()), "grads": grads,
           "params": {k: p.detach() for k, p in params.items()}, "out": out, "y": y}
    return net, start, bt, prog, ref


def test_forward_outputs_and_layout_match_the_reference(stepped):
    """cls (B, N, J), reg (B, N, J, 2), dep (B, N, J) at N = 4 x 4 x 16, in
    training mode, within rtol 1e-9 (float64: two BatchNorm formulas)."""
    net, start, bt, _, ref = stepped
    probe = random_net(seed=3)
    probe.load_state_dict(start)
    probe.train()
    with torch.no_grad():
        got = probe(bt["crops"][:, None])
    assert [tuple(t.shape) for t in got] == [(B, 256, J), (B, 256, J, 2), (B, 256, J)]
    for a, b in zip(got, ref["out"]):
        torch.testing.assert_close(a, b.detach(), rtol=1e-9, atol=1e-9)


def test_heads_are_read_width_height_channel():
    """The release's permute(0, 3, 2, 1): output n = (w H' + h) 16 + a, joint
    j is channel a J + j (and (a J + j) 2 + k for the offsets) of the head's
    map at row h, column w."""
    net = random_net(seed=5).eval()
    maps = {}
    for name in ("cls", "reg"):
        getattr(net, name).register_forward_hook(
            lambda mod, args, out, name=name: maps.__setitem__(name, out))
    with torch.no_grad():
        cls, reg, _ = net(crop_batch(seed=6, dtype=torch.float64)["crops"][:, None])
    for w, h, a, j in ((0, 0, 0, 0), (1, 2, 5, 1), (3, 1, 15, 2), (2, 3, 9, 0)):
        n = (w * SIDE + h) * 16 + a
        assert cls[1, n, j] == maps["cls"][1, a * J + j, h, w]
        for k in range(2):
            assert reg[1, n, j, k] == maps["reg"][1, (a * J + j) * 2 + k, h, w]


def test_anchors_sit_at_the_release_positions():
    """Anchor n = (w 11 + h) 16 + 4 i + j at (16 h + P[i], 16 w + P[j]), P =
    (2, 6, 10, 14): the port's and the reference's, 1,936 at 11x11."""
    got = anchors(11, 11)
    assert got.shape == (1936, 2)
    assert torch.equal(got, plain.anchors(11, "cpu"))
    for w, h, i, j in ((0, 0, 0, 0), (0, 1, 1, 3), (10, 4, 3, 2)):
        n = (w * 11 + h) * 16 + 4 * i + j
        assert got[n].tolist() == [16 * h + (2, 6, 10, 14)[i], 16 * w + (2, 6, 10, 14)[j]]


def test_vote_and_loss_match_the_reference(stepped):
    """The softmax vote and the A2J loss on the same outputs and targets,
    float64, rtol 1e-12 (the port sums the vote elementwise, the reference
    by einsum)."""
    net, _, _, _, ref = stepped
    out = tuple(t.detach() for t in ref["out"])
    for a, b in zip(net.vote(out), plain.vote(out, SIDE)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(net.loss(out, ref["y"]), plain.loss(out, ref["y"], SIDE),
                               rtol=1e-12, atol=0.0)


def test_trainer_step_matches_the_reference_step(stepped):
    """One Trainer step against the reference, float64: the loss within rtol
    1e-10; every leaf's gradient within rtol 1e-7 of its norm (BatchNorm's
    two formulas through 60 layers); every parameter after Adam's decayed
    step within 1e-5 x lr: the first step moves a weight by lr g / (|g| +
    1e-8), so a gradient's relative rounding r moves it by at most lr r,
    while the decay, 1e-4 p, moves the weights of small gradients by up to
    2 lr."""
    _, _, _, prog, ref = stepped
    assert prog["loss"] == pytest.approx(ref["loss"], rel=1e-10)
    assert set(prog["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        gap = float((prog["grads"][k] - g).norm())
        assert gap <= 1e-7 * float(g.norm()) + 1e-12, k
        diff = (prog["params"][k] - ref["params"][k]).abs()
        assert float(diff.max()) <= 1e-5 * 3.5e-5, k


def test_adam_step_with_decay_matches_the_reference():
    """ReferenceAdam(weight_decay=1e-4) against the reference's DecayedAdam
    over three float32 steps on the same gradients: parameters and moments
    within rtol 1e-6 (an ulp of the bias corrections' pow)."""
    g = torch.Generator().manual_seed(7)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    init = [torch.randn(s, generator=g) for s in shapes]
    mine = [torch.nn.Parameter(t.clone()) for t in init]
    opt = ReferenceAdam(mine, lr=0.0, weight_decay=1e-4)
    ref = {str(i): t.clone() for i, t in enumerate(init)}
    radam = plain.DecayedAdam(ref, weight_decay=1e-4)
    for lr in (3.5e-5, 3.5e-5, 1.2e-4):
        grads = [torch.randn(s, generator=g) * 1e-3 for s in shapes]
        for p, x in zip(mine, grads):
            p.grad = x
        opt.param_groups[0]["lr"] = lr
        opt.step()
        radam.step({str(i): x for i, x in enumerate(grads)}, lr)
    for i, p in enumerate(mine):
        torch.testing.assert_close(p.detach(), ref[str(i)], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(opt.state[p]["mu"], radam.mu[str(i)], rtol=1e-6, atol=1e-12)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("profiler."):  # the optimizer's record_function
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _adam_step(weight_decay, explicit=True):
    g = torch.Generator().manual_seed(8)
    params = [torch.nn.Parameter(torch.randn(s, generator=g)) for s in ((4, 3), (6,))]
    kw = {"weight_decay": weight_decay} if explicit else {}
    opt = ReferenceAdam(params, lr=1e-3, **kw)
    for p in params:  # small enough that a decay of 1e-4 p turns some steps
        p.grad = torch.randn(p.shape, generator=g) * 1e-5
    with _Ops() as seen:
        opt.step()
    return [p.detach() for p in params], seen.ops


def test_adam_at_zero_decay_gives_the_same_bits_and_operations():
    """ReferenceAdam at weight_decay 0 runs the very operations it ran
    without the option, and gives the same bits; a decay adds one foreach
    add (one launch of the fused kernel for all the parameters on a card)."""
    plain_params, plain_ops = _adam_step(0.0, explicit=False)
    zero_params, zero_ops = _adam_step(0.0)
    decayed_params, decayed_ops = _adam_step(1e-4)
    assert zero_ops == plain_ops
    for a, b in zip(zero_params, plain_params):
        assert torch.equal(a, b)
    assert len(decayed_ops) == len(plain_ops) + 1
    assert decayed_ops[0] == "aten._foreach_add.List"
    assert not all(torch.equal(a, b) for a, b in zip(decayed_params, plain_params))


# ---------------------------------------------------------------------------
# the targets, the joints, the mirror
# ---------------------------------------------------------------------------
def test_targets_to_joints_round_trip_through_the_crop_and_the_camera():
    """At 176x176, float32: targets of labels, then the joints of a vote
    that puts all its weight on one anchor whose offset and depth are the
    targets, give back labels x cube_z / 2 (mm about the CoM) within 2e-3
    mm (float32 through the projection, m, m^-1 and the back-projection of
    points about 700 mm away); the port's targets equal the reference's bit
    for bit (the same operations in the same order)."""
    bt = crop_batch(b=4, seed=9, hw=176)
    net = A2J(A2JConfig(num_joints=J))
    y = net.targets(bt["labels"], batch=bt, camera=NYU_CAMERA)
    assert torch.equal(y, plain.targets(bt["labels"], bt["com"], bt["cube"], bt["m"], CAM))
    assert float(y[..., :2].min()) > 0.0 and float(y[..., :2].max()) < 176.0
    n = 1936
    cls = torch.full((4, n, J), -1e4)
    cls[:, 7] = 0.0
    reg = torch.zeros((4, n, J, 2))
    reg[:, 7] = y[..., :2] - anchors(11, 11)[7]
    dep = torch.zeros((4, n, J))
    dep[:, 7] = y[..., 2]
    got = net.joints((cls, reg, dep), bt, camera=NYU_CAMERA)
    want = bt["labels"] * (bt["cube"][:, 2] / 2.0)[:, None, None]
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    ref = plain.joints((cls, reg, dep), bt["com"], bt["m"], CAM, 11)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-3)


def test_a_right_hand_is_mirrored_along_the_crop_width():
    """The family mirrors a right hand's (B, 1, H, W) input along its width,
    as the crop regressors do and as the reference defines it."""
    from deepprior_tpu_torch.models.family import CropRegression

    assert A2J.mirror_dim == plain.MIRROR_DIM == CropRegression.mirror_dim == -1
    bt = crop_batch(seed=10)
    x = A2J(A2JConfig(num_joints=J, input_hw=HW)).inputs(bt, NYU_CAMERA)
    assert x.shape == (B, 1, HW, HW)
    assert torch.equal(x.flip(A2J.mirror_dim)[:, 0], bt["crops"].flip(2))


# ---------------------------------------------------------------------------
# the other families through the widened seam
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["posereg_prior", "posereg_joints", "v2v"])
def test_other_families_give_the_same_bits_through_the_widened_seam(family):
    """``targets``, ``joints`` and ``rows`` with the seam's new ``batch`` and
    ``camera`` give the bits of the calls without them, which the trainer
    and the estimator made before: PoseRegNet with and without a PCA prior
    (``CropRegression``) and V2V-PoseNet (a 24^3 grid)."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, V2VConfig, V2VPoseNet
    from deepprior_tpu_torch.models.family import family_of
    from deepprior_tpu_torch.ops import voxel
    from deepprior_tpu_torch.prior import PCAPrior

    g = torch.Generator().manual_seed(11)
    bt = crop_batch(b=3, seed=12, hw=128)
    batch = {k: bt[k] for k in ("crops", "com", "cube", "m")}
    labels = torch.rand((3, 14, 3), generator=g) - 0.5
    batch["gt3d_crop"] = labels * (batch["cube"][:, 2] / 2.0)[:, None, None]
    if family == "v2v":
        net = V2VPoseNet(V2VConfig(grid=24, cube_voxels=32)).eval()
        fam = family_of(net)
        x = voxel.voxelize(batch["crops"], batch["com"], batch["cube"], batch["m"], NYU_CAMERA,
                           24, 32)[:, None]
    else:
        prior = None
        if family == "posereg_prior":
            prior = PCAPrior(torch.randn((30, 42), generator=g) * 0.1,
                             torch.randn(42, generator=g) * 0.1)
        net = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30 if prior else 42),
                         generator=g).eval()
        fam = family_of(net, prior)
        x = batch["crops"][:, None]
    with torch.no_grad():
        out = net(x)
    kw = {"batch": batch, "camera": NYU_CAMERA}
    assert torch.equal(fam.targets(labels, 5, **kw), fam.targets(labels, 5))
    assert torch.equal(fam.joints(out, batch, camera=NYU_CAMERA), fam.joints(out, batch))
    y = fam.targets(labels)
    for a, b in zip(fam.rows(out, y, batch, camera=NYU_CAMERA), fam.rows(out, y, batch)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the main, the refusals
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``--model a2j`` through the NYU main on 16 synthetic 64x64 frames at
    B = 8 for one epoch (two steps)."""
    out = tmp_path_factory.mktemp("a2j_main")
    state, results, hist = main_nyu_posereg_embedding.main(
        ["--synthetic", "--model", "a2j", "--epochs", "1", "--nmax", "16", "--batch-size", "8",
         "--out", str(out), "--device", "cpu"], a2j=dict(input_hw=HW))
    return out, state, results, hist


def test_main_trains_a2j_through_fit(trained):
    """Two steps of Adam with A2J's decay at lr_of_ep(0) of 3.5e-4, a finite
    cost, the test sequences decoded to mm, and the checkpoint's fingerprint
    naming the family and its crop size."""
    from deepprior_tpu_torch.train.checkpoint import checkpoint_config

    out, state, results, hist = trained
    assert state.step == 2 and len(hist["train_cost"]) == 2
    assert np.isfinite(hist["train_cost"]).all() and len(hist["val_error_mm"]) == 1
    assert isinstance(state.optimizer, ReferenceAdam)
    group = state.optimizer.param_groups[0]
    assert group["lr"] == pytest.approx(3.5e-5) and group["weight_decay"] == 1e-4
    assert set(results) == {"test_1", "test_2"}
    for ev in results.values():
        assert np.isfinite(ev.getMeanError())
    config = checkpoint_config(os.path.join(str(out), "train_A2J", "network_prior.ckpt"))
    assert (config["model"], config["input_hw"], config["num_joints"]) == ("a2j", HW, 14)
    assert config["weight_decay"] == 1e-4 and config["batch_size"] == 8


def test_main_crops_at_the_models_size():
    """The synthetic frames and the importers' crops take A2J's size: the
    sequence's crops are 176x176 and an importer's cache name carries it."""
    from deepprior_tpu_torch.data.importers import NYUImporter
    from deepprior_tpu_torch.data.synthetic import make_sequence

    seq = make_sequence(NYU_CAMERA, 2, dsize=(176, 176))
    assert seq.data[0].dpt.shape == (176, 176)
    imp = NYUImporter("/nonexistent", cache_dir="cache", device="cpu")
    at128 = imp._cache_path("train", False, (300, 300, 300))
    assert imp._cache_path("train", False, (300, 300, 300), dsize=(128, 128)) == at128
    assert imp._cache_path("train", False, (300, 300, 300), dsize=(176, 176)) != at128


@pytest.mark.parametrize("entry", ["serving_net", "estimator", "distributed", "weightreg",
                                   "rmsprop_decay"])
def test_serving_and_distributed_entry_points_refuse_a2j(entry, tmp_path):
    """Serving and sharding refuse A2J; so do a second, loss-side decay
    beside its Adam's (--weightreg) and a decay on another optimizer."""
    from deepprior_tpu_torch.parallel import DistributedTrainer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.train.optimizer import make_optimizer

    net = A2J(A2JConfig(num_joints=J, input_hw=HW))
    if entry == "serving_net":
        with pytest.raises(ValueError, match="A2J is not served yet"):
            common.load_serving_net("a2j", device="cpu")
    elif entry == "estimator":
        with pytest.raises(ValueError, match="A2J is not served yet"):
            FusedEstimator(net, NYU_CAMERA, device="cpu")
    elif entry == "distributed":
        with pytest.raises(ValueError, match="one device only"):
            DistributedTrainer(net, TrainConfig(batch_size=8), NYU_CAMERA, mesh=None,
                               device="cpu")
    elif entry == "weightreg":
        with pytest.raises(ValueError, match="--weightreg does not go with --model a2j"):
            main_nyu_posereg_embedding.main(
                ["--synthetic", "--model", "a2j", "--weightreg", "1e-4", "--epochs", "1",
                 "--nmax", "8", "--out", str(tmp_path), "--device", "cpu"])
        assert not os.listdir(tmp_path)  # refused before anything was made
    else:
        with pytest.raises(ValueError, match="Adam's only"):
            make_optimizer("rmsprop", net.parameters(), weight_decay=1e-4)


def test_the_reference_imports_nothing_of_the_program():
    """bench_torch/reference/a2j.py and the reference modules it imports name
    neither the port nor the JAX package nor jax."""
    import ast

    root = os.path.join(os.path.dirname(__file__), "..", "bench_torch", "reference")
    seen, todo = set(), ["a2j"]
    while todo:
        name = todo.pop()
        seen.add(name)
        with open(os.path.join(root, f"{name}.py")) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for mod in mods:
                assert not mod.startswith(("deepprior_tpu", "jax")), (name, mod)
                if mod.startswith("bench_torch.reference."):
                    sub = mod.split(".")[2]
                    if sub not in seen and os.path.isfile(os.path.join(root, f"{sub}.py")):
                        todo.append(sub)
    assert {"a2j", "geometry", "nets", "v2v"} <= seen
