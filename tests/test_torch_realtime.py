"""The port's realtime serving path against the JAX package, on the CPU.

Weights: a float32 flax PoseRegNet (hidden 64) with a (30, 42) PCA prior
and a flax ScaleNet (hidden 64), converted to the port.  Frames: the
synthetic camera devices of both packages, which agree bit for bit from
one seed, at ICVL's 320x240.

- FusedEstimator(detect=True / refine_iters / resize=...) against the JAX
  estimator: CoMs within rtol 1e-4, atol 1e-2 (float32 sums in another
  order, tests/test_torch_com.py), crops within atol 1e-4 and joints
  within 1e-2 mm.  The JAX estimator takes its one-hot crop for 'linear'
  (separable summation order); the port's crop is the gather.
- RealtimeHandposePipeline against the JAX pipeline on the same frames,
  through the 'i', 'h' and 't' keys: the state machine equal, CoMs and
  joints within the same bounds; device detection against the host
  HandCropper path within 0.5 px/mm (the JAX package's bound,
  tests/test_com.py).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepprior_tpu.camera import ICVL_CAMERA as JAX_ICVL
from deepprior_tpu.camera import NYU_CAMERA as JAX_NYU
from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
from deepprior_tpu.models.scalenet import ScaleNet as FlaxScaleNet
from deepprior_tpu.models.scalenet import ScaleNetConfig as FlaxScaleConfig
from deepprior_tpu.ops.refine_cnn import CNNComRefiner as JaxRefiner
from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
from deepprior_tpu.realtime import camera as jcamera
from deepprior_tpu.realtime import pipeline as jpipeline
from deepprior_tpu.realtime.fused import FusedEstimator as JaxFusedEstimator

from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.device import default_device
from deepprior_tpu_torch.mains import demo_realtime
from deepprior_tpu_torch.models import (PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig,
                                        ScaleNet, ScaleNetConfig)
from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.realtime import camera as tcamera
from deepprior_tpu_torch.realtime import pipeline as tpipeline
from deepprior_tpu_torch.realtime.fused import FusedEstimator
from deepprior_tpu_torch.train.checkpoint import save_checkpoint
from deepprior_tpu_torch.utils.refweights import reference_pickle_from_state_dict
from deepprior_tpu_torch.utils.convert import (
    poseregnet_state_dict_from_flax,
    scalenet_state_dict_from_flax,
)

COM_TOL = dict(rtol=1e-4, atol=1e-2)
JOINT_ATOL = 1e-2
CFG = {"fx": ICVL_CAMERA.fx, "fy": ICVL_CAMERA.fy, "cube": (250.0, 250.0, 250.0)}


@pytest.fixture(scope="module")
def nets():
    """(flax PoseRegNet, variables, port PoseRegNet, JAX prior, port prior,
    flax ScaleNet, variables, port ScaleNet)."""
    fpose = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64))
    pvars = fpose.init(jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    pose = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    pose.load_state_dict(poseregnet_state_dict_from_flax(jax.tree.map(np.asarray, pvars["params"])))
    rng = np.random.default_rng(0)
    comps = (rng.standard_normal((30, 42)) * 0.05).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, 42).astype(np.float32)
    fscale = FlaxScaleNet(FlaxScaleConfig(num_joints=1, n_dims=3, hidden=64))
    svars = fscale.init(jax.random.key(1), jnp.zeros((1, 128, 128, 1)))
    scale = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3, hidden=64))
    scale.load_state_dict(scalenet_state_dict_from_flax(jax.tree.map(np.asarray, svars["params"])))
    return (fpose, pvars, pose, JaxPCAPrior(comps, mean), PCAPrior(comps, mean),
            fscale, svars, scale)


@pytest.fixture(scope="module")
def frames():
    dev = jcamera.SyntheticDevice(JAX_ICVL, seed=5)
    dev.start()
    return np.stack([dev.getDepth()[1] for _ in range(4)])


@pytest.mark.parametrize("cam_name", ["icvl", "nyu"])
def test_synthetic_device_matches_jax(cam_name):
    jcam, tcam = {"icvl": (JAX_ICVL, ICVL_CAMERA), "nyu": (JAX_NYU, NYU_CAMERA)}[cam_name]
    jdev, tdev = jcamera.SyntheticDevice(jcam, seed=3), tcamera.SyntheticDevice(tcam, seed=3)
    assert tdev.getDepth() == (False, None)  # not started
    jdev.start()
    tdev.start()
    for _ in range(3):
        ok_j, want = jdev.getDepth()
        ok_t, got = tdev.getDepth()
        assert ok_j and ok_t and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert tdev.getLastDepthNum() == 2 and tdev.getDepthIntrinsics() == tcam
    mirrored = tcamera.SyntheticDevice(tcam, seed=3, mirror=True)
    mirrored.start()
    fresh = tcamera.SyntheticDevice(tcam, seed=3)
    fresh.start()
    np.testing.assert_array_equal(mirrored.getDepth()[1], fresh.getDepth()[1][:, ::-1])


def test_file_device_replay():
    frames = np.random.default_rng(0).uniform(0, 100, (3, 8, 8)).astype(np.float32)
    dev = tcamera.FileDevice(frames, ICVL_CAMERA, loop=False)
    dev.start()
    for i in range(3):
        ok, f = dev.getDepth()
        assert ok
        np.testing.assert_array_equal(f, frames[i])
    assert dev.getDepth() == (False, None) and dev.getLastDepthNum() == 2
    dev = tcamera.FileDevice(list(frames), ICVL_CAMERA, loop=True, mirror=True)
    dev.start()
    got = [dev.getDepth()[1] for _ in range(4)]
    np.testing.assert_array_equal(got[3], frames[0][:, ::-1])


MODES = {
    "detect": dict(detect=True),
    "refine3": dict(refine_iters=3),
    "detect_linear": dict(detect=True, resize="linear"),
    "refine3_linear": dict(refine_iters=3, resize="linear"),
    "linear": dict(resize="linear"),
    "nd_bilinear": dict(resize="nd_bilinear"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_estimator_modes_match_jax(nets, frames, mode):
    fpose, pvars, pose, jprior, tprior = nets[:5]
    kw = MODES[mode]
    jest = JaxFusedEstimator(fpose, JAX_ICVL, prior=jprior, **kw)
    est = FusedEstimator(pose, ICVL_CAMERA, prior=tprior, device="cpu", **kw)
    com = np.array([[160.0, 120.0, 700.0]] * len(frames), np.float32)
    com[:, :2] += np.arange(len(frames))[:, None] * 3.0
    for call in (dict(), dict(cube=np.full(3, 300.0, np.float32), mirror=np.array(
            [True, False, True, False]), invx=True)):
        jj, jc3, jcr = jest(pvars, frames, com, **call)
        tj, tc3, tcr = est(frames, com, **call)
        np.testing.assert_allclose(tc3.numpy(), np.asarray(jc3), **COM_TOL)
        np.testing.assert_allclose(tcr.numpy(), np.asarray(jcr), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=0, atol=JOINT_ATOL)
    # the kernel route takes the same path on the CPU, bit for bit
    hop = FusedEstimator(pose, ICVL_CAMERA, prior=tprior, device="cpu",
                         crop_method="hopper", **kw)
    for a, b in zip(hop(frames, com), est(frames, com)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _pipelines(nets, comref):
    fpose, pvars, pose, jprior, tprior, fscale, svars, scale = nets
    jest = JaxFusedEstimator(fpose, JAX_ICVL, prior=jprior, resize="linear",
                             crop_method="gather")
    est = FusedEstimator(pose, ICVL_CAMERA, prior=tprior, resize="linear", device="cpu")
    jref = JaxRefiner(fscale, svars, JAX_ICVL) if comref else None
    tref = CNNComRefiner(scale, ICVL_CAMERA) if comref else None
    jpipe = jpipeline.RealtimeHandposePipeline(jest, pvars, dict(CFG), com_refiner=jref)
    tpipe = tpipeline.RealtimeHandposePipeline(est, dict(CFG), com_refiner=tref)
    return jpipe, tpipe


@pytest.mark.parametrize("comref", [False, True])
def test_pipeline_matches_jax(nets, comref):
    """Per-frame CoMs and joints over the INIT calibration, a right hand
    and tracking; the state machine moves in step."""
    jpipe, tpipe = _pipelines(nets, comref)
    jdev, tdev = jcamera.SyntheticDevice(JAX_ICVL, seed=7), tcamera.SyntheticDevice(ICVL_CAMERA, seed=7)
    for p in (jpipe, tpipe):
        p.num_init_frames = 2
    for keys in ("i", "h", "t", "+"):
        for p in (jpipe, tpipe):
            assert p.process_key(keys)
        want = jpipe.process_video(jdev, max_frames=2)
        got = tpipe.process_video(tdev, max_frames=2)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["frame"], w["frame"])
            np.testing.assert_allclose(g["com"], w["com"], **COM_TOL)
            np.testing.assert_allclose(g["joints3d"], w["joints3d"], rtol=0, atol=JOINT_ATOL)
            assert g["joints3d"].shape == (14, 3)
        assert (tpipe.state, tpipe.hand, tpipe.tracking) == (jpipe.state, jpipe.hand, jpipe.tracking)
        np.testing.assert_allclose(tpipe.config["cube"], jpipe.config["cube"], rtol=1e-4)
    assert tpipe.state == tpipeline.STATE_RUN and tpipe.hand == tpipeline.HAND_RIGHT
    assert tpipe.config["cube"][0] != 250.0  # calibrated from the frames
    assert tpipe.fps() > 0.0 and tpipe.times["detect"] > 0.0
    tpipe.process_key("r")
    assert (tpipe.state, tpipe.tracking) == (tpipeline.STATE_IDLE, False)
    assert not tpipe.process_key("q")


@pytest.mark.parametrize("comref", [False, True])
def test_device_detect_matches_host_path(nets, frames, comref):
    _, tpipe = _pipelines(nets, comref)
    host = tpipeline.RealtimeHandposePipeline(tpipe.estimator, dict(CFG),
                                              com_refiner=tpipe.com_refiner,
                                              use_device_detect=False)
    for tracking in (False, True):
        tpipe.tracking = host.tracking = tracking
        for f in frames[:2]:
            com_d, _ = tpipe.detect(f)
            com_h, _ = host.detect(f)
            np.testing.assert_allclose(com_d, com_h, rtol=1e-3, atol=0.5)


def test_pipeline_threaded_and_empty_frames(nets, frames):
    _, tpipe = _pipelines(nets, False)
    dev = tcamera.FileDevice(list(frames) + [np.zeros_like(frames[0])], ICVL_CAMERA)
    results = tpipe.process_video_threaded(dev, max_frames=6)
    assert 1 <= len(results) <= 6
    assert all(r["joints3d"].shape == (14, 3) for r in results)
    assert all(np.isfinite(r["joints3d"]).all() for r in results)
    # an empty frame detects nothing and yields no result
    assert tpipe.process_frame(np.zeros_like(frames[0])) is None


@pytest.mark.parametrize("crop_joint", [None, 13])
def test_drawing_matches_jax(nets, frames, crop_joint):
    """show, show_side and add_status_bar on the same result dict and
    state: the JAX pipeline's arrays bit for bit, in every state (the
    status light's colour), each hand, tracking or detection; a pose
    half outside the frame is clipped the same way."""
    jpipe, tpipe = _pipelines(nets, False)
    result = tpipe.process_frame(frames[0])
    off = dict(result, joints3d=result["joints3d"] + np.float32([150.0, 0.0, 0.0]),
               com=np.float32([-5.0, 3.0, 600.0]))
    for p in (jpipe, tpipe):
        p._fps_hist = [0.0, 0.04, 0.08]  # 25 fps on both
        if crop_joint is not None:
            p.config["crop_joint_idx"] = crop_joint
    for res in (result, off):
        front = tpipe.show(res)
        np.testing.assert_array_equal(front, jpipe.show(res))
        assert front.shape == res["frame"].shape + (3,) and front.dtype == np.uint8
        side = tpipe.show_side(res)
        np.testing.assert_array_equal(side, jpipe.show_side(res))
        assert (side > 0).any() and not np.array_equal(side, front)
    for state, hand, tracking in ((tpipeline.STATE_IDLE, 0, False),
                                  (tpipeline.STATE_INIT, 1, True),
                                  (tpipeline.STATE_RUN, 0, True)):
        for p in (jpipe, tpipe):
            p.state, p.hand, p.tracking = state, hand, tracking
        bar = tpipe.add_status_bar(front)
        np.testing.assert_array_equal(bar, jpipe.add_status_bar(front))
        assert bar.shape == (front.shape[0] + 20,) + front.shape[1:]
        np.testing.assert_array_equal(bar[9, 7], tpipeline.STATE_COLORS[state])
        assert (bar[:20][~np.pad(tpipeline.STATUS_LIGHT, ((0, 0), (0, front.shape[1] - 14)))]
                != 255).any()  # the text


def test_demo_main_on_cpu(tmp_path):
    lines = []
    pipe, results = demo_realtime.main(["--frames", "5", "--device", "cpu", "--comref"],
                                       log=lines.append)
    assert len(results) == 5 and pipe.com_refiner is not None
    assert lines and lines[0].startswith("processed 5 frames on cpu")
    assert next(pipe.estimator.model.parameters()).device.type == "cpu"
    # the JAX demo's camera spelling: the synthetic camera on the default
    # device, which is the card; without one it raises and names the way
    # to the CPU
    if torch.cuda.is_available():
        _, results = demo_realtime.main(["--device", "synthetic", "--frames", "1"],
                                        log=lines.append)
        assert len(results) == 1
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            demo_realtime.main(["--device", "synthetic", "--frames", "1"],
                               log=lines.append)
        with pytest.raises(RuntimeError, match="--device cpu"):
            default_device()
    # --checkpoint: a missing file raises, a network_prior.ckpt serves its
    # weights and prior
    with pytest.raises(FileNotFoundError):
        demo_realtime.main(["--checkpoint", str(tmp_path / "missing.ckpt"), "--frames", "1",
                            "--device", "cpu"])
    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30),
                       generator=torch.Generator().manual_seed(4))
    comps = np.random.default_rng(4).standard_normal((30, 42)).astype(np.float32) * 0.05
    ckpt = str(tmp_path / "network_prior.ckpt")
    save_checkpoint(ckpt, {"params": model.state_dict(), "pca_components": comps,
                           "pca_mean": np.zeros(42, np.float32)})
    pipe, results = demo_realtime.main(["--checkpoint", ckpt, "--frames", "2",
                                        "--device", "cpu"], log=lines.append)
    assert len(results) == 2
    for k, v in pipe.estimator.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert torch.equal(pipe.estimator.prior.components, torch.from_numpy(comps))
    # the native capture camera with its own intrinsics, and --save-view:
    # the canvas is the front view under the status bar beside the side view
    view = str(tmp_path / "view.png")
    pipe, results = demo_realtime.main(["--camera", "capture", "--frames", "2",
                                        "--device", "cpu", "--save-view", view],
                                       log=lines.append)
    assert len(results) == 2 and pipe.camera.fx == pytest.approx(224.5)
    assert lines[-1] == f"saved view to {view}"
    canvas = demo_realtime.view_canvas(pipe, results[-1])
    assert canvas.shape == (240 + 20, 2 * 320, 3)
    import matplotlib.pyplot as plt

    png = plt.imread(view)
    assert png.shape[:2] == canvas.shape[:2]
    np.testing.assert_array_equal(np.rint(png[..., :3] * 255).astype(np.uint8), canvas)
    # without matplotlib: no PNG, and the demo says so
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **k)

    builtins.__import__ = no_matplotlib
    try:
        assert not demo_realtime.save_view(canvas, str(tmp_path / "none.png"), lines.append)
    finally:
        builtins.__import__ = real_import
    assert "no PNG written" in lines[-1] and "matplotlib" in lines[-1]
    assert not os.path.exists(tmp_path / "none.png")
    # the JAX demo's spelling of the capture camera runs on the default
    # device (the card), and raises without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            demo_realtime.main(["--device", "capture", "--frames", "1"])


def test_demo_main_resnet_with_reference_pickles(tmp_path):
    """demo_realtime --model resnet --ref-pickle --comref-pickle on the CPU:
    ResNet-47 from a network_prior.pkl (its decode appended: no prior) and
    the ScaleNet refiner from its pickle, weights as written; a pickle of
    the bare embedding exits with the JAX main's message."""
    model = ResNet(ResNetConfig(num_joints=1, n_dims=30),
                   generator=torch.Generator().manual_seed(3))
    comps = np.random.default_rng(3).standard_normal((30, 42)).astype(np.float32) * 0.05
    pkl = str(tmp_path / "network_prior.pkl")
    with open(pkl, "wb") as fh:
        pickle.dump(reference_pickle_from_state_dict(
            model.state_dict(), "resnet", decode=PCAPrior(comps, np.zeros(42, np.float32))),
            fh, 2)
    scale = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3),
                     generator=torch.Generator().manual_seed(7))
    comref = str(tmp_path / "comref.pkl")
    with open(comref, "wb") as fh:
        pickle.dump(reference_pickle_from_state_dict(scale.state_dict(), "scalenet"), fh, 2)
    lines = []
    pipe, results = demo_realtime.main(
        ["--model", "resnet", "--ref-pickle", pkl, "--comref-pickle", comref, "--frames",
         "2", "--device", "cpu"], log=lines.append)
    assert len(results) == 2 and lines[0].startswith("processed 2 frames on cpu")
    assert all(np.isfinite(r["joints3d"]).all() for r in results)
    est = pipe.estimator
    assert isinstance(est.model, ResNet) and est.prior is None
    assert est.model.cfg.embedding == 30 and est.model.cfg.num_joints == 14
    for k, v in scale.state_dict().items():
        assert torch.equal(pipe.com_refiner.model.state_dict()[k], v), k
    bare = str(tmp_path / "embedding.pkl")
    with open(bare, "wb") as fh:
        pickle.dump(reference_pickle_from_state_dict(model.state_dict(), "resnet"), fh, 2)
    with pytest.raises(SystemExit, match="decode layer"):
        demo_realtime.main(["--model", "resnet", "--ref-pickle", bare, "--frames", "1",
                            "--device", "cpu"])
