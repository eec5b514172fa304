"""The JAX package's checkpoint format read by the port without jax
(deepprior_tpu_torch/train/jax_checkpoint.py, train/checkpoint.py,
utils/convert.py::state_dict_from_flax), on the CPU:

- the reader against ``flax.serialization.msgpack_restore`` on a tree with
  a bf16 leaf, numpy scalars, Python scalars and a chunked array (flax's
  MAX_CHUNK_SIZE set small); a truncated file and an unknown ext code raise;
- chip_smoke.py's writer (which the card's machine, without jax, uses)
  against deepprior_tpu.train.checkpoint.save_checkpoint, byte for byte;
- a network_prior.ckpt that save_checkpoint wrote for a PoseRegNet (hidden
  1024) and for a depth-11 ResNet, served by the port's FusedEstimator
  within 1e-3 mm of the JAX FusedEstimator's joints
  (tests/test_torch_fused.py's bound);
- a JAX ScaleNet net_P0_COM.ckpt through both packages'
  load_refine_net_lazy: CoMs within rtol 1e-4 / atol 1e-2
  (tests/test_torch_importers.py's bound);
- the wrong --model raises ValueError; a JAX training snapshot given to
  --resume raises ValueError.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from jax.experimental.pallas import tpu as pltpu

from deepprior_tpu.camera import NYU_CAMERA as J_NYU
from deepprior_tpu.data.synthetic import make_frame
from deepprior_tpu.prior import PCAPrior as JaxPCAPrior
from deepprior_tpu.realtime.fused import FusedEstimator as JaxFusedEstimator
from deepprior_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

import chip_smoke
from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.mains.common import load_serving_net
from deepprior_tpu_torch.models import ResNet, ResNetConfig
from deepprior_tpu_torch.models.layers import calibrate_batchnorm
from deepprior_tpu_torch.realtime.fused import FusedEstimator
from deepprior_tpu_torch.train.checkpoint import load_checkpoint, read_checkpoint
from deepprior_tpu_torch.train.jax_checkpoint import decode_tree, read_jax_checkpoint
from deepprior_tpu_torch.train.trainer import TrainConfig

B = 4
PRIOR = {"pca_components": (np.random.default_rng(0).standard_normal((30, 42)) * 0.05)
         .astype(np.float32),
         "pca_mean": np.random.default_rng(1).uniform(-0.1, 0.1, 42).astype(np.float32)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    fr = [make_frame(J_NYU, np.random.default_rng(60 + i)) for i in range(B)]
    return np.stack([f.extraData["dpt_full"] for f in fr]), np.stack([f.com for f in fr])


def _flax_init(model, rng):
    """flax variables at ``model``'s shapes drawn with numpy (fan-in scaled):
    no compile, unlike ``init``."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                   / np.sqrt(max(1, int(np.prod(s.shape[:-1])))))
                        .astype(s.dtype), shapes)


# --------------------------------------------------------------- the reader
def test_reader_matches_msgpack_restore(monkeypatch):
    tree = {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "b": {"bf16": jnp.asarray(np.linspace(-2.0, 2.0, 7), jnp.bfloat16),
              "f32": np.float32(3.5), "i64": np.int64(-7), "u8": np.arange(3, dtype=np.uint8)},
        "chunked": np.arange(100, dtype=np.int32), "empty": {},
        "f": 1.25, "i": -3, "big": 2 ** 40, "neg": -2 ** 40, "s": "text", "none": None,
        "t": True, "c": 2 + 3j, "bool": np.ones((2, 2), bool), "zero": np.zeros((0, 3)),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    want, got = serialization.msgpack_restore(blob), decode_tree(blob)

    def same(w, g, path=""):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                same(w[k], g[k], f"{path}/{k}")
            return
        assert type(g) is type(w) or isinstance(g, np.ndarray), (path, type(g), type(w))
        if getattr(w, "dtype", None) == jnp.bfloat16:  # widened to float32, exactly
            assert g.dtype == np.float32
            w = np.asarray(w, np.float32)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=path)
        assert getattr(g, "dtype", None) == getattr(w, "dtype", None), path

    same(want, got)


def test_truncated_file_and_unknown_ext_raise(tmp_path):
    path = str(tmp_path / "net.ckpt")
    jax_save_checkpoint(path, {"params": {"w": np.ones((4, 4), np.float32)}}, config={})
    data = open(path, "rb").read()
    cut = str(tmp_path / "cut.ckpt")
    open(cut, "wb").write(data[:-10])
    with pytest.raises(ValueError, match="truncated"):
        read_jax_checkpoint(cut)
    # a one-entry map {"x": fixext 1 of code 9}
    with pytest.raises(ValueError, match="unknown msgpack ext type 9"):
        decode_tree(b"\x81\xa1x\xd4\x09\x00")
    with pytest.raises(ValueError, match="type byte 0xc1"):
        decode_tree(b"\xc1")


@pytest.mark.parametrize("family", ["poseregnet", "resnet", "scalenet"])
def test_chip_smoke_writer_is_save_checkpoint(tmp_path, family):
    """The writer chip_smoke.py uses where jax is missing writes what the
    JAX package's save_checkpoint writes, byte for byte, and the port reads
    the weights back bit for bit."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ScaleNet, ScaleNetConfig

    model = {"poseregnet": lambda: PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30)),
             "resnet": lambda: ResNet(ResNetConfig(num_joints=1, n_dims=30, depth=11,
                                                   stages=(8, 16, 16, 16, 16))),
             "scalenet": lambda: ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3))}[family]()
    tree = dict(chip_smoke.flax_variables(model), **PRIOR)
    config = TrainConfig()._asdict()
    ours, theirs = str(tmp_path / "ours.ckpt"), str(tmp_path / "theirs.ckpt")
    chip_smoke.write_jax_checkpoint(ours, tree, config)
    jax_save_checkpoint(theirs, tree, config=config)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert read_checkpoint(theirs)[2] == family
    got, exact = load_checkpoint(theirs, dict(params=model.state_dict(), **PRIOR))
    assert exact
    for k, v in model.state_dict().items():
        assert torch.equal(got["params"][k], v), k


# --------------------------------------------------------------- serving
def test_jax_poseregnet_network_prior_is_served(tmp_path, frames):
    """A PoseRegNet (hidden 1024) network_prior.ckpt that the JAX package
    wrote, through load_serving_net: the JAX FusedEstimator's joints within
    1e-3 mm; the wrong --model raises."""
    from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
    from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig

    depth, com = frames
    flax = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30))
    variables = _flax_init(flax, np.random.default_rng(7))
    path = str(tmp_path / "network_prior.ckpt")
    jax_save_checkpoint(path, dict(params=variables["params"], batch_stats={}, **PRIOR),
                        config=TrainConfig()._asdict())
    jest = JaxFusedEstimator(flax, J_NYU, prior=JaxPCAPrior(PRIOR["pca_components"],
                                                             PRIOR["pca_mean"]),
                             crop_method="pallas")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jest(variables, depth, com)[0])
    model, prior = load_serving_net("poseregnet", checkpoint=path, device="cpu")
    got = FusedEstimator(model, NYU_CAMERA, prior=prior, device="cpu")(depth, com)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="holds a poseregnet"):
        load_serving_net("resnet", checkpoint=path, device="cpu")


def test_jax_resnet_network_prior_is_served(tmp_path, frames):
    """A depth-11 ResNet's network_prior.ckpt (BatchNorm statistics
    calibrated on the frames' crops, so the pose is of a trained net's
    scale) that the JAX package wrote: the port's FusedEstimator within
    1e-3 mm of the JAX one's joints."""
    from deepprior_tpu.models import ResNet as FlaxResNet
    from deepprior_tpu.models import ResNetConfig as FlaxResNetConfig

    depth, com = frames
    cfg = dict(num_joints=1, n_dims=30, depth=11, stages=(8, 16, 16, 16, 16))
    model = ResNet(ResNetConfig(**cfg), generator=torch.Generator().manual_seed(8))
    crops = FusedEstimator(model, NYU_CAMERA, device="cpu")(depth, com)[2]
    calibrate_batchnorm(model, crops[:, None])
    variables = chip_smoke.flax_variables(model)
    path = str(tmp_path / "network_prior.ckpt")
    jax_save_checkpoint(path, dict(variables, **PRIOR), config=TrainConfig()._asdict())
    assert read_checkpoint(path)[2] == "resnet"
    jest = JaxFusedEstimator(FlaxResNet(FlaxResNetConfig(**cfg)), J_NYU,
                             prior=JaxPCAPrior(PRIOR["pca_components"], PRIOR["pca_mean"]),
                             crop_method="pallas")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jest(jax.tree.map(jnp.asarray, variables), depth, com)[0])
    served = ResNet(ResNetConfig(**cfg))
    tree, exact = load_checkpoint(path, dict(params=served.state_dict(), **PRIOR))
    assert exact
    served.load_state_dict(tree["params"])
    from deepprior_tpu_torch.prior import PCAPrior

    got = FusedEstimator(served, NYU_CAMERA, device="cpu", prior=PCAPrior(
        tree["pca_components"], tree["pca_mean"]))(depth, com)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_jax_scalenet_refines_coms(tmp_path):
    """A JAX ScaleNet net_P0_COM.ckpt through both packages'
    load_refine_net_lazy: the refined CoMs within rtol 1e-4 / atol 1e-2."""
    from deepprior_tpu.data import importers as ji
    from deepprior_tpu.models import ScaleNet as FlaxScaleNet
    from deepprior_tpu.models import ScaleNetConfig as FlaxScaleNetConfig
    from deepprior_tpu_torch.data import importers as ti
    from deepprior_tpu_torch.data import trees

    root = str(tmp_path / "msra")
    trees.write_msra15_tree(root, subjects=("P0",), frames=5, seed=61)
    variables = _flax_init(FlaxScaleNet(FlaxScaleNetConfig()), np.random.default_rng(9))
    path = str(tmp_path / "net_P0_COM.ckpt")
    jax_save_checkpoint(path, {"params": variables["params"], "batch_stats": {}},
                        config=TrainConfig()._asdict())
    port = ti.MSRA15Importer(root, use_cache=False, device="cpu")
    jimp = ji.MSRA15Importer(root, use_cache=False)
    port.load_refine_net_lazy(path)
    jimp.load_refine_net_lazy(path)
    got = port.loadSequence("P0", docom=True)
    want = jimp.loadSequence("P0", docom=True)
    assert len(got.data) == len(want.data) == 5
    for fg, fw in zip(got.data, want.data):
        np.testing.assert_allclose(fg.com, fw.com, rtol=1e-4, atol=1e-2)


def test_jax_training_snapshot_refused_by_resume(tmp_path):
    """A JAX package training snapshot (optax state) at the rolling
    snapshot's path: --resume raises ValueError naming the serving
    checkpoints, as load_checkpoint does."""
    from deepprior_tpu.models import PoseRegNet as FlaxPoseRegNet
    from deepprior_tpu.models import PoseRegNetConfig as FlaxConfig
    from deepprior_tpu.train import trainer as jtrainer
    from deepprior_tpu_torch.mains import main_nyu_posereg_embedding

    flax = FlaxPoseRegNet(FlaxConfig(num_joints=1, n_dims=30, hidden=64))
    jt = jtrainer.Trainer(flax, jtrainer.TrainConfig(batch_size=16), J_NYU)
    state = jt.init_state(np.zeros((1, 128, 128), np.float32))
    snap = tmp_path / "train_EMB_PCA30" / "net_last.ckpt"
    snap.parent.mkdir()
    jt.save_train_state(str(snap), state, 0)
    with pytest.raises(ValueError, match="serving checkpoints"):
        load_checkpoint(str(snap), {"params": {}})
    with pytest.raises(ValueError, match="training snapshot"):
        main_nyu_posereg_embedding.main(
            ["--synthetic", "--out", str(tmp_path), "--device", "cpu", "--epochs", "1",
             "--nmax", "32", "--batch-size", "16", "--resume"])
    assert os.path.isfile(snap)
