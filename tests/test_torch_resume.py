"""Snapshots and resume on the CPU, port against port, bit for bit (the
counterparts of tests/test_resume.py): a run cut after an epoch, saved and
resumed ends with the uninterrupted run's parameters, optimizer state,
step and losses, through ``fit`` and ``fit_streamed``, with the
augmentation and dropout on; the early-stopping tracker survives a resume;
``fit`` writes its rolling snapshot; a ResNet's BatchNorm statistics
resume too.  Also ``predict_with_intermediates`` (tests/test_aux.py:78-84).
"""

import os

import numpy as np
import pytest
import torch

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_sequence
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
from deepprior_tpu_torch.train.checkpoint import checkpoint_keys
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These CPU runs are small: one intra-op thread runs them as fast and
    keeps them from contending for the cores with parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    seq = make_sequence(NYU_CAMERA, 36, seed=21)
    val = make_sequence(NYU_CAMERA, 8, seed=22, name="val")
    return TrainData.from_sequence(seq), TrainData.from_sequence(val)


CFG = TrainConfig(batch_size=8, learning_rate=0.002, n_epochs=4, snapshot_every=1,
                  use_early_stopping=False)


def _model(kind):
    if kind == "resnet":  # small depth; BatchNorm buffers and dropout
        return ResNet(ResNetConfig(num_joints=14, n_dims=3, depth=11,
                                   stages=(8, 8, 16, 32, 32), hidden=32, dropout=True))
    return PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=32))


def _trainer(kind="poseregnet", cfg=CFG):
    tr = Trainer(_model(kind), cfg, NYU_CAMERA, device="cpu")
    return tr, tr.init_state()


def _fit(tr, st, data, streamed, **kw):
    if streamed:
        arrays = {k: np.asarray(getattr(data[0], k)) for k in TrainData._fields}
        return tr.fit_streamed(st, arrays, chunk_steps=2, val_data=data[1],
                               log=lambda m: None, **kw)
    return tr.fit(st, data[0], val_data=data[1], log=lambda m: None, **kw)


def _assert_same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    for pa, pb in zip(a.optimizer.param_groups[0]["params"],
                      b.optimizer.param_groups[0]["params"]):
        for slot, t in a.optimizer.state[pa].items():
            assert torch.equal(b.optimizer.state[pb][slot], t), slot
    assert torch.equal(a.optimizer.param_groups[0]["count"],
                       b.optimizer.param_groups[0]["count"])
    assert a.step == b.step


@pytest.mark.parametrize("kind,streamed", [("poseregnet", False), ("poseregnet", True),
                                           ("resnet", False)])
def test_resume_matches_uninterrupted(data, tmp_path, kind, streamed):
    tr1, s1 = _trainer(kind)
    s1, h1 = _fit(tr1, s1, data, streamed)
    h1 = {k: list(v) for k, v in h1.items()}

    tr2, s2 = _trainer(kind)
    s2, _ = _fit(tr2, s2, data, streamed, n_epochs=2)
    path = str(tmp_path / "snap.ckpt")
    tr2.save_train_state(path, s2, epoch=1)
    assert checkpoint_keys(path) == {"params", "opt_state", "step", "epoch"}

    tr3, s3 = _trainer(kind)
    s3, next_epoch = tr3.load_train_state(path, s3)
    assert next_epoch == 2
    s3, h3 = _fit(tr3, s3, data, streamed, start_epoch=next_epoch)
    _assert_same_state(s1, s3)
    n = len(h3["train_cost"])
    assert n == 2 * 5 and h3["train_cost"] == h1["train_cost"][-n:]
    assert h3["val_error_mm"] == h1["val_error_mm"][-2:]
    if kind == "resnet":
        assert not torch.equal(s3.model.state_dict()["bn.running_var"], torch.ones(32))


def test_best_tracker_survives_resume(data, tmp_path):
    """The tracker is kept in the snapshot and taken on resume: resumed
    epochs cannot beat val 1e-9, so the run ends on the kept weights (the
    initial ones here); a snapshot without one resumes with a fresh one."""
    cfg = CFG._replace(use_early_stopping=True)
    tr, st = _trainer(cfg=cfg)
    init = {k: v.clone() for k, v in st.model.state_dict().items()}
    path = str(tmp_path / "best.ckpt")
    tr.save_train_state(path, st, epoch=1, best=(1e-9, init, 0))
    assert "best" in checkpoint_keys(path)

    tr2, st2 = _trainer(cfg=cfg)
    st2, next_epoch = tr2.load_train_state(path, st2)
    lines = []
    st2, _ = tr2.fit(st2, data[0], val_data=data[1], start_epoch=next_epoch,
                     log=lines.append)
    assert lines[-1].startswith("best params at epoch 0 (val 0.000mm)")
    for k, v in init.items():
        assert torch.equal(st2.model.state_dict()[k], v), k

    tr3, st3 = _trainer(cfg=cfg)
    tr3.save_train_state(path, st3, epoch=0)
    tr3.load_train_state(path, st3)
    assert tr3._take_resumed_best()[1] is None


@pytest.mark.parametrize("streamed", [False, True])
def test_snapshot_written_during_fit(data, tmp_path, streamed):
    """Every snapshot_every epochs the run writes <path>_last.ckpt; it
    holds the best tracker once one exists and restores."""
    tr, st = _trainer(cfg=CFG._replace(snapshot_every=2, use_early_stopping=True))
    snap = str(tmp_path / "net")
    seen = []

    def written(epoch, state):
        path = snap + "_last.ckpt"
        seen.append(os.stat(path).st_mtime_ns if os.path.exists(path) else None)

    _fit(tr, st, data, streamed, n_epochs=3, snapshot_path=snap, on_epoch_start=written)
    written(3, st)
    # written after epochs 0 and 2, not after epoch 1
    assert seen[0] is None and seen[1] == seen[2] < seen[3]
    assert checkpoint_keys(snap + "_last.ckpt") == {"params", "opt_state", "step",
                                                    "epoch", "best"}
    tr2, st2 = _trainer()
    st2, next_epoch = tr2.load_train_state(snap + "_last.ckpt", st2)
    assert next_epoch == 3 and st2.step == 15


def test_predict_with_intermediates(data):
    tr, st = _trainer()
    crops = data[0].crops[:5]
    out, inter = tr.predict_with_intermediates(st, crops)
    np.testing.assert_array_equal(out, tr.predict(st, crops))
    assert out.shape == (5, 42)
    # the conv-pool layers and the MLP head, in call order
    assert list(inter)[:4] == ["convs.0", "convs.1", "convs.2", "head"]
    assert inter["convs.0"].shape[:2] == (5, 8)
    np.testing.assert_array_equal(inter["head"], out)
    assert not any(m._forward_hooks for m in st.model.modules())
