"""Sharded checkpoints on torch.distributed.checkpoint
(deepprior_tpu_torch/train/checkpoint_sharded.py), the cases of
tests/test_checkpoint_sharded.py:28-296 on DCP: round trips that keep the
placements, the fingerprint gate with its diff, async saves that drain,
the format switch with the single-file snapshot, the crash windows of the
tree.tmp -> tree.new -> tree commit, and the trainer's snapshots.  The
distributed cases run in one gloo group of 2 ranks spawned for the module:
a tp-split matrix round trip, and dp = 2 and tp = 2 runs cut after an epoch
and resumed from a sharded (and, under tp, a single-file) snapshot, bit
for bit equal to the uninterrupted runs."""

import os

import pytest
import torch

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.synthetic import make_sequence
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.parallel.multihost import spawn_cpu
from deepprior_tpu_torch.train.checkpoint import (
    _fingerprint, load_checkpoint, save_checkpoint)
from deepprior_tpu_torch.train.checkpoint_sharded import (
    ShardedCheckpointer, is_sharded_checkpoint, load_checkpoint_sharded,
    save_checkpoint_sharded)
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

CFG = TrainConfig(batch_size=8, learning_rate=0.002, n_epochs=2, snapshot_every=1,
                  use_early_stopping=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here, as in every spawned rank: these runs are
    small, and the ranks and the parallel test workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return PoseRegNet(PoseRegNetConfig(num_joints=14, n_dims=3, hidden=512))


def _data():
    return TrainData.from_sequence(make_sequence(NYU_CAMERA, 8, seed=13))


# --------------------------------------------------------------- ranks
def _resume(trainer_fn, data, tmp, tag):
    """An uninterrupted run, and one cut after epoch 0 (its rolling sharded
    snapshot, and a single-file snapshot of the same state) and resumed by
    a fresh trainer from each: {format: (losses, whole state dict, step)}."""
    t1 = trainer_fn()
    s1, h1 = t1.fit(t1.init_state(), data, log=lambda m: None)
    out = {"uninterrupted": (h1["train_cost"], t1.full_state_dict(s1), s1.step)}
    t2 = trainer_fn()
    t2.sharded_snapshots = True
    snap = os.path.join(tmp, f"{tag}_net")
    s2, _ = t2.fit(t2.init_state(), data, n_epochs=1, snapshot_path=snap, log=lambda m: None)
    t2.sharded_snapshots = False
    t2.save_train_state(f"{snap}_file.ckpt", s2, epoch=0)
    for fmt, path in (("sharded", f"{snap}_last.ckpt"), ("file", f"{snap}_file.ckpt")):
        t3 = trainer_fn()
        s3, start = t3.load_train_state(path, t3.init_state())
        s3, h3 = t3.fit(s3, data, start_epoch=start, log=lambda m: None)
        out[fmt] = (h3["train_cost"], t3.full_state_dict(s3), s3.step, start,
                    is_sharded_checkpoint(path))
    return out


def _ranks(rank, world, tmp):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh

    out = {}
    # a tp-split matrix and a whole vector on a dp x tp = 1 x 2 mesh
    mesh = make_mesh(dp=1, tp=2)
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    place = [Replicate(), Shard(1)]
    w = DTensor.from_local(full.chunk(2, 1)[rank].clone(), mesh, place, run_check=False)
    path = os.path.join(tmp, "matrix")
    save_checkpoint_sharded(path, {"params": {"w": w, "b": torch.ones(8)}, "step": 7},
                            config={"lr": 0.1})
    target = {"params": {"w": DTensor.from_local(torch.zeros(8, 4), mesh, place,
                                                 run_check=False),
                         "b": torch.zeros(8)}, "step": 0}
    got, matched = load_checkpoint_sharded(path, target, config={"lr": 0.1})
    out["matrix"] = (matched, got["step"], got["params"]["w"].to_local(),
                     got["params"]["w"].placements, got["params"]["b"],
                     sorted(os.listdir(os.path.join(path, "tree"))))

    data = _data()
    dp2 = make_mesh(dp=2)
    tp2 = make_mesh(dp=1, tp=2)
    for tag, m in (("dp2", dp2), ("tp2", tp2)):
        out[tag] = _resume(lambda m=m: DistributedTrainer(_model(), CFG, NYU_CAMERA, m,
                                                          device="cpu"), data, tmp, tag)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt_ranks"))
    spawn_cpu(_ranks, 2, args=(tmp,), store_path=os.path.join(tmp, "store"))
    return tmp, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]


# --------------------------------------------------------------- cases
def test_sharded_roundtrip_preserves_shardings(ranks):
    """Each rank writes and reads back its block of a tp-split matrix, with
    its placement; the whole vector comes back whole; every rank wrote its
    own file."""
    _, res = ranks
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for r in range(2):
        matched, step, w, placements, b, files = res[r]["matrix"]
        assert matched and step == 7
        assert torch.equal(w, full.chunk(2, 1)[r])
        assert [str(p) for p in placements] == ["R", "S(1)"]
        assert torch.equal(b, torch.ones(8))
        assert files == [".metadata", "__0_0.distcp", "__1_0.distcp"]


def test_sharded_fingerprint_gates(tmp_path):
    """A config change refuses to restore, with the unified diff, unless
    allow_mismatch."""
    path = str(tmp_path / "snap")
    x = torch.arange(8.0)
    save_checkpoint_sharded(path, {"x": x}, config={"lr": 0.1})
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_checkpoint_sharded(path, {"x": torch.zeros(8)}, config={"lr": 0.5})
    got, matched = load_checkpoint_sharded(path, {"x": torch.zeros(8)}, config={"lr": 0.5},
                                           allow_mismatch=True)
    assert not matched and torch.equal(got["x"], x)


def test_async_save_overwrites_and_drains(tmp_path):
    """Rolling saves to one path serialize; the committed tree is the last
    save's; metadata_keys reads the top-level names."""
    path = str(tmp_path / "snap")
    with ShardedCheckpointer(async_save=True) as ck:
        ck.save(path, {"v": torch.zeros(4), "epoch": 0})
        ck.save(path, {"v": torch.ones(4), "epoch": 5})
        ck.wait_until_finished()
        got, _ = ck.restore(path, {"v": torch.zeros(4), "epoch": 0})
    assert got["epoch"] == 5 and torch.equal(got["v"], torch.ones(4))
    assert sorted(ShardedCheckpointer().metadata_keys(path)) == ["epoch", "v"]


def test_snapshot_format_switch_overwrites(tmp_path):
    """A single-file snapshot at the rolling path is replaced by a sharded
    one, and back."""
    path = str(tmp_path / "net_last.ckpt")
    save_checkpoint(path, {"v": torch.zeros(4)})
    assert os.path.isfile(path)
    save_checkpoint_sharded(path, {"v": torch.ones(4)})
    assert is_sharded_checkpoint(path)
    got, _ = load_checkpoint_sharded(path, {"v": torch.zeros(4)})
    assert torch.equal(got["v"], torch.ones(4))
    save_checkpoint(path, {"v": torch.full((4,), 2.0)})
    assert os.path.isfile(path)
    assert torch.equal(load_checkpoint(path, {"v": torch.zeros(4)})[0]["v"],
                       torch.full((4,), 2.0))


def test_crash_before_first_commit_is_debris(tmp_path):
    """A fingerprint and an unfinished tree.tmp are debris, not a
    checkpoint; the next save clears them."""
    path = str(tmp_path / "snap")
    os.makedirs(os.path.join(path, "tree.tmp"))
    with open(os.path.join(path, "fingerprint.json"), "w") as f:
        f.write("{}")
    assert not is_sharded_checkpoint(path)
    with pytest.raises(FileNotFoundError, match="no committed tree"):
        load_checkpoint_sharded(path, {"v": torch.zeros(4)})
    save_checkpoint_sharded(path, {"v": torch.ones(4)})
    assert is_sharded_checkpoint(path)
    assert not os.path.exists(os.path.join(path, "tree.tmp"))
    assert torch.equal(load_checkpoint_sharded(path, {"v": torch.zeros(4)})[0]["v"],
                       torch.ones(4))


def test_crash_before_promotion_prefers_tree_new(tmp_path):
    """A committed tree.new not yet promoted is the newer snapshot; it
    stands alone after a crash mid-promotion; the next save promotes it."""
    path = str(tmp_path / "snap")
    save_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0})
    assert os.path.isdir(os.path.join(path, "tree"))
    ck = ShardedCheckpointer(async_save=False)
    ck.save(path, {"v": torch.ones(4), "epoch": 5})
    del ck  # a crash before the drain point that promotes
    assert os.path.isdir(os.path.join(path, "tree.new"))
    assert os.path.isdir(os.path.join(path, "tree"))
    assert is_sharded_checkpoint(path)
    target = {"v": torch.zeros(4), "epoch": 0}
    assert load_checkpoint_sharded(path, target)[0]["epoch"] == 5
    import shutil

    shutil.rmtree(os.path.join(path, "tree"))  # mid-promotion
    assert is_sharded_checkpoint(path)
    assert load_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0})[0]["epoch"] == 5
    save_checkpoint_sharded(path, {"v": torch.full((4,), 2.0), "epoch": 9})
    assert os.path.isdir(os.path.join(path, "tree"))
    assert not os.path.exists(os.path.join(path, "tree.new"))
    assert load_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0})[0]["epoch"] == 9


def test_single_file_save_refuses_foreign_directory(tmp_path):
    """The single-file save removes only a sharded checkpoint's names: a
    directory with anything else raises."""
    path = str(tmp_path / "outdir")
    os.makedirs(path)
    with open(os.path.join(path, "results.json"), "w") as f:
        f.write("{}")
    with pytest.raises(IsADirectoryError, match="refusing to overwrite"):
        save_checkpoint(path, {"v": torch.zeros(4)})
    assert os.path.exists(os.path.join(path, "results.json"))


def test_single_file_save_recovers_empty_directory(tmp_path):
    """An empty directory (a sharded save killed before its first marker)
    is replaced."""
    path = str(tmp_path / "net_last")
    os.makedirs(path)
    save_checkpoint(path, {"v": torch.full((4,), 3.0)})
    assert os.path.isfile(path)
    assert torch.equal(load_checkpoint(path, {"v": torch.zeros(4)})[0]["v"],
                       torch.full((4,), 3.0))


def test_fingerprint_pairs_with_committed_tree(tmp_path):
    """The fingerprint commits with its tree: a staged fp.new without its
    tree leaves the old pairing; a committed tree.new pairs with fp.new
    until the promotion renames both."""
    path = str(tmp_path / "snap")
    cfg_a, cfg_b = {"lr": 1e-3}, {"lr": 5e-4}
    save_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 1}, config=cfg_a)
    with open(os.path.join(path, "fingerprint.json.new"), "w") as f:
        f.write(_fingerprint(cfg_b))
    target = {"v": torch.zeros(4), "epoch": 0}
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_checkpoint_sharded(path, target, config=cfg_b)
    got, ok = load_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0}, config=cfg_a)
    assert ok and got["epoch"] == 1
    os.remove(os.path.join(path, "fingerprint.json.new"))
    ck = ShardedCheckpointer(async_save=False)
    ck.save(path, {"v": torch.ones(4), "epoch": 7}, config=cfg_b)
    assert os.path.isdir(os.path.join(path, "tree.new"))
    assert os.path.exists(os.path.join(path, "fingerprint.json.new"))
    got, ok = load_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0}, config=cfg_b)
    assert ok and got["epoch"] == 7
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0}, config=cfg_a)
    ck.close()
    assert not os.path.exists(os.path.join(path, "tree.new"))
    assert not os.path.exists(os.path.join(path, "fingerprint.json.new"))
    got, ok = load_checkpoint_sharded(path, {"v": torch.zeros(4), "epoch": 0}, config=cfg_b)
    assert ok and got["epoch"] == 7


def test_trainer_sharded_snapshot_roundtrip(tmp_path):
    """Trainer.sharded_snapshots: a directory; load_train_state takes it and
    restores parameters, optimizer state, step, epoch and the best tracker
    exactly."""
    data = _data()
    tr = Trainer(_model(), CFG._replace(n_epochs=1), NYU_CAMERA, device="cpu")
    st, _ = tr.fit(tr.init_state(), data, log=lambda m: None)
    tr.sharded_snapshots = True
    path = str(tmp_path / "net_last.ckpt")
    best_sd = {k: v + 1.0 for k, v in tr._best_copy(st).items()}
    tr.save_train_state(path, st, epoch=1, best=(1.25, best_sd, 1))
    tr._drain_snapshots()
    assert is_sharded_checkpoint(path) and os.path.isdir(path)
    t2 = Trainer(_model(), CFG._replace(n_epochs=1), NYU_CAMERA, device="cpu")
    s2, next_epoch = t2.load_train_state(path, t2.init_state())
    assert next_epoch == 2 and s2.step == st.step
    for k, v in st.model.state_dict().items():
        assert torch.equal(s2.model.state_dict()[k], v), k
    want, got = tr._opt_tree(st), t2._opt_tree(s2)
    assert torch.equal(want["count"], got["count"])
    for name, slots in want["state"].items():
        for k, v in slots.items():
            assert torch.equal(got["state"][name][k], v), (name, k)
    val, bp, be = t2._take_resumed_best()
    assert val == 1.25 and be == 1
    assert all(torch.equal(bp[k], v) for k, v in best_sd.items())


def test_distributed_sharded_resume_bit_identical(ranks):
    """dp = 2 and tp = 2 runs cut after epoch 0 and resumed from their
    sharded snapshot and from a single-file one (written whole, split again
    on restore under tp): the uninterrupted runs' losses, step and
    parameters bit for bit, on every rank."""
    _, res = ranks
    for r in range(2):
        for tag in ("dp2", "tp2"):
            c1, sd1, step1 = res[r][tag]["uninterrupted"]
            for fmt in ("sharded", "file"):
                c3, sd3, step3, start, sharded = res[r][tag][fmt]
                assert start == 1 and sharded == (fmt == "sharded")
                assert c3 == c1[-len(c3):] and step3 == step1 == 2
                for k, v in sd1.items():
                    assert torch.equal(sd3[k], v), (tag, fmt, k)


def test_tp_sharded_snapshot_restores_on_one_device(ranks):
    """A snapshot the tp = 2 ranks wrote shard by shard restores whole into
    a single-device Trainer (DCP reshards), equal to the single-file
    snapshot the same ranks wrote whole at the same epoch."""
    tmp, _ = ranks
    restored = []
    for name in ("tp2_net_last.ckpt", "tp2_net_file.ckpt"):
        tr = Trainer(_model(), CFG, NYU_CAMERA, device="cpu")
        st, start = tr.load_train_state(os.path.join(tmp, name), tr.init_state())
        assert start == 1 and st.step == 1
        restored.append((st.model.state_dict(), tr._opt_tree(st)))
    (sd_a, opt_a), (sd_b, opt_b) = restored
    for k, v in sd_b.items():
        assert torch.equal(sd_a[k], v), k
    for name, slots in opt_b["state"].items():
        for k, v in slots.items():
            assert torch.equal(opt_a["state"][name][k], v), (name, k)
