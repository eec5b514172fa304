"""The port's checkpoints (train/checkpoint.py) against the JAX package's
cases (tests/test_train.py's checkpoint tests): round trip, the config diff
and ``strict``, shape recovery, ``checkpoint_keys`` and recovery that
prefers the matching subtree; the recovery ranking against
deepprior_tpu.train.checkpoint's; and a state dict's dotted keys as paths."""

import numpy as np
import pytest
import torch

from deepprior_tpu.train import checkpoint as jckpt

from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.train import checkpoint as tckpt
from deepprior_tpu_torch.train.checkpoint import (
    checkpoint_keys, load_checkpoint, save_checkpoint)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"dense": {"kernel": np.ones((4, 3), np.float32)}},
        "step": np.int32(7),
        "weights": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "epoch": 3,
    }
    p = str(tmp_path / "ck.ckpt")
    save_checkpoint(p, tree, config={"lr": 0.01})
    restored, exact = load_checkpoint(p, tree, config={"lr": 0.01})
    assert exact
    np.testing.assert_array_equal(
        restored["params"]["dense"]["kernel"], tree["params"]["dense"]["kernel"]
    )
    assert isinstance(restored["params"]["dense"]["kernel"], np.ndarray)
    assert int(restored["step"]) == 7 and restored["epoch"] == 3
    assert torch.equal(restored["weights"], tree["weights"])
    assert not (tmp_path / "ck.ckpt.tmp").exists()  # written, then renamed


def test_checkpoint_config_diff(tmp_path, capsys):
    tree = {"w": np.zeros(3, np.float32)}
    p = str(tmp_path / "ck.ckpt")
    save_checkpoint(p, tree, config={"lr": 0.01})
    _, exact = load_checkpoint(p, tree, config={"lr": 0.02})
    assert not exact
    out = capsys.readouterr().out
    assert "mismatch" in out and "0.01" in out and "0.02" in out
    with pytest.raises(ValueError):
        load_checkpoint(p, tree, config={"lr": 0.02}, strict=True)
    # the port's fingerprint is the JAX package's JSON for the same config
    assert tckpt._fingerprint({"lr": 0.01, "modes": ("com", "rot")}) == \
        jckpt._fingerprint({"lr": 0.01, "modes": ("com", "rot")})


def test_checkpoint_shape_recovery(tmp_path):
    """Structural mismatch falls back to name/shape grafting
    (netbase.py:451-476 semantics); ``strict`` raises instead."""
    stored = {"layers": {"0": {"kernel": np.full((4, 3), 7.0, np.float32)}}}
    p = str(tmp_path / "ck.ckpt")
    save_checkpoint(p, stored)
    target = {
        "blocks": {"first": {"kernel": np.zeros((4, 3), np.float32)},
                   "second": {"kernel": np.zeros((2, 2), np.float32)}}
    }
    restored, exact = load_checkpoint(p, target)
    assert not exact
    np.testing.assert_array_equal(
        restored["blocks"]["first"]["kernel"], 7.0 * np.ones((4, 3))
    )
    np.testing.assert_array_equal(
        restored["blocks"]["second"]["kernel"], np.zeros((2, 2))
    )
    with pytest.raises(ValueError):
        load_checkpoint(p, target, strict=True)


def test_checkpoint_keys_reads_the_header_only(tmp_path, monkeypatch):
    """checkpoint_keys reads the top-level keys from the header: the payload
    (the parameters) is never loaded."""
    tree = {
        "params": {"dense": {"kernel": np.ones((64, 32), np.float32),
                             "bias": np.zeros(32, np.float32)}},
        "opt_state": {"0": {"mu": np.ones(5, np.float32)}},
        "step": np.int32(7),
        "epoch": 3,
        "best": {"val": 1.5, "params": {"k": np.ones(4, np.float32)}},
    }
    p = str(tmp_path / "ck.ckpt")
    save_checkpoint(p, tree)

    def boom(*a, **k):
        raise AssertionError("checkpoint_keys loaded the payload")

    monkeypatch.setattr(tckpt.torch, "load", boom)
    assert checkpoint_keys(p) == {"params", "opt_state", "step", "epoch", "best"}


def test_checkpoint_recovery_prefers_matching_subtree(tmp_path):
    """'params/.../kernel' and 'best/params/.../kernel' score identical
    suffixes; recovery must pick the same-subtree leaf, not the stale best
    duplicate."""
    a = np.full((4, 3), 1.0, np.float32)
    b = np.full((4, 3), 2.0, np.float32)
    stored = {
        "params": {"dense": {"kernel": a}},
        "best": {"params": {"dense": {"kernel": b}}},
    }
    p = str(tmp_path / "ck.ckpt")
    save_checkpoint(p, stored)
    target = {
        "params": {"dense": {"kernel": np.zeros((4, 3), np.float32)}},
        "best": {"params": {"dense": {"kernel": np.zeros((4, 3), np.float32)}}},
        "new_field": np.zeros(1, np.float32),  # forces the fallback
    }
    restored, exact = load_checkpoint(p, target)
    assert not exact
    np.testing.assert_array_equal(restored["params"]["dense"]["kernel"], a)
    np.testing.assert_array_equal(restored["best"]["params"]["dense"]["kernel"], b)


KEYS = [
    ("params", "dense", "kernel"), ("best", "params", "dense", "kernel"),
    ("params", "conv1", "weight"), ("model", "conv1", "weight"), ("weight",),
    ("params", "dense", "bias"), ("best", "val"), (),
]


@pytest.mark.parametrize("tkey", KEYS)
def test_recovery_scores_rank_as_jax(tkey):
    """_suffix_score and _prefix_score give the JAX package's scores, so
    the recovery ranks stored paths in the same order."""
    def rank(mod):
        return sorted(KEYS, key=lambda r: (mod._suffix_score(tkey, r),
                                           mod._prefix_score(tkey, r), KEYS.index(r)))

    for r in KEYS:
        assert tckpt._suffix_score(tkey, r) == jckpt._suffix_score(tkey, r)
        assert tckpt._prefix_score(tkey, r) == jckpt._prefix_score(tkey, r)
    assert rank(tckpt) == rank(jckpt)


def test_state_dict_keys_are_paths(tmp_path):
    """A state dict's dotted keys become path tuples: a model's weights
    round-trip exactly, and under another top-level name they are recovered
    by their trailing names and shapes."""
    model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64),
                       generator=torch.Generator().manual_seed(3))
    p = str(tmp_path / "net.ckpt")
    save_checkpoint(p, {"params": model.state_dict()})
    assert checkpoint_keys(p) == {"params"}
    fresh = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30, hidden=64))
    tree, exact = load_checkpoint(p, {"params": fresh.state_dict()})
    assert exact and set(tree["params"]) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(tree["params"][k], v), k
    moved, exact = load_checkpoint(p, {"net": fresh.state_dict()})
    assert not exact
    for k, v in model.state_dict().items():
        assert torch.equal(moved["net"][k], v), k
