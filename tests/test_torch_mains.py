"""The port's training mains on seeded dataset trees, on the CPU: each main
trains from --data, resident or --streamed; a run cut after epoch 0 and
continued with --resume writes the uninterrupted run's results.json; the
CoM-refinement mains write a net_<prefix>.ckpt that an importer's
load_refine_net_lazy reads."""

import json
import os

import numpy as np
import pytest
import torch

from deepprior_tpu_torch.data import trees
from deepprior_tpu_torch.data.importers import MSRA15Importer
from deepprior_tpu_torch.mains import common
from deepprior_tpu_torch.mains import (
    main_icvl_com_refine,
    main_icvl_posereg_embedding,
    main_msra15_com_refine,
    main_msra15_posereg_embedding_crossval,
    main_nyu_com_refine,
    main_nyu_posereg_embedding,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These CPU runs are small: one intra-op thread runs them as fast and
    keeps them from contending for the cores with parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_prior(monkeypatch):
    """The recipe's PCA prior samples 1e6 poses; 2,000 fit these trees."""
    monkeypatch.setattr(common, "PRIOR_POSES", 2000)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("datasets")
    out = {k: str(base / k) for k in ("msra", "icvl", "nyu")}
    trees.write_msra15_tree(out["msra"], subjects=[f"P{i}" for i in range(9)], frames=3,
                            seed=1)
    trees.write_icvl_tree(out["icvl"], {"train": 10, "test_seq_1": 3}, seed=2)
    trees.write_nyu_tree(out["nyu"], {"train": 10, "test_1": 3, "test_2": 3}, seed=3)
    return out


def _argv(root, out, *extra):
    return ["--data", root, "--out", str(out), "--device", "cpu", "--batch-size", "8",
            *extra]


def _results(out, prefix):
    with open(os.path.join(str(out), prefix, "results.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("main,tree,tests,nj,extra", [
    (main_nyu_posereg_embedding, "nyu", {"test_1", "test_2"}, 14, ["--streamed"]),
    (main_icvl_posereg_embedding, "icvl", {"test_seq_1"}, 16, []),
])
def test_posereg_mains_train_on_a_dataset(roots, tmp_path, main, tree, tests, nj, extra):
    state, results, hist = main.main(_argv(roots[tree], tmp_path, "--epochs", "2", *extra))
    assert set(results) == tests and state.step == 2 * 2
    assert np.isfinite(hist["train_cost"]).all() and len(hist["val_error_mm"]) == 2
    res = _results(tmp_path, "train_EMB_PCA30")
    assert set(res) == tests
    for rec in res.values():
        assert np.isfinite(rec["mean_mm"]) and len(rec["per_joint_mean_mm"]) == nj
    files = set(os.listdir(tmp_path / "train_EMB_PCA30"))
    assert {"network_prior.ckpt", "net_last.ckpt", "results.json"} <= files
    assert os.listdir(tmp_path / "cache")  # the importer's cache, under --out


@pytest.mark.parametrize("streamed", [False, True])
def test_crossval_cut_and_resumed_is_uninterrupted(roots, tmp_path, capsys, streamed):
    """--holdout P8: 8 subjects train, P8 tests.  A run of one epoch leaves
    its snapshot (epoch 0); --resume takes it to two epochs and gives the
    uninterrupted run's results.json and final parameters."""
    extra = ["--holdout", "P8", "--streamed"] if streamed else ["--holdout", "P8"]
    folds = main_msra15_posereg_embedding_crossval.main(
        _argv(roots["msra"], tmp_path / "full", "--epochs", "2", *extra))
    main_msra15_posereg_embedding_crossval.main(
        _argv(roots["msra"], tmp_path / "cut", "--epochs", "1", *extra))
    capsys.readouterr()
    resumed = main_msra15_posereg_embedding_crossval.main(
        _argv(roots["msra"], tmp_path / "cut", "--epochs", "2", "--resume", *extra))
    out = capsys.readouterr().out
    assert "resuming from" in out and "epoch 0:" not in out and "epoch 1:" in out
    assert "crossval mean over folds" in out
    prefix = "MSRA_EMB_crossval_P8"
    assert _results(tmp_path / "full", prefix) == _results(tmp_path / "cut", prefix)
    (s1, _, h1), (s2, _, h2) = folds["P8"], resumed["P8"]
    assert h2["train_cost"] == h1["train_cost"][-len(h2["train_cost"]):]
    for k, v in s1.model.state_dict().items():
        assert torch.equal(s2.model.state_dict()[k], v), k
    assert s1.step == s2.step == 2 * 3


@pytest.mark.parametrize("main,tree,prefix,extra", [
    (main_nyu_com_refine, "nyu", "train_COM", []),
    (main_icvl_com_refine, "icvl", "train_COM", ["--streamed", "--chunk-steps", "1"]),
    (main_msra15_com_refine, "msra", "P0_COM",
     ["--subject", "P0", "--test-subject", "P8", "--batch-size", "3"]),
])
def test_com_refine_mains(roots, tmp_path, main, tree, prefix, extra):
    state, results, hist = main.main(_argv(roots[tree], tmp_path, "--epochs", "2", *extra))
    assert set(results) == {"refined", "com"}
    assert np.isfinite(hist["train_cost"]).all()
    outdir = tmp_path / prefix
    res = _results(tmp_path, prefix)
    assert set(res) == {"refined", "com"} and np.isfinite(res["refined"]["mean_mm"])
    joints = np.load(outdir / f"result_{prefix}.npy")
    assert joints.shape == (res["refined"]["n_test_frames"], 1, 3)
    assert np.isfinite(joints).all()
    # the refiner it trained loads into an importer as its 'comref' CNN
    imp = MSRA15Importer(roots["msra"], use_cache=False, device="cpu")
    refiner = imp.load_refine_net_lazy(str(outdir / f"net_{prefix}.ckpt"))
    for k, v in state.model.state_dict().items():
        assert torch.equal(refiner.model.state_dict()[k], v), k
    seq = imp.loadSequence("P8", docom=True)
    assert len(seq.data) == 3 and all(np.isfinite(f.com).all() for f in seq.data)


def test_com_refine_resume(roots, tmp_path):
    argv = ["--subject", "P1", "--test-subject", "P8", "--batch-size", "3"]
    main_msra15_com_refine.main(_argv(roots["msra"], tmp_path / "full", "--epochs", "2",
                                      *argv))
    main_msra15_com_refine.main(_argv(roots["msra"], tmp_path / "cut", "--epochs", "1",
                                      *argv))
    main_msra15_com_refine.main(_argv(roots["msra"], tmp_path / "cut", "--epochs", "2",
                                      "--resume", *argv))
    assert _results(tmp_path / "full", "P1_COM") == _results(tmp_path / "cut", "P1_COM")
