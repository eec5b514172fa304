"""The port's acceptance gate and epilogue (deepprior_tpu_torch/mains/common.py:
--accept, the baselines, the training curves, the per-sequence threshold
curves and the every-20th-frame overlays), mirroring tests/test_accept.py
on the CPU, in process, at a few synthetic frames.

The acceptance record of the port's ``_acceptance`` equals the JAX main's
for the same predictions and baseline file, key for key (the errors are
float32 numpy in both).  Where matplotlib is missing the mains still
write results.json and the verdict, and log one line for each plot file
they could not write.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from deepprior_tpu_torch.camera import ICVL_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.data import importers as ti
from deepprior_tpu_torch.data.synthetic import make_sequence
from deepprior_tpu_torch.eval import plots as tplots
from deepprior_tpu_torch.eval.datasets import NYUHandposeEvaluation
from deepprior_tpu_torch.mains import common as tcommon
from deepprior_tpu_torch.mains import (main_icvl_com_refine, main_icvl_posereg_embedding,
                                       main_msra15_posereg_embedding_crossval)

REPO = os.path.join(os.path.dirname(__file__), "..")
SEED = 23455


@pytest.fixture(autouse=True)
def small_runs(monkeypatch):
    """One intra-op thread (the parallel test workers need the cores) and a
    prior of 2,000 sampled poses (tests/test_torch_mains.py's setting)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(tcommon, "PRIOR_POSES", 2000)
    monkeypatch.setattr(tcommon, "PRIOR_POSES_SYNTHETIC", 2000)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcommon():
    """The JAX mains' common.py (tests/test_accept.py imports it the same
    way)."""
    sys.path.insert(0, os.path.join(REPO, "mains"))
    import common

    return common


def _write_icvl_baseline_txt(path, seed, n_frames):
    """LRF's line format (u v d for 16 joints a line), from the synthetic
    test sequence the main builds (same seed), with pixel-scale noise."""
    seq = make_sequence(ICVL_CAMERA, n_frames, num_joints=16, seed=seed, name="test_seq_1")
    rng = np.random.default_rng(7)
    with open(path, "w") as fh:
        for fr in seq.data:
            uvd = fr.gtorig + rng.normal(0.0, [1.0, 1.0, 3.0], fr.gtorig.shape)
            fh.write(" ".join(f"{v:.4f}" for v in uvd.reshape(-1)) + "\n")
    return len(seq.data)


def _argv(tmp_path, *extra):
    return ["--synthetic", "--batch-size", "16", "--out", str(tmp_path), "--device", "cpu",
            *extra]


def test_accept_icvl_pass(tmp_path, capsys):
    """--accept with a generous threshold: the .txt baseline compared, the
    curves, overlays and acceptance record written, no exit."""
    bl = tmp_path / "LRF_Results_seq_1.txt"
    _write_icvl_baseline_txt(str(bl), seed=SEED + 1, n_frames=32)
    main_icvl_posereg_embedding.main(_argv(tmp_path, "--epochs", "1", "--nmax", "33",
                                           "--accept", "--baseline-file", str(bl),
                                           "--accept-mm", "1000"))
    out = capsys.readouterr().out
    assert "acceptance [PASS (synthetic smoke)]" in out
    assert "baseline Tang et al." in out
    outdir = tmp_path / "train_EMB_PCA30"
    rec = json.load(open(outdir / "results.json"))["acceptance"]
    assert rec["pass"] is True and rec["synthetic"] is True
    assert rec["threshold_mm"] == 1000.0 and rec["n_test_frames"] == 32
    assert 0.0 < rec["baseline"]["mean_mm"] < 100.0
    assert rec["baseline"]["label"] == "Tang et al." and rec["baseline"]["file"] == str(bl)
    assert set(rec) == {"mean_mm", "max_mm", "threshold_mm", "n_test_frames", "synthetic",
                        "baseline", "pass"}
    files = os.listdir(outdir)
    for kind in ("frameswithin", "meanerror", "maxerror"):
        assert f"train_EMB_PCA30_accept_{kind}.pdf" in files, files
        assert f"train_EMB_PCA30_test_seq_1_{kind}.pdf" in files, files
    # the every-20th-frame overlays (32 frames: 0 and 20) and the curves
    for name in ("_0.png", "_20.png", "_cost.png", "_errs.png"):
        assert "train_EMB_PCA30" + name in files, files


def test_default_run_epilogue_artifacts(tmp_path):
    """A run without --accept writes the curves and the overlays, and no
    acceptance record."""
    main_icvl_posereg_embedding.main(_argv(tmp_path, "--epochs", "1", "--nmax", "33"))
    outdir = tmp_path / "train_EMB_PCA30"
    files = os.listdir(outdir)
    for name in ("_cost.png", "_errs.png", "_0.png", "_20.png"):
        assert "train_EMB_PCA30" + name in files, files
    assert "acceptance" not in json.load(open(outdir / "results.json"))


def test_accept_icvl_fail_exits_nonzero(tmp_path, capsys):
    """An unbeatable threshold: SystemExit naming the failure, the FAIL
    verdict, and the record written first."""
    with pytest.raises(SystemExit, match="acceptance FAILED"):
        main_icvl_posereg_embedding.main(_argv(tmp_path, "--epochs", "1", "--nmax", "33",
                                               "--accept", "--accept-mm", "0.0001"))
    assert "acceptance [FAIL (synthetic smoke)]" in capsys.readouterr().out
    rec = json.load(open(tmp_path / "train_EMB_PCA30" / "results.json"))["acceptance"]
    assert rec["pass"] is False and "baseline" not in rec


def test_load_baseline_predictions_matches_jax(tmp_path, jcommon):
    """The baseline loader: --baseline-file, else --data + relpath, cut to
    the ground truth's frames, or (None, None); the JAX loader's arrays."""
    from deepprior_tpu.data.importers import ICVLImporter

    _write_icvl_baseline_txt(str(tmp_path / "bl.txt"), seed=5, n_frames=8)
    gt = np.zeros((5, 16, 3), np.float32)
    spec = {"label": "Tang et al.", "relpath": "bl.txt", "kind": "txt"}

    def jimp(bp):
        return ICVLImporter(bp, use_cache=False)

    for args in (SimpleNamespace(baseline_file=str(tmp_path / "bl.txt"), data=None),
                 SimpleNamespace(baseline_file=None, data=str(tmp_path))):
        preds, path = tcommon._load_baseline_predictions(args, ti.ICVLImporter, spec, gt)
        want, wpath = jcommon._load_baseline_predictions(args, jimp, spec, gt)
        assert preds.shape == (5, 16, 3) and preds.dtype == np.float32
        assert path == wpath
        np.testing.assert_array_equal(preds, want)
    args = SimpleNamespace(baseline_file=None, data=str(tmp_path / "nope"))
    assert tcommon._load_baseline_predictions(args, ti.ICVLImporter, spec, gt) == (None, None)
    args = SimpleNamespace(baseline_file=None, data=str(tmp_path))
    assert tcommon._load_baseline_predictions(args, ti.ICVLImporter, None, gt) == (None, None)


def test_accept_nyu_mat_matches_jax(tmp_path, jcommon):
    """The Tompson .mat branch (loadBaseline with the ground truth's depths)
    through ``_acceptance``: the record equals the JAX main's for the same
    predictions, the accept PDFs and the overlay are written."""
    import scipy.io
    from PIL import Image

    from deepprior_tpu.camera import NYU_CAMERA as J_NYU
    from deepprior_tpu.data.importers import NYUImporter as JNYUImporter
    from deepprior_tpu.eval import NYUHandposeEvaluation as JNYUEval

    seq = make_sequence(NYU_CAMERA, 4, num_joints=14, seed=11, name="test_1", keep_full=True)
    gt = np.stack([f.gt3Dorig for f in seq.data]).astype(np.float32)
    for i, fr in enumerate(seq.data):  # NYU's packing: depth = G << 8 | B
        d16 = fr.extraData["dpt_full"].astype(np.uint16)
        rgb = np.zeros(d16.shape + (3,), np.uint8)
        rgb[..., 1] = (d16 >> 8).astype(np.uint8)
        rgb[..., 2] = (d16 & 0xFF).astype(np.uint8)
        Image.fromarray(rgb).save(tmp_path / f"depth_1_{i + 1:07d}.png")
    rng = np.random.default_rng(3)
    pred = np.zeros((4, 14, 3))
    for i in range(4):
        uv = NYU_CAMERA.three_d_to_img_np(gt[i])[:, :2] + rng.normal(0.0, 1.0, (14, 2))
        pred[i, :, 0] = np.clip(uv[:, 0], 0, NYU_CAMERA.width - 1)
        pred[i, :, 1] = np.clip(uv[:, 1], 0, NYU_CAMERA.height - 1)
        pred[i, :, 2] = 1.0
    mat = tmp_path / "test_predictions.mat"
    scipy.io.savemat(str(mat), {"pred_joint_uvconf": pred[None],
                                "conv_joint_names": np.array([f"j{i}" for i in range(14)])[None]})
    args = SimpleNamespace(accept_mm=None, baseline_file=str(mat), data=None)
    joints = gt + rng.normal(0.0, 2.0, gt.shape).astype(np.float32)
    spec = tcommon.NYU_BASELINE
    outs = {k: tmp_path / k for k in ("port", "jax")}
    rec = tcommon._acceptance(args, ti.NYUImporter, NYU_CAMERA, NYUHandposeEvaluation, [seq],
                              [gt], [joints], str(outs["port"]), "NYU_SMOKE", spec, 10.0)
    want = jcommon._acceptance(args, lambda bp: JNYUImporter(bp, use_cache=False), J_NYU,
                               JNYUEval, [seq], [gt], [joints], str(outs["jax"]),
                               "NYU_SMOKE", spec, 10.0)
    assert rec == want
    assert 0.0 < rec["baseline"]["mean_mm"] < 100.0
    files = os.listdir(outs["port"])
    assert "NYU_SMOKE_accept_frameswithin.pdf" in files, files
    hpe = NYUHandposeEvaluation(gt, joints)
    hpe.subfolder = str(tmp_path)
    assert tcommon._plot_overlays(hpe, NYU_CAMERA, seq, joints, "NYU_SMOKE") == [
        os.path.join(str(tmp_path), "NYU_SMOKE_0.png")]
    assert "NYU_SMOKE_0.png" in os.listdir(tmp_path)


def test_com_refine_epilogue_and_accept(tmp_path, capsys):
    """The CoM-refinement epilogue: the refined CoM, the baseline's crop
    joint and the raw CoM, the curves and the threshold-curve PDFs, the
    result array; --accept passes a generous threshold and exits non-zero
    on an unbeatable one."""
    bl = tmp_path / "LRF_Results_seq_1.txt"
    _write_icvl_baseline_txt(str(bl), seed=SEED + 1, n_frames=32)
    main_icvl_com_refine.main(_argv(tmp_path, "--epochs", "1", "--nmax", "33", "--accept",
                                    "--baseline-file", str(bl), "--accept-mm", "1000"))
    out = capsys.readouterr().out
    for line in ("Refined CoM mean error:", "Baseline Tang et al. crop-joint mean error:",
                 "Raw CoM mean error:", "acceptance [PASS (synthetic smoke)]"):
        assert line in out, out
    outdir = tmp_path / "train_COM"
    rec = json.load(open(outdir / "results.json"))
    assert rec["refined"]["mean_mm"] > 0 and rec["com"]["mean_mm"] > 0
    assert rec["baseline"]["label"] == "Tang et al."
    assert 0.0 < rec["baseline"]["mean_mm"] < 100.0
    assert rec["acceptance"]["pass"] is True and rec["acceptance"]["synthetic"] is True
    files = os.listdir(outdir)
    assert {"result_train_COM.npy", "train_COM_cost.png", "train_COM_errs.png",
            "train_COM_frameswithin.pdf"} <= set(files), files
    joints = np.load(outdir / "result_train_COM.npy")
    assert joints.shape == (32, 1, 3) and np.isfinite(joints).all()
    with pytest.raises(SystemExit, match="acceptance FAILED"):
        main_icvl_com_refine.main(_argv(tmp_path / "fail", "--epochs", "1", "--nmax", "33",
                                        "--accept", "--accept-mm", "0.0001"))
    assert "acceptance [FAIL (synthetic smoke)]" in capsys.readouterr().out
    rec = json.load(open(tmp_path / "fail" / "train_COM" / "results.json"))
    assert rec["acceptance"]["pass"] is False


def test_accept_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib is missing: results.json with the acceptance
    record, the verdict, and one line for each plot file not written."""
    def missing():
        raise ImportError("plotting needs matplotlib, which is not installed")

    monkeypatch.setattr(tplots, "pyplot", missing)
    with pytest.raises(SystemExit, match="acceptance FAILED"):
        main_icvl_posereg_embedding.main(_argv(tmp_path, "--epochs", "1", "--nmax", "33",
                                               "--accept", "--accept-mm", "0.0001"))
    out = capsys.readouterr().out
    assert "acceptance [FAIL (synthetic smoke)]" in out
    outdir = tmp_path / "train_EMB_PCA30"
    assert json.load(open(outdir / "results.json"))["acceptance"]["pass"] is False
    missed = [ln for ln in out.splitlines() if ln.startswith("plot not written")]
    names = {"_cost.png", "_errs.png", "_0.png", "_20.png",
             "_test_seq_1_frameswithin.pdf", "_accept_maxerror.pdf"}
    for name in names:
        assert any(ln.endswith("train_EMB_PCA30" + name) for ln in missed), (name, missed)
    assert all("matplotlib" in ln for ln in missed)
    assert len(missed) == 2 + 2 + 3 + 3
    assert not [f for f in os.listdir(outdir) if f.endswith((".png", ".pdf"))]


def test_crossval_accept_runs_every_fold(tmp_path, capsys):
    """MSRA15's cross-validation under --accept: a fold that misses still
    lets the others run, and the main then exits non-zero naming it."""
    from deepprior_tpu_torch.data import trees

    root = str(tmp_path / "msra")
    trees.write_msra15_tree(root, subjects=[f"P{i}" for i in range(9)], frames=2, seed=1)
    with pytest.raises(SystemExit, match="failed folds: P8"):
        main_msra15_posereg_embedding_crossval.main(
            ["--data", root, "--holdout", "P8", "--epochs", "1", "--batch-size", "16",
             "--out", str(tmp_path / "out"), "--device", "cpu", "--accept",
             "--accept-mm", "0.0001"])
    assert "1 fold(s) failed acceptance" in capsys.readouterr().out
