"""The port's importers (deepprior_tpu_torch/data/importers.py) against the
JAX package's, on the CPU, over seeded dataset trees in the real formats
(``data/trees.py``: MSRA15 .bin, ICVL 16-bit PNG, NYU packed RGB PNG):

- the host crop: every frame field bit-equal (crop, T, CoM, gtorig,
  gtcrop, gt3Dorig, gt3Dcrop), with docom and without;
- device_crop=True: crops bit-equal (``ops/crop.py``'s nearest parity),
  T within rtol 1e-6 (test_torch_crop.py), CoMs within ``ops/com.py``'s
  rtol 1e-4 / atol 1e-2 (test_torch_com.py);
- the .npz cache read across the packages both ways, the Nmax rule, the
  subsequence filters, MSRA15 mirroring and the baseline parsers equal;
- comref with a ScaleNet converted from the JAX one
  (``utils/convert.py``): CoMs within rtol 1e-4 / atol 1e-2 on both paths;
- ``Dataset.imgStackDepthOnly`` and the per-dataset evaluation classes
  equal to the JAX package's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from deepprior_tpu.camera import MSRA15_CAMERA as J_MSRA15
from deepprior_tpu.data import dataset as jdataset
from deepprior_tpu.data import importers as ji
from deepprior_tpu.eval import datasets as jeval
from deepprior_tpu.models import ScaleNet as FlaxScaleNet
from deepprior_tpu.models import ScaleNetConfig as FlaxScaleNetConfig
from deepprior_tpu.ops.refine_cnn import CNNComRefiner as JaxRefiner

from deepprior_tpu_torch.camera import MSRA15_CAMERA
from deepprior_tpu_torch.data import dataset as tdataset
from deepprior_tpu_torch.data import importers as ti
from deepprior_tpu_torch.data import trees
from deepprior_tpu_torch.eval import datasets as teval
from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
from deepprior_tpu_torch.train.checkpoint import save_checkpoint
from deepprior_tpu_torch.utils.convert import scalenet_state_dict_from_flax

FIELDS = ("dpt", "T", "com", "gtorig", "gtcrop", "gt3Dorig", "gt3Dcrop")
COM_TOL = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These CPU runs are small: one intra-op thread runs them as fast and
    keeps them from contending for the cores with parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    out = {k: str(base / k) for k in ("msra", "icvl", "nyu")}
    trees.write_msra15_tree(out["msra"], subjects=("P0", "P8"), frames=5, seed=1)
    # a second gesture of P0 for the subsequence filter
    trees.write_msra15_tree(out["msra"], subjects=("P0",), frames=3, seed=4, gesture="2")
    # ICVL's train and MSRA15's P0 are both 8 frames of 320x240, so the JAX
    # importers' batched crop compiles its shapes once for the two
    trees.write_icvl_tree(out["icvl"], {"train": 8, "test_seq_1": 2}, seed=2)
    trees.write_icvl_tree(out["icvl"], {"test_seq_2": 3}, seed=5, subseq="201406191014")
    trees.write_nyu_tree(out["nyu"], {"train": 3, "test_1": 2}, seed=3)
    return out


# (importer name, tree, sequence)
CASES = [("MSRA15Importer", "msra", "P0"), ("ICVLImporter", "icvl", "train"),
         ("NYUImporter", "nyu", "train")]


def _pair(name, root, **kw):
    return (getattr(ti, name)(root, device="cpu", **kw), getattr(ji, name)(root, **kw))


def _assert_frames_equal(got, want, device_crop=False):
    assert len(got.data) == len(want.data) > 0
    assert got.config == want.config
    for fg, fw in zip(got.data, want.data):
        assert (fg.fileName, fg.subSeqName, fg.side) == (fw.fileName, fw.subSeqName, fw.side)
        for k in FIELDS:
            g, w = np.asarray(getattr(fg, k)), np.asarray(getattr(fw, k))
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if not device_crop or k in ("dpt", "gtorig", "gt3Dorig"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif k == "T":
                np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
            else:  # the CoM and what derives from it
                np.testing.assert_allclose(g, w, err_msg=k, **COM_TOL)


@pytest.mark.parametrize("docom", [False, True])
@pytest.mark.parametrize("device_crop", [False, True])
@pytest.mark.parametrize("name,tree,seq", CASES)
def test_frames_match_jax(roots, name, tree, seq, docom, device_crop):
    port, jax_imp = _pair(name, roots[tree], use_cache=False)
    kw = dict(docom=docom, device_crop=device_crop)
    _assert_frames_equal(port.loadSequence(seq, **kw), jax_imp.loadSequence(seq, **kw),
                         device_crop)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name,tree,seq", CASES)
def test_cache_reads_across_packages(roots, tmp_path, name, tree, seq, writer):
    """A cache written by one package loads in the other (same file name,
    same arrays), and a hit gives the frames of a fresh load."""
    cache = str(tmp_path / "cache")
    port, jax_imp = _pair(name, roots[tree], cache_dir=cache)
    first, second = (port, jax_imp) if writer == "port" else (jax_imp, port)
    fresh = first.loadSequence(seq, docom=True)
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].startswith(f"{name}_{seq}")
    assert files[0].endswith("_com_" + str(int(fresh.config["cube"][0])) + "_cache.npz")
    hit = second.loadSequence(seq, docom=True)
    _assert_frames_equal(hit, fresh)
    rng_args = [np.random.RandomState(7) for _ in range(2)]
    a = port.loadSequence(seq, docom=True, shuffle=True, rng=rng_args[0], Nmax=2)
    b = jax_imp.loadSequence(seq, docom=True, shuffle=True, rng=rng_args[1], Nmax=2)
    _assert_frames_equal(a, b)
    assert len(a.data) == 2


def test_nmax_load_does_not_write_the_cache(roots, tmp_path):
    """A load truncated by Nmax writes no cache (its key does not hold
    Nmax); a full load does, and hits truncate on read."""
    cache = str(tmp_path / "cache")
    imp = ti.MSRA15Importer(roots["msra"], cache_dir=cache, device="cpu")
    assert len(imp.loadSequence("P8", Nmax=2).data) == 2
    assert not os.path.isdir(cache) or not os.listdir(cache)
    assert len(imp.loadSequence("P8").data) == 5
    assert len(os.listdir(cache)) == 1
    assert len(imp.loadSequence("P8", Nmax=3).data) == 3
    assert len(imp.loadSequence("P8").data) == 5
    # device_crop truncates the same way
    imp2 = ti.MSRA15Importer(roots["msra"], cache_dir=str(tmp_path / "c2"), device="cpu")
    assert len(imp2.loadSequence("P8", Nmax=2, device_crop=True).data) == 2
    assert not os.path.isdir(str(tmp_path / "c2"))


@pytest.mark.parametrize("case", ["msra", "icvl"])
def test_subsequence_filters_match_jax(roots, case):
    if case == "msra":
        port, jax_imp = _pair("MSRA15Importer", roots["msra"], use_cache=False)
        seq, subsets = "P0", (["2"], ["1", "2"], ["9"])
    else:  # '0' is the raw subsequence: plain paths longer than 6 chars
        port, jax_imp = _pair("ICVLImporter", roots["icvl"], use_cache=False)
        seq, subsets = "test_seq_2", (["0"], ["seq1"], ["0", "seq1"])
    sizes = []
    for sub in subsets:
        got, want = port.loadSequence(seq, subSeq=sub), jax_imp.loadSequence(seq, subSeq=sub)
        sizes.append(len(got.data))
        if want.data:
            _assert_frames_equal(got, want)
        else:
            assert not got.data
    assert sizes == ([3, 8, 0] if case == "msra" else [3, 0, 3])


@pytest.mark.parametrize("device_crop", [False, True])
def test_msra_mirroring_matches_jax(roots, device_crop):
    port, jax_imp = _pair("MSRA15Importer", roots["msra"], use_cache=False, hand="left")
    got = port.loadSequence("P0", device_crop=device_crop)
    _assert_frames_equal(got, jax_imp.loadSequence("P0", device_crop=device_crop),
                         device_crop)
    plain = ti.MSRA15Importer(roots["msra"], use_cache=False, device="cpu").loadSequence("P0")
    for fm, fp in zip(got.data, plain.data):
        np.testing.assert_allclose(fm.gtorig[:, 0], 320.0 - fp.gtorig[:, 0], atol=1e-3)
    with pytest.raises(NotImplementedError, match="right-hand only"):
        ti.ICVLImporter(roots["icvl"], hand="left", device="cpu").loadSequence("train")


def test_baseline_parsers_match_jax(roots, tmp_path):
    rng = np.random.default_rng(6)
    # ICVL text: with and without a leading file name
    vals = rng.uniform(100.0, 500.0, (3, 48)).astype(np.float32)
    for first_name, prefix in ((False, ""), (True, "img.png ")):
        path = tmp_path / f"icvl_{first_name}.txt"
        path.write_text("\n".join(prefix + " ".join(f"{v:.3f}" for v in row)
                                  for row in vals) + "\n\n")
        port, jax_imp = _pair("ICVLImporter", roots["icvl"])
        for fn in ("loadBaseline", "loadBaseline2D"):
            if fn == "loadBaseline2D":
                path.write_text("\n".join(prefix + " ".join(f"{v:.3f}" for v in row)
                                          for row in vals) + "\n")
            got = getattr(port, fn)(str(path), first_name=first_name)
            want = getattr(jax_imp, fn)(str(path), first_name=first_name)
            np.testing.assert_array_equal(np.stack(got), np.stack(want))
    # NYU: the .mat with the ground-truth depth fix-up, a text file, and 2D
    nyu = os.path.join(roots["nyu"], "test_1")
    nj = 14
    pred = rng.uniform(50.0, 400.0, (2, nj, 3))
    pred[1, 3] = 0.0  # an all-zero joint is dropped
    mat = os.path.join(nyu, "test_predictions.mat")
    scipy.io.savemat(mat, {"pred_joint_uvconf": pred[None],
                           "conv_joint_names": np.array([f"j{i}" for i in range(nj)])[None]})
    gt = rng.uniform(500.0, 800.0, (2, nj, 3))
    txt = tmp_path / "nyu.txt"
    txt.write_text("\n".join(" ".join(f"{v:.3f}" for v in row)
                             for row in vals[:, :42]) + "\n")
    try:
        port, jax_imp = _pair("NYUImporter", roots["nyu"])
        np.testing.assert_array_equal(np.stack(port.loadBaseline(mat, gt=gt)),
                                      np.stack(jax_imp.loadBaseline(mat, gt=gt)))
        # the text form: the JAX importer opens every file as a .mat first
        # and so never reaches its text branch; the port parses it
        with pytest.raises(ValueError):
            jax_imp.loadBaseline(str(txt))
        np.testing.assert_array_equal(
            np.stack(port.loadBaseline(str(txt))),
            jax_imp.jointsImgTo3D(np.array(
                [ln.split(" ") for ln in txt.read_text().strip().split("\n")],
                np.float32).reshape(3, 14, 3)))
        np.testing.assert_array_equal(np.stack(port.loadBaseline2D(mat)),
                                      np.stack(jax_imp.loadBaseline2D(mat)))
        assert port.num_joints == jax_imp.num_joints == nj
    finally:
        os.remove(mat)


@pytest.fixture(scope="module")
def scalenets():
    """A small flax ScaleNet (hidden 64) with seeded weights, and the port's
    copy of it.  The weights are drawn with numpy at flax's shapes (fan-in
    scaled kernels), which takes no time where ``init`` compiles op by op."""
    fmodel = FlaxScaleNet(FlaxScaleNetConfig(hidden=64))
    shapes = jax.eval_shape(fmodel.init, jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    rng = np.random.default_rng(3)
    variables = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))).astype(s.dtype), shapes)
    params = jax.tree.map(np.asarray, variables["params"])
    model = ScaleNet(ScaleNetConfig(hidden=64)).eval()
    model.load_state_dict(scalenet_state_dict_from_flax(params))
    return fmodel, variables, model


@pytest.mark.parametrize("device_crop", [False, True])
@pytest.mark.parametrize("name,tree,seq", CASES)
def test_comref_matches_jax(roots, scalenets, name, tree, seq, device_crop):
    """docom with a CNN refiner attached: the same converted ScaleNet moves
    the CoM in both packages, on the host path and the batched path."""
    fmodel, variables, model = scalenets
    port, jax_imp = _pair(name, roots[tree], use_cache=False)
    port.load_refine_net_lazy(CNNComRefiner(model, port.camera))
    jax_imp.load_refine_net_lazy(JaxRefiner(fmodel, variables, jax_imp.camera))
    kw = dict(docom=True, device_crop=device_crop)
    got, want = port.loadSequence(seq, **kw), jax_imp.loadSequence(seq, **kw)
    assert len(got.data) == len(want.data) > 0
    plain = getattr(ti, name)(roots[tree], use_cache=False, device="cpu").loadSequence(
        seq, **kw)
    moved = 0.0
    for fg, fw, fp in zip(got.data, want.data, plain.data):
        np.testing.assert_allclose(fg.com, fw.com, **COM_TOL)
        np.testing.assert_allclose(fg.gt3Dcrop, fw.gt3Dcrop, **COM_TOL)
        moved = max(moved, float(np.abs(fg.com - fp.com).max()))
    assert moved > 0.1  # the refiner moved the CoMs


def test_load_refine_net_lazy_reads_a_port_checkpoint(roots, tmp_path):
    """A ScaleNet state dict saved under "params" (as run_com_refine writes
    net_<prefix>.ckpt) loads into the importer's CNNComRefiner on its
    device, with every tensor restored; the cache tag becomes 'comref'."""
    model = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3),
                     generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "net_P0_COM.ckpt")
    save_checkpoint(path, {"params": model.state_dict()})
    imp = ti.MSRA15Importer(roots["msra"], cache_dir=str(tmp_path / "c"), device="cpu")
    refiner = imp.load_refine_net_lazy(path)
    assert isinstance(refiner, CNNComRefiner) and imp.refine_net is refiner
    for k, v in model.state_dict().items():
        assert torch.equal(refiner.model.state_dict()[k], v), k
    assert imp.load_refine_net_lazy(None) is refiner
    imp.loadSequence("P8", docom=True)
    assert os.listdir(str(tmp_path / "c"))[0].endswith("_comref_150_cache.npz")


def test_dataset_stack_matches_jax(roots):
    seq = ti.NYUImporter(roots["nyu"], use_cache=False, device="cpu").loadSequence("test_1")
    port = tdataset.NYUDataset([seq], basepath=roots["nyu"], device="cpu")
    jax_ds = jdataset.NYUDataset([seq], basepath=roots["nyu"])
    for z1 in (False, True):
        for g, w in zip(port.imgStackDepthOnly("test_1", normZeroOne=z1),
                        jax_ds.imgStackDepthOnly("test_1", normZeroOne=z1)):
            np.testing.assert_array_equal(g, w)
    assert port.imgStackDepthOnly("missing") == []
    assert isinstance(port.lmi, ti.NYUImporter)
    assert isinstance(tdataset.ICVLDataset(device="cpu").lmi, ti.ICVLImporter)
    assert isinstance(tdataset.MSRA15Dataset(device="cpu").lmi, ti.MSRA15Importer)


def test_importer_device_defaults_to_the_card(roots, monkeypatch):
    """Without a device the importer takes the CUDA card, as the entry
    points do, and raises when there is none: the CPU is only asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ti.MSRA15Importer(roots["msra"], use_cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdataset.NYUDataset(basepath=roots["nyu"])
    assert ti.NYUImporter(roots["nyu"], device="cpu").device == torch.device("cpu")


def test_evaluation_classes_match_jax():
    rng = np.random.default_rng(0)
    for nj in (14, 16, 21, 36):
        gt, pred = rng.normal(size=(2, 5, nj, 3)) * 50.0
        tcls, jcls = teval.evaluation_for(nj), jeval.evaluation_for(nj)
        assert tcls.__name__ == jcls.__name__
        got, want = tcls(gt, pred), jcls(gt, pred)
        assert got.joint_names == want.joint_names
        assert got.joint_connections == want.joint_connections
        assert got.fps == want.fps and got.getMeanError() == want.getMeanError()
    assert teval.MSRAHandposeEvaluation.camera == MSRA15_CAMERA
    assert tuple(teval.MSRAHandposeEvaluation.camera) == tuple(J_MSRA15)


def test_png_decoding_names_pillow_when_missing(roots, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    imp = ti.ICVLImporter(roots["icvl"], use_cache=False, device="cpu")
    with pytest.raises(ImportError, match="Pillow"):
        imp.loadSequence("train")
    # MSRA15 needs no PIL
    assert len(ti.MSRA15Importer(roots["msra"], use_cache=False,
                                 device="cpu").loadSequence("P8").data) == 5
