"""The port's drawing and small host helpers against the JAX package, on the
same numpy inputs: eval/plots.py (the raster helpers and plotJoints on an
ndarray bit for bit; the matplotlib figures written), the evaluation
classes' plot methods and getPCL, utils/text.py::draw_text,
utils/helpers.py and utils/pointcloud.py, each bit for bit where it
returns an array.  ``hsv_to_rgb`` (the port's numpy copy of matplotlib's,
so that ndarray drawing needs no matplotlib) equals matplotlib's.
"""

import builtins
import os

import numpy as np
import pytest

from deepprior_tpu.eval import plots as jplots
from deepprior_tpu.eval.datasets import (ICVLHandposeEvaluation as JICVL,
                                         MSRAHandposeEvaluation as JMSRA,
                                         NYUHandposeEvaluation as JNYU)

from deepprior_tpu_torch.eval import plots as tplots
from deepprior_tpu_torch.eval.datasets import (ICVLHandposeEvaluation,
                                               MSRAHandposeEvaluation,
                                               NYUHandposeEvaluation)
from deepprior_tpu_torch.eval.metrics import HandposeEvaluation

EVALS = {"icvl": (ICVLHandposeEvaluation, JICVL, 16), "nyu": (NYUHandposeEvaluation, JNYU, 14),
         "msra": (MSRAHandposeEvaluation, JMSRA, 21)}


def _pair(name, seed=0, n=6):
    tcls, jcls, j = EVALS[name]
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-100.0, 100.0, (n, j, 3)).astype(np.float32)
    gt[..., 2] += 600.0
    pred = gt + rng.normal(0.0, 8.0, gt.shape).astype(np.float32)
    return tcls(gt, pred), jcls(gt, pred), rng


@pytest.fixture
def no_matplotlib(monkeypatch):
    real = builtins.__import__

    def imp(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", imp)


# ------------------------------------------------------------ colours, rasters
def test_hsv_to_rgb_matches_matplotlib():
    """Every sextant, s == 0, h == 1: matplotlib's values exactly."""
    from matplotlib.colors import hsv_to_rgb

    rng = np.random.default_rng(1)
    hsv = rng.uniform(0.0, 1.0, (257, 3))
    hsv[:7, 0] = np.arange(7) / 6.0
    hsv[7:10, 1] = 0.0
    np.testing.assert_array_equal(tplots.hsv_to_rgb(hsv), hsv_to_rgb(hsv))
    for n in (1, 13, 15, 36):
        for t, j in zip(tplots._finger_colors(n), jplots._finger_colors(n)):
            np.testing.assert_array_equal(t, j)
        for t, j in zip(tplots._joint_colors(n), jplots._joint_colors(n)):
            np.testing.assert_array_equal(t, j)


def test_raster_helpers_match_jax():
    """_stamp, _raster_line and _raster_disk on random, border-clipped and
    off-canvas shapes: the JAX canvases bit for bit."""
    rng = np.random.default_rng(2)
    a = np.zeros((60, 80, 3), np.uint8)
    b = a.copy()
    for _ in range(40):
        u, v = rng.integers(-20, 100, 2)
        r = int(rng.integers(0, 5))
        col = rng.integers(0, 256, 3).astype(np.uint8)
        tplots._stamp(a, u, v, r, col)
        jplots._stamp(b, u, v, r, col)
        p0, p1 = rng.uniform(-30, 110, 2), rng.uniform(-30, 110, 2)
        th = float(rng.uniform(1, 7))
        tplots._raster_line(a, p0, p1, col, th)
        jplots._raster_line(b, p0, p1, col, th)
        c = rng.uniform(-15, 95, 2)
        rad = float(rng.uniform(0, 9))
        tplots._raster_disk(a, c[0], c[1], rad, col)
        jplots._raster_disk(b, c[0], c[1], rad, col)
        np.testing.assert_array_equal(a, b)
    assert a.any()
    for c in ((0.2, 0.5, 1.0), (10, 200, 30), [0.0, 0.0, 0.0]):
        np.testing.assert_array_equal(tplots._img_color(c), jplots._img_color(c))


@pytest.mark.parametrize("name", ["icvl", "nyu", "msra"])
def test_plot_joints_on_an_image_matches_jax(name):
    """plotJoints on an (H, W, 3) uint8 image, every colour option and
    annoscale, a short skeleton (edges skipped, markers drawn): the JAX
    image bit for bit."""
    tev, jev, rng = _pair(name)
    j2d = rng.uniform(-10.0, 140.0, (EVALS[name][2], 2))
    for color, jcolor, scale in (("nice", "nice", 1), ("gray", "gray", 2),
                                 ((255, 0, 0), None, 1), ((0.1, 0.9, 0.3), (0, 0, 255), 1)):
        a = np.zeros((128, 128, 3), np.uint8)
        b = a.copy()
        tev.plotJoints(a, j2d, color=color, jcolor=jcolor, annoscale=scale)
        jev.plotJoints(b, j2d, color=color, jcolor=jcolor, annoscale=scale)
        np.testing.assert_array_equal(a, b)
        assert a.any()
    a, b = np.zeros((64, 64, 3), np.uint8), np.zeros((64, 64, 3), np.uint8)
    tev.plotJoints(a, j2d[:4], jcolor="nice")
    jev.plotJoints(b, j2d[:4], jcolor="nice")
    np.testing.assert_array_equal(a, b)


def test_plot_joints_on_an_image_needs_no_matplotlib(no_matplotlib):
    tev, _, rng = _pair("nyu")
    img = np.zeros((64, 64, 3), np.uint8)
    tev.plotJoints(img, rng.uniform(0, 64, (14, 2)), jcolor="nice")
    assert img.any()


# ------------------------------------------------------------ figures
def test_figures_are_written(tmp_path):
    """plotEvaluation (three PDFs, with a baseline), plotResult (a PNG, or
    the figure), plot_result_3d, plotJoints on an axis: the JAX package's
    files, by name."""
    import matplotlib.pyplot as plt

    tev, jev, rng = _pair("icvl")
    base, _, _ = _pair("icvl", seed=1)
    for ev, sub in ((tev, "port"), (jev, "jax")):
        ev.subfolder = str(tmp_path / sub)
    files = tev.plotEvaluation("run", baseline=[("worse", base)])
    want = jev.plotEvaluation("run", baseline=[("worse", _pair("icvl", seed=1)[1])])
    assert [os.path.basename(f) for f in files] == [os.path.basename(f) for f in want]
    assert all(os.path.getsize(f) > 0 for f in files)
    dpt = rng.uniform(-1, 1, (128, 128)).astype(np.float32)
    j2d = rng.uniform(0, 128, (16, 2))
    p = tev.plotResult(dpt, j2d, j2d + 2.0, name="overlay")
    assert p == os.path.join(str(tmp_path / "port"), "overlay.png") and os.path.getsize(p) > 0
    fig = tev.plotResult(dpt, None, j2d)
    plt.close(fig)
    p3 = tplots.plot_result_3d(tev, tev.gt[0], rng.uniform(-50, 50, (200, 3)), name="hand")
    assert p3.endswith("hand_3d.png") and os.path.getsize(p3) > 0
    fig, ax = plt.subplots()
    assert tev.plotJoints(ax, j2d, color="gray", jcolor="nice") is ax
    plt.close(fig)


def test_figures_name_matplotlib_when_missing(tmp_path, no_matplotlib):
    tev, _, rng = _pair("icvl")
    tev.subfolder = str(tmp_path)
    with pytest.raises(ImportError, match="matplotlib"):
        tev.plotEvaluation("run")
    with pytest.raises(ImportError, match="matplotlib"):
        tev.plotResult(np.zeros((8, 8), np.float32), None, np.zeros((16, 2)), name="x")
    from deepprior_tpu_torch.utils.pointcloud import PointCloud

    with pytest.raises(ImportError, match="matplotlib"):
        PointCloud().set_points(np.ones((4, 3))).save(str(tmp_path / "pc.png"))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", ["icvl", "nyu", "msra"])
def test_get_pcl_matches_jax(name):
    """getPCL of a crop through its M: the JAX evaluation's points bit for
    bit; the base class, which has no camera, raises."""
    tev, jev, rng = _pair(name)
    dpt = np.zeros((32, 32), np.float32)
    dpt[8:20, 10:25] = rng.uniform(-1.0, 1.0, (12, 15))
    m = np.array([[0.5, 0.0, -40.0], [0.0, 0.5, -30.0], [0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_array_equal(tev.getPCL(dpt, m), jev.getPCL(dpt, m))
    with pytest.raises(NotImplementedError):
        HandposeEvaluation(tev.gt, tev.joints).getPCL(dpt, m)


# ------------------------------------------------------------ text, helpers
def test_draw_text_matches_jax():
    """Every glyph, an unknown character, lower case, clipped at each edge,
    in two colours: the JAX canvas bit for bit."""
    from deepprior_tpu.utils.text import draw_text as jdraw

    from deepprior_tpu_torch.utils.text import draw_text

    a = np.full((40, 90, 3), 255, np.uint8)
    b = a.copy()
    for text, x, y, col in (("0123456789 ABCDEF", 1, 1, (0, 0, 0)),
                            ("GHIKLMNOPRSTUVWXY", -3, 10, (255, 0, 0)),
                            ("-./: fps 29.9 ~?", 50, 20, (0, 128, 0)),
                            ("EDGE", 80, 36, (0, 0, 255)), ("TOP", 10, -4, (9, 9, 9))):
        assert draw_text(a, text, x, y, col) is a
        jdraw(b, text, x, y, col)
        np.testing.assert_array_equal(a, b)
    assert (a != 255).any()


def test_helpers_match_jax():
    from deepprior_tpu.utils import helpers as jh

    from deepprior_tpu_torch.utils import helpers as th

    arrays = [np.array([1, 2, 3]), np.array([4.5, 5.5]), np.array([6, 7])]
    np.testing.assert_array_equal(th.cartesian(arrays), jh.cartesian(arrays))
    for sigma in (None, 1.5):
        np.testing.assert_array_equal(th.gaussian_kernel(7, sigma), jh.gaussian_kernel(7, sigma))
    rgb = np.random.default_rng(3).uniform(0, 255, (5, 6, 3))
    np.testing.assert_array_equal(th.rgb_to_gray(rgb), jh.rgb_to_gray(rgb))
    assert list(th.chunks(list(range(10)), 4)) == list(jh.chunks(list(range(10)), 4))
    for make in (lambda: np.random.RandomState(5), lambda: np.random.default_rng(5)):
        mine = [np.arange(12).reshape(6, 2), np.arange(6) * 10.0]
        theirs = [a.copy() for a in mine]
        th.shuffle_many_inplace(mine, make())
        jh.shuffle_many_inplace(theirs, make())
        for g, w in zip(mine, theirs):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(mine[0][:, 0] * 5, mine[1])  # still co-indexed
    with pytest.raises(ValueError, match="co-indexed"):
        th.shuffle_many_inplace([np.arange(3), np.arange(4)])


def test_point_cloud_matches_jax(tmp_path):
    """Subsampling to max_num_points, add_point past the cap and clear: the
    JAX cloud's points (the same seeded generator); save writes a PNG."""
    from deepprior_tpu.utils.pointcloud import PointCloud as JPointCloud

    from deepprior_tpu_torch.utils.pointcloud import PointCloud

    pts = np.random.default_rng(6).uniform(-100, 100, (500, 3))
    t, j = PointCloud(max_num_points=100), JPointCloud(max_num_points=100)
    np.testing.assert_array_equal(t.set_points(pts).points, j.set_points(pts).points)
    for p in pts[:3]:
        t.add_point(p)
        j.add_point(p)
    np.testing.assert_array_equal(t.points, j.points)
    assert t.clear_points().points.shape == (0, 3)
    small = PointCloud().set_points(pts[:10])
    assert small.add_point(pts[11]).points.shape == (11, 3)
    path = small.save(str(tmp_path / "pc.png"))
    assert os.path.getsize(path) > 0
