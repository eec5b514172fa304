"""Evaluation plots: threshold curves, per-joint bars, skeleton overlays.

Counterpart of deepprior_tpu/eval/plots.py (reference
handpose_evaluation.py:230-486): the fraction-of-frames-vs-threshold PDF,
per-joint mean/max bar charts, the 2D skeleton overlay and a matplotlib 3D
stick figure in place of the reference's VTK render.

matplotlib (its Agg backend) is imported when a figure is drawn, never when
this module is imported: the port's entry points run where it may be
missing, and there every figure raises ImportError naming it.  Drawing on
an (H, W, 3) uint8 array (``plot_joints`` on an ndarray and its raster
helpers) is numpy only, with the colour ramps of ``hsv_to_rgb`` below, and
gives the JAX package's pixels.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError naming matplotlib
    where it is not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "plotting needs matplotlib, which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def hsv_to_rgb(hsv) -> np.ndarray:
    """(..., 3) HSV in [0, 1] -> RGB, in the arithmetic of
    matplotlib.colors.hsv_to_rgb (the JAX package's ramps call it)."""
    hsv = np.asarray(hsv)
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32), ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # (r, g, b) of each sextant
    picks = {0: (v, t, p), 1: (q, v, p), 2: (p, v, t), 3: (p, q, v), 4: (t, p, v),
             5: (v, p, q)}
    rgb = [np.empty_like(h) for _ in range(3)]
    for sextant, chans in picks.items():
        idx = (i % 6 == 0) if sextant == 0 else (i == sextant)
        for out, src in zip(rgb, chans):
            out[idx] = src[idx]
    for out in rgb:
        out[s == 0] = v[s == 0]
    return np.stack(rgb, axis=-1).reshape(in_shape)


_HUES = [0.00, 0.33, 0.50, 0.66, 0.83, 0.16]


def _ramp(n: int, v0: float, dv: float, n_fingers: int = 5):
    """n colours: a hue per finger, the value rising v0 + dv * k / per."""
    per = max(1, n // max(n_fingers, 1))
    return [hsv_to_rgb([_HUES[min(i // per, len(_HUES) - 1)], 1.0,
                        v0 + dv * ((i % per) + 1) / per]) for i in range(n)]


def _finger_colors(n_edges: int, n_fingers: int = 5):
    """HSV ramp per finger, like the reference's jointConnectionColors."""
    return _ramp(n_edges, 0.5, 0.5, n_fingers)


def _joint_colors(n_joints: int, n_fingers: int = 5):
    """HSV ramp per joint, grouped by finger: the reference's jointColors
    tables (handpose_evaluation.py:700-719 etc.) as a formula."""
    return _ramp(n_joints, 0.4, 0.6, n_fingers)


def _rgb_to_gray(rgb):
    g = 0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2]
    return np.array([g, g, g])


def _ensure_dir(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


# ----------------------------------------------------------------------
# joint drawing on an ndarray (the reference's cv2 path, here a small numpy
# rasterizer)
# ----------------------------------------------------------------------
def _stamp(img, u, v, r, color):
    h, w = img.shape[:2]
    u0, u1 = max(0, u - r), min(w, u + r + 1)
    v0, v1 = max(0, v - r), min(h, v + r + 1)
    if u0 < u1 and v0 < v1:
        img[v0:v1, u0:u1] = color


def _raster_line(img, p0, p1, color, thickness):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) * 2 + 2
    us = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    vs = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    r = max(1, int(round(thickness / 2)))
    for u, v in zip(us, vs):
        _stamp(img, u, v, r, color)


def _raster_disk(img, u, v, radius, color):
    h, w = img.shape[:2]
    u, v, radius = int(round(u)), int(round(v)), int(round(radius))
    u0, u1 = max(0, u - radius), min(w, u + radius + 1)
    v0, v1 = max(0, v - radius), min(h, v + radius + 1)
    if u0 >= u1 or v0 >= v1:
        return
    uu, vv = np.meshgrid(np.arange(u0, u1), np.arange(v0, v1))
    mask = (uu - u) ** 2 + (vv - v) ** 2 <= radius**2
    img[v0:v1, u0:u1][mask] = color


def _img_color(c):
    """Colour spec -> uint8 RGB triple for ndarray drawing."""
    c = np.asarray(c, np.float64).reshape(-1)[:3]
    if c.max() <= 1.0:
        c = c * 255.0
    return c.astype(np.uint8)


def plot_joints(ev, ax, joints2d, color="nice", jcolor=None, annoscale=1):
    """Draw the skeleton and joint markers of ``ev``'s dataset on ``ax``: a
    matplotlib axis, or an (H, W, 3) uint8 image drawn in place.
    ``color``/``jcolor``: 'nice' (the per-finger HSV ramp), 'gray', or a
    colour; ``jcolor=None`` draws no markers.  Edges are drawn only when the
    joints reach the skeleton's largest index (handpose_evaluation.py:
    435-487)."""
    joints2d = np.asarray(joints2d, np.float64)
    conns = list(ev.joint_connections)
    ccolors = _finger_colors(len(conns)) if conns else []
    jcolors = _joint_colors(joints2d.shape[0])
    is_img = isinstance(ax, np.ndarray)

    if conns and joints2d.shape[0] >= int(np.max(conns)):
        for ci, (a, b) in enumerate(conns):
            if a >= joints2d.shape[0] or b >= joints2d.shape[0]:
                continue
            if color == "nice":
                lc = ccolors[ci]
            elif color == "gray":
                lc = _rgb_to_gray(ccolors[ci])
            else:
                lc = color
            if is_img:
                _raster_line(ax, joints2d[a], joints2d[b], _img_color(lc), 3 * annoscale)
            else:
                ax.plot([joints2d[a, 0], joints2d[b, 0]], [joints2d[a, 1], joints2d[b, 1]],
                        c=lc, linewidth=3.0 * annoscale)
    if jcolor is None:
        return ax
    for i in range(joints2d.shape[0]):
        if jcolor == "nice":
            jc = jcolors[i]
        elif jcolor == "gray":
            jc = _rgb_to_gray(jcolors[i])
        else:
            jc = jcolor
        if is_img:
            _raster_disk(ax, joints2d[i, 0], joints2d[i, 1], 6 * annoscale, _img_color(jc))
        else:
            ax.scatter(joints2d[i, 0], joints2d[i, 1], marker="o", s=100,
                       c=[np.asarray(jc, np.float64).reshape(-1)[:3]])
    return ax


# ----------------------------------------------------------------------
# figures (matplotlib)
# ----------------------------------------------------------------------
def plot_evaluation(ev, name: str, method_name="Ours", baseline=None):
    """The threshold curve and the per-joint mean/max bars as PDFs under
    ``ev.subfolder``; ``baseline`` is a list of (label, evaluation).
    Returns the files written."""
    plt = pyplot()
    baseline = baseline or []
    out = []
    sub = ev.subfolder
    os.makedirs(sub, exist_ok=True)

    # fraction of frames within max-joint distance
    fig, ax = plt.subplots(figsize=(6, 4.5))
    t, frac = ev.successCurve()
    ax.plot(t, 100.0 * frac, label=method_name)
    for label, base in baseline:
        tb, fb = base.successCurve()
        ax.plot(tb, 100.0 * fb, "--", label=label)
    ax.set_xlabel("Distance threshold / mm")
    ax.set_ylabel("Fraction of frames within distance / %")
    ax.set_ylim(0, 100)
    ax.grid(True, alpha=0.3)
    if ev.dolegend:
        ax.legend(loc="lower right")
    p = os.path.join(sub, f"{name}_frameswithin.pdf")
    fig.savefig(p, bbox_inches="tight")
    plt.close(fig)
    out.append(p)

    # per-joint mean and max error bars
    nj = ev.dists.shape[1]
    names = list(ev.joint_names) or [str(i) for i in range(nj)]
    names = (names + [str(i) for i in range(nj)])[:nj] + ["Avg"]
    for kind, vals in (
        ("meanerror", [ev.getJointMeanError(j) for j in range(nj)] + [ev.getMeanError()]),
        ("maxerror", [ev.getJointMaxError(j) for j in range(nj)] + [ev.getMaxError()]),
    ):
        fig, ax = plt.subplots(figsize=(7, 4))
        x = np.arange(nj + 1)
        width = 0.8 / (1 + len(baseline))
        ax.bar(x, vals, width, label=method_name)
        for bi, (label, base) in enumerate(baseline):
            bvals = [base.getJointMeanError(j) if kind == "meanerror"
                     else base.getJointMaxError(j) for j in range(nj)]
            bvals.append(base.getMeanError() if kind == "meanerror" else base.getMaxError())
            ax.bar(x + (bi + 1) * width, bvals, width, label=label)
        # group centres: matplotlib centres each bar at its x (the
        # reference's x+0.4 assumed matplotlib<2 edge-aligned bars)
        ax.set_xticks(x + width * len(baseline) / 2.0)
        ax.set_xticklabels(names, rotation=90, fontsize=7)
        ax.set_ylabel("Error / mm")
        if ev.dolegend:
            ax.legend()
        p = os.path.join(sub, f"{name}_{kind}.pdf")
        fig.savefig(p, bbox_inches="tight")
        plt.close(fig)
        out.append(p)
    return out


def _draw_skeleton(ax, joints2d, connections, annoscale=1.0, gt_style=False):
    colors = _finger_colors(len(connections))
    for ci, (a, b) in enumerate(connections):
        c = (0.5, 0.5, 0.5) if gt_style else colors[ci]
        ax.plot([joints2d[a, 0], joints2d[b, 0]], [joints2d[a, 1], joints2d[b, 1]],
                c=c, linewidth=2.0 * annoscale, alpha=0.6 if gt_style else 1.0)
    ax.scatter(joints2d[:, 0], joints2d[:, 1], c="0.7" if gt_style else "w",
               s=8 * annoscale, zorder=3)


def plot_result(ev, dpt, gtcrop, joint_2d, name: Optional[str] = None, showGT=True):
    """The 2D skeleton overlay on a depth patch: written to
    <subfolder>/<name>.png (returns the path), or the figure when ``name``
    is None (handpose_evaluation.py:348-433)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(np.asarray(dpt), cmap="gray", interpolation="nearest")
    if showGT and gtcrop is not None:
        _draw_skeleton(ax, np.asarray(gtcrop), ev.joint_connections, gt_style=True)
    _draw_skeleton(ax, np.asarray(joint_2d), ev.joint_connections)
    ax.axis("off")
    if name is not None:
        p = os.path.join(ev.subfolder, f"{name}.png")
        _ensure_dir(p)
        fig.savefig(p, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return p
    return fig


def plot_result_3d(ev, joints3d, pcl: Optional[np.ndarray] = None,
                   name: Optional[str] = None):
    """A 3D stick figure (and the point cloud ``pcl``), the matplotlib
    counterpart of the reference's VTK render (handpose_evaluation.py:
    488-618): <subfolder>/<name>_3d.png, or the figure."""
    plt = pyplot()
    joints3d = np.asarray(joints3d)
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    if pcl is not None and len(pcl):
        sub = pcl[:: max(1, len(pcl) // 5000)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=1, c=sub[:, 2], alpha=0.3)
    colors = _finger_colors(len(ev.joint_connections))
    for ci, (a, b) in enumerate(ev.joint_connections):
        ax.plot(joints3d[[a, b], 0], joints3d[[a, b], 1], joints3d[[a, b], 2],
                c=colors[ci], linewidth=2)
    ax.scatter(joints3d[:, 0], joints3d[:, 1], joints3d[:, 2], c="k", s=10)
    if name is not None:
        p = os.path.join(ev.subfolder, f"{name}_3d.png")
        _ensure_dir(p)
        fig.savefig(p, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return p
    return fig
