"""Randomized differential sweeps of the port, against independent numpy
twins.

The port's own copies of the repo-root probes' scene generators and twins
(prof_crop_sweep.py, prof_detect_sweep.py, prof_aug_sweep.py,
prof_prior_sweep.py; those import jax and run their sweeps at import):

- the crop scenes (``random_depth``, ``random_com``): noise, hand-like
  blobs, constant planes and speckle; CoMs inside, at or over a border,
  far outside, at z = 0 or pathologically close, random cubes;
- the detection scenes (``random_scene``, ``random_seed_com``): blobs
  straddling the area gate, corner-touching squares, border-clipped blobs,
  planes, speckle, empty frames;
- the augmentation twin (``twin_augment_one``): the reference's augmentCrop
  per sample in float32 and the device's op order;
- the prior twin (``twin_sample``): the reference's sampleRandomPoses loop
  per pose.

Every generator takes an explicit ``np.random.Generator`` where the probes
read a module-global one; from the same seed they draw the same scenes.
The crop and detection oracles are ``data/detector_np.py``'s
``HandCropper``.  The ``check_*`` functions compare a port result with the
twins at the probes' tolerances and return the disagreements, one line
each; tests/test_torch_sweeps.py runs them on the CPU and chip_smoke.py
(phase 42) on the card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from deepprior_tpu_torch.ops.augment import NV_VAL

# ---------------------------------------------------------------------------
# crop scenes (prof_crop_sweep.py:51-99)
# ---------------------------------------------------------------------------
N_DEPTH_KINDS = 4
N_COM_KINDS = 4


def random_depth(rng, cam, kind):
    h, w = cam.height, cam.width
    if kind == 0:  # uniform noise across the full working range
        return rng.uniform(300.0, 2500.0, (h, w)).astype(np.float32)
    if kind == 1:  # blob on noise floor (hand-like)
        d = np.full((h, w), 2000.0, np.float32)
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        yy, xx = np.mgrid[0:h, 0:w]
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        z = rng.uniform(450.0, 900.0)
        mask = r2 < rng.integers(400, 10000)
        d[mask] = z + rng.uniform(-40, 40, int(mask.sum()))
        return d
    if kind == 2:  # constant plane
        return np.full((h, w), rng.uniform(400.0, 1500.0), np.float32)
    # zeros with sparse speckle (invalid-heavy frame)
    d = np.zeros((h, w), np.float32)
    mask = rng.random((h, w)) < 0.01
    d[mask] = rng.uniform(300.0, 2000.0, int(mask.sum()))
    return d.astype(np.float32)


def random_com(rng, cam, kind):
    h, w = cam.height, cam.width
    z = rng.uniform(350.0, 1400.0)
    if kind == 0:  # well inside
        return np.array(
            [rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h, 0.8 * h), z], np.float32)
    if kind == 1:  # at/over a border
        edge = rng.integers(0, 4)
        u = [rng.uniform(-30, 10), rng.uniform(w - 10, w + 30),
             rng.uniform(0, w), rng.uniform(0, w)][edge]
        v = [rng.uniform(0, h), rng.uniform(0, h),
             rng.uniform(-30, 10), rng.uniform(h - 10, h + 30)][edge]
        return np.array([u, v, z], np.float32)
    if kind == 2:  # far outside
        return np.array([rng.uniform(-500, -50), rng.uniform(-500, -50), z], np.float32)
    # degenerate / extreme z: exactly 0 takes the defined centre-crop
    # fallback; 30-60 mm is a pathologically close hand (z in (0, ~25) is
    # out of contract: the cube projects to millions of pixels)
    z = 0.0 if rng.random() < 0.5 else rng.uniform(30.0, 60.0)
    return np.array([rng.uniform(0, w), rng.uniform(0, h), z], np.float32)


def crop_scenes(rng, cam, n):
    """(depths (n, H, W), CoMs (n, 3), cubes (n, 3)) in the crop probe's
    draw order."""
    dpts = np.stack([random_depth(rng, cam, int(rng.integers(0, N_DEPTH_KINDS)))
                     for _ in range(n)])
    coms = np.stack([random_com(rng, cam, int(rng.integers(0, N_COM_KINDS)))
                     for _ in range(n)])
    cubes = rng.uniform(100.0, 400.0, (n, 1)).repeat(3, 1).astype(np.float32)
    return dpts, coms, cubes


def check_crops(cam, dpt_c, coms, cubes, crops: Dict[str, np.ndarray], m=None) -> List[str]:
    """Each sample's mm crops against ``HandCropper.crop_area_3d`` on its
    clamped frame ``dpt_c``: 'nearest' bit for bit, 'linear' within rtol
    3e-7 / atol 1e-3 (taps and weights exact, the blend within 2 ulp),
    'nd_bilinear' within rtol 1e-5 / atol 1e-3 (a weighted blend); ``m``
    (the crop transforms) within rtol 1e-6 / atol 1e-4."""
    from deepprior_tpu_torch.data.detector_np import HandCropper

    tol = {"linear": dict(rtol=3e-7, atol=1e-3), "nd_bilinear": dict(rtol=1e-5, atol=1e-3)}
    bad = []
    for i in range(len(coms)):
        tag = f"cam={cam.width}x{cam.height} cube={cubes[i, 0]:.0f} com={coms[i]}"
        for mode, got in crops.items():
            want, want_m, _ = HandCropper(dpt_c[i].copy(), cam, resize_method=mode).crop_area_3d(
                com=coms[i].copy(), size=tuple(cubes[i]))
            if mode == "nearest":
                ok = np.array_equal(got[i], want)
            else:
                ok = np.allclose(got[i], want, **tol[mode])
            if not ok:
                err = float(np.abs(got[i] - want).max())
                bad.append(f"{mode.upper()}!=ORACLE {tag} "
                           f"({int((got[i] != want).sum())} px, max {err:.3e})")
            if mode == "nearest" and m is not None and not np.allclose(
                    m[i], want_m, rtol=1e-6, atol=1e-4):
                bad.append(f"M mismatch {tag}")
    return bad


# ---------------------------------------------------------------------------
# detection scenes (prof_detect_sweep.py:58-147)
# ---------------------------------------------------------------------------
N_SCENE_KINDS = 7
N_SEED_KINDS = 4


def _disk(rng, d, cy, cx, r, z):
    h, w = d.shape
    yy, xx = np.mgrid[0:h, 0:w]
    m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    if m.any():
        d[m] = z + rng.uniform(-5.0, 5.0, int(m.sum()))
    return m


def random_scene(rng, cam, kind):
    h, w = cam.height, cam.width
    if kind == 0:  # k blobs, areas straddling the 200 px gate
        d = np.zeros((h, w), np.float32)
        for _ in range(int(rng.integers(1, 6))):
            _disk(rng, d, rng.integers(20, h - 20), rng.integers(20, w - 20),
                  rng.uniform(6.0, 14.0), rng.uniform(300.0, 1400.0))
        return d
    if kind == 1:  # hand blob on a far plane + nearer sub-gate specks
        d = np.full((h, w), 1800.0, np.float32)
        _disk(rng, d, rng.integers(60, h - 60), rng.integers(60, w - 60),
              rng.uniform(20.0, 40.0), rng.uniform(600.0, 900.0))
        for _ in range(int(rng.integers(1, 4))):
            _disk(rng, d, rng.integers(5, h - 5), rng.integers(5, w - 5),
                  rng.uniform(1.0, 5.0), rng.uniform(300.0, 550.0))
        return d
    if kind == 2:  # border-clipped blob (centre at/over an edge)
        d = np.zeros((h, w), np.float32)
        edge = int(rng.integers(0, 4))
        cy = [rng.integers(-10, 10), rng.integers(h - 10, h + 10),
              rng.integers(0, h), rng.integers(0, h)][edge]
        cx = [rng.integers(0, w), rng.integers(0, w),
              rng.integers(-10, 10), rng.integers(w - 10, w + 10)][edge]
        _disk(rng, d, cy, cx, rng.uniform(12.0, 30.0), rng.uniform(350.0, 1200.0))
        return d
    if kind == 3:  # two squares touching only at a corner, unequal areas
        d = np.zeros((h, w), np.float32)
        s1, s2 = 15, 17  # 225 / 289 px: both above the 200 gate, no tie
        y0 = int(rng.integers(10, h - s1 - s2 - 10))
        x0 = int(rng.integers(10, w - s1 - s2 - 10))
        z = rng.uniform(400.0, 1000.0)
        d[y0:y0 + s1, x0:x0 + s1] = z + rng.uniform(-2, 2, (s1, s1))
        d[y0 + s1:y0 + s1 + s2, x0 + s1:x0 + s1 + s2] = z + rng.uniform(-2, 2, (s2, s2))
        return d
    if kind == 4:  # constant plane (degenerate dz)
        return np.full((h, w), rng.uniform(400.0, 1400.0), np.float32)
    if kind == 5:  # speckle only: nothing exceeds any gate
        d = np.zeros((h, w), np.float32)
        m = rng.random((h, w)) < 0.005
        d[m] = rng.uniform(300.0, 1400.0, int(m.sum()))
        return d.astype(np.float32)
    return np.zeros((h, w), np.float32)  # kind 6: all-invalid frame


def random_seed_com(rng, cam, kind):
    h, w = cam.height, cam.width
    z = rng.uniform(350.0, 1300.0)
    if kind == 0:  # inside
        return np.array([rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h, 0.8 * h), z],
                        np.float32)
    if kind == 1:  # at/over a border
        return np.array([rng.uniform(-20.0, 20.0), rng.uniform(h - 20.0, h + 20.0), z],
                        np.float32)
    if kind == 2:  # far outside (bbox fully off-image -> empty crop)
        return np.array([rng.uniform(-400.0, -80.0), rng.uniform(-400.0, -80.0), z],
                        np.float32)
    return np.array([rng.uniform(0, w), rng.uniform(0, h), 0.0],
                    np.float32)  # z=0: comToBounds centre fallback


def detect_scenes(rng, cam, n):
    """(raw depths (n, H, W), seed CoMs (n, 3), cubes (n, 3)) in the
    detection probe's draw order."""
    raws = np.stack([random_scene(rng, cam, int(rng.integers(0, N_SCENE_KINDS)))
                     for _ in range(n)])
    seeds = np.stack([random_seed_com(rng, cam, int(rng.integers(0, N_SEED_KINDS)))
                      for _ in range(n)])
    cubes = rng.uniform(150.0, 350.0, (n, 1)).repeat(3, 1).astype(np.float32)
    return raws, seeds, cubes


# (num_slices, min_area) of the two detector groups
DETECT_GROUPS = ((20, 200), (10, 50))
REFINE_ITERS = (2, 5)


def run_detection(raws, seeds, cubes, cam, device) -> Dict[str, np.ndarray]:
    """The port's detection layer on ``device`` over a batch of scenes, as
    the probe calls it: calculate_com and refine_com_iterative on the
    frames clamped by ``HandCropper`` with its depth limits, detect on the
    raw frames in both parameter groups."""
    import torch

    from deepprior_tpu_torch.data.detector_np import HandCropper
    from deepprior_tpu_torch.ops.com import calculate_com, detect, refine_com_iterative

    croppers = [HandCropper(r, cam) for r in raws]

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    dpt_c = put(np.stack([hc.dpt for hc in croppers]))
    min_d = put([hc.min_depth for hc in croppers])
    max_d = put([hc.max_depth for hc in croppers])
    raw_t, seed_t, cube_t = put(raws), put(seeds), put(cubes)
    out = {"calculate_com": calculate_com(dpt_c, min_d, max_d)}
    for it in REFINE_ITERS:
        out[f"refine{it}"] = refine_com_iterative(dpt_c, seed_t, cube_t, cam.fx, cam.fy,
                                                  num_iter=it, min_depth=min_d,
                                                  max_depth=max_d)
    for ns, ma in DETECT_GROUPS:
        out[f"detect{ns}_{ma}"] = detect(raw_t, cube_t, cam.fx, cam.fy, num_slices=ns,
                                         min_area=ma)
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_detection(cam, raws, seeds, cubes, got: Dict[str, np.ndarray]) -> List[str]:
    """``run_detection``'s results against the host ``HandCropper``:
    calculate_com within rtol 1e-4 / atol 0.1, refinement and detection
    within rtol 1e-3 / atol 0.5 (tests/test_com.py's bounds)."""
    from deepprior_tpu_torch.data.detector_np import HandCropper

    bad = []
    for i in range(len(raws)):
        hc = HandCropper(raws[i], cam)
        tag = f"cam={cam.width}x{cam.height} cube={cubes[i, 0]:.0f} seed={seeds[i]}"
        want = hc.calculate_com()
        if not np.allclose(got["calculate_com"][i], want, rtol=1e-4, atol=0.1):
            bad.append(f"CALC_COM {tag}: {got['calculate_com'][i]} != {want}")
        for it in REFINE_ITERS:
            want = hc.refine_com_iterative(seeds[i].copy(), it, tuple(cubes[i]))
            if not np.allclose(got[f"refine{it}"][i], want, rtol=1e-3, atol=0.5):
                bad.append(f"REFINE(it={it}) {tag}: {got[f'refine{it}'][i]} != {want}")
        for ns, ma in DETECT_GROUPS:
            want = hc.detect(size=tuple(cubes[i]), num_slices=ns, min_area=ma)
            g = got[f"detect{ns}_{ma}"][i]
            if not np.allclose(g, want, rtol=1e-3, atol=0.5):
                bad.append(f"DETECT(ns={ns},ma={ma}) {tag}: {g} != {want}")
    return bad


# ---------------------------------------------------------------------------
# the augmentation twin (prof_aug_sweep.py:39-224), per sample, float32
# ---------------------------------------------------------------------------
AUG_MODE_SETS = [("com", "rot", "none"), ("com", "rot", "sc", "none"),
                 ("sc",), ("rot",), ("com",)]


def inv3x3_np(m):
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = np.float32(1.0) / det
    adj = np.array(
        [
            [co_a, -(b * i - c * h), b * f - c * e],
            [co_b, a * i - c * g, -(a * f - c * d)],
            [co_c, -(a * h - b * g), a * e - b * d],
        ],
        np.float32,
    )
    return adj * inv_det


def matmul3_np(x, y):
    """3x3 float32 product with explicit left-to-right accumulation."""
    out = np.zeros((3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            out[i, j] = (x[i, 0] * y[0, j] + x[i, 1] * y[1, j]) + x[i, 2] * y[2, j]
    return out


def com_to_bounds_np(com, cube, fx, fy):
    """ops/crop.py::com_to_bounds twin (floats, float32 op order)."""
    u, v, d = com
    sx, sy, sz = cube
    f32 = np.float32
    half = f32(0.5)
    xs = np.floor((u * d / f32(fx) - sx / f32(2.0)) / d * f32(fx) + half)
    xe = np.floor((u * d / f32(fx) + sx / f32(2.0)) / d * f32(fx) + half)
    ys = np.floor((v * d / f32(fy) - sy / f32(2.0)) / d * f32(fy) + half)
    ye = np.floor((v * d / f32(fy) + sy / f32(2.0)) / d * f32(fy) + half)
    return xs, xe, ys, ye, d - sz / f32(2.0), d + sz / f32(2.0)


def crop_transform_np(com, cube, fx, fy, dsize=(128, 128)):
    """ops/crop.py::crop_transform twin."""
    xs, xe, ys, ye, _, _ = com_to_bounds_np(com, cube, fx, fy)
    dw, dh = dsize
    wb, hb = xe - xs, ye - ys
    f32 = np.float32
    if wb > hb:
        scale = f32(dw) / wb
        sz_w, sz_h = f32(dw), np.floor(hb * f32(dw) / wb)
    else:
        scale = f32(dh) / hb
        sz_w, sz_h = np.floor(wb * f32(dh) / hb), f32(dh)
    off_x = np.floor(f32(dw) / f32(2.0) - sz_w / f32(2.0))
    off_y = np.floor(f32(dh) / f32(2.0) - sz_h / f32(2.0))
    return np.array(
        [
            [scale, 0.0, -scale * xs + off_x],
            [0.0, scale, -scale * ys + off_y],
            [0.0, 0.0, 1.0],
        ],
        np.float32,
    )


def rotmat2d_np(center, angle_deg):
    a = np.deg2rad(np.float32(angle_deg)).astype(np.float32)
    c, s = np.cos(a), np.sin(a)
    cx, cy = np.float32(center[0]), np.float32(center[1])
    return np.array(
        [
            [c, -s, cx - c * cx + s * cy],
            [s, c, cy - s * cx - c * cy],
            [0.0, 0.0, 1.0],
        ],
        np.float32,
    )


def warp_nearest_np(img, m_fwd, border=0.0, nv_val=NV_VAL):
    """ops/crop.py::warp_patch twin (nearest, NV mask)."""
    h, w = img.shape
    m_inv = inv3x3_np(m_fwd)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    sx = m_inv[0, 0] * u + m_inv[0, 1] * v + m_inv[0, 2]
    sy = m_inv[1, 0] * u + m_inv[1, 1] * v + m_inv[1, 2]
    sz = m_inv[2, 0] * u + m_inv[2, 1] * v + m_inv[2, 2]
    x = sx / sz
    y = sy / sz
    p = np.floor(x + np.float32(0.5))
    q = np.floor(y + np.float32(0.5))
    in_img = (p >= 0) & (p < w) & (q >= 0) & (q < h)
    pc = np.clip(p.astype(np.int64), 0, w - 1)
    qc = np.clip(q.astype(np.int64), 0, h - 1)
    out = img[qc, pc]
    out = np.where(in_img, out, np.float32(border)).astype(np.float32)
    out = np.where(np.isclose(out, np.float32(nv_val)), np.float32(border), out)
    return out


def twin_augment_one(cam, crop_norm, gt3d, com, cube, m, mode, off, rot, sc,
                     norm_zero_one=False):
    """The whole augmentation of one sample (reference nettrainer.py:919-997
    in ops/augment.py's formulation, float32 op order).  Returns (crop,
    labels normalized, new com, new cube, M, the forward affine)."""
    f32 = np.float32
    crop_norm = crop_norm.astype(f32)
    com = com.astype(f32)
    cube = cube.astype(f32)
    m = m.astype(f32)
    h, w = crop_norm.shape

    off = off.astype(f32) if mode == "com" else np.zeros(3, f32)
    rot = np.mod(f32(rot) if mode == "rot" else f32(0.0), f32(360.0))
    sc = f32(sc) if mode == "sc" else f32(1.0)

    com_z, cube_z = com[2], cube[2]
    if norm_zero_one:
        img = crop_norm * cube_z + (com_z - cube_z / f32(2.0))
    else:
        img = crop_norm * (cube_z / f32(2.0)) + com_z
    premax = img.max()

    com3d = cam.img_to_3d_np(com[None])[0].astype(f32)
    new_com3d = (com3d + off).astype(f32)
    new_com_c = cam.three_d_to_img_np(new_com3d[None])[0].astype(f32)
    new_com = new_com_c if mode == "com" else com
    new_cube = (cube * sc).astype(f32) if mode == "sc" else cube

    if mode in ("com", "sc"):
        m_new = crop_transform_np(new_com, new_cube, cam.fx, cam.fy, (w, h))
        a_fwd = matmul3_np(m_new, inv3x3_np(m))
        m_out = m_new
    elif mode == "rot":
        a_fwd = rotmat2d_np((w // 2, h // 2), rot)
        m_out = m
    else:
        a_fwd = np.eye(3, dtype=f32)
        m_out = m

    warped = warp_nearest_np(img, a_fwd)

    if mode in ("com", "sc"):
        # re-threshold with the original cube about the new com (scaleHand
        # passes size=cube, handdetector.py:771-773)
        _, _, _, _, zs, ze = com_to_bounds_np(new_com, cube, cam.fx, cam.fy)
        warped = np.where((warped < zs) & (warped != 0.0), zs, warped)
        warped = np.where(warped > ze, f32(0.0), warped)

    if mode == "com":
        labels = gt3d + (com3d - new_com3d)[None, :]
    elif mode == "rot":
        joint2d = cam.three_d_to_img_np((gt3d + com3d[None, :]).astype(f32))
        a = np.deg2rad(rot).astype(f32)
        c, s = np.cos(a), np.sin(a)
        dx = joint2d[:, 0] - com[0]
        dy = joint2d[:, 1] - com[1]
        r2d = np.stack([dx * c - dy * s + com[0], dx * s + dy * c + com[1], joint2d[:, 2]],
                       axis=-1).astype(f32)
        labels = cam.img_to_3d_np(r2d).astype(f32) - com3d[None, :]
    else:
        labels = gt3d.astype(f32)
    labels_norm = labels / (new_cube[2] / f32(2.0))

    # renormalize (nettrainer.py:985-997)
    ncz, ncu = new_com[2], new_cube[2]
    zend = ncz + ncu / f32(2.0)
    zstart = ncz - ncu / f32(2.0)
    d = warped
    d = np.where(d == premax, zend, d)
    d = np.where(d == 0.0, zend, d)
    d = np.clip(d, zstart, zend)
    if norm_zero_one:
        out = (d - zstart) / ncu
    else:
        out = (d - ncz) / (ncu / f32(2.0))
    return out.astype(f32), labels_norm.astype(f32), new_com, new_cube, m_out, a_fwd


def flips_excused(a_fwd, bad):
    """True iff every mismatching pixel is a rounding-boundary flip: its
    inverse-warp sampling coordinate lies within 1e-4 of a half-integer,
    where 1-2 ulp between two float paths (libm trig for 'rot', the
    cancelling 3x3 composition for 'com'/'sc') pick the neighbouring
    source pixel; at most 2% of the pixels."""
    f32 = np.float32
    if bad.mean() > 0.02:
        return False
    m_inv = inv3x3_np(a_fwd)
    qi, pi = np.nonzero(bad)
    u = pi.astype(f32)
    v = qi.astype(f32)
    den = m_inv[2, 0] * u + m_inv[2, 1] * v + m_inv[2, 2]
    x = (m_inv[0, 0] * u + m_inv[0, 1] * v + m_inv[0, 2]) / den
    y = (m_inv[1, 0] * u + m_inv[1, 1] * v + m_inv[1, 2]) / den
    eps = 1e-4
    near_x = np.abs((x + 0.5) - np.round(x + 0.5)) < eps
    near_y = np.abs((y + 0.5) - np.round(y + 0.5)) < eps
    return bool(np.all(near_x | near_y))


def augment_inputs(rng, cam, b, zero_one):
    """A batch of ``b`` synthetic training samples as the augmentation
    probe makes them: random cubes, ``make_frame`` crops normalized the way
    TrainData does.  Returns (crops_norm, gt3d, com, cube, m) as numpy."""
    from deepprior_tpu_torch.data.synthetic import make_frame

    cube = rng.uniform(180.0, 350.0, (b, 1)).repeat(3, 1).astype(np.float32)
    frames = [make_frame(cam, rng, num_joints=14, cube=tuple(cube[j])) for j in range(b)]
    crops = np.stack([f.dpt for f in frames])
    gt3d = np.stack([f.gt3Dcrop for f in frames]).astype(np.float32)
    com = np.stack([f.com for f in frames]).astype(np.float32)
    m = np.stack([f.T for f in frames]).astype(np.float32)
    com_z = com[:, 2][:, None, None]
    cz = cube[:, 2][:, None, None]
    crops = np.where(crops == 0.0, com_z + cz / 2.0, crops)
    crops = np.clip(crops, com_z - cz / 2.0, com_z + cz / 2.0)
    if zero_one:
        crops_n = ((crops - (com_z - cz / 2.0)) / cz).astype(np.float32)
    else:
        crops_n = ((crops - com_z) / (cz / 2.0)).astype(np.float32)
    return crops_n, gt3d, com, cube, m


def check_augment(cam, inputs, params, got, aug_modes: Sequence[str], zero_one,
                  tag="") -> List[str]:
    """``augment_batch``'s (out, labels, new com, new cube, M) against the
    twin on the same drawn ``params`` (mode_idx, off, rot, sc), all numpy:
    com and cube and M bit for bit, labels bit for bit except 'rot' (within
    1e-5 normalized: cos/sin of two libms), images bit for bit except
    rounding-boundary flips (``flips_excused``; none in mode 'none')."""
    crops_n, gt3d, com, cube, m = inputs
    mode_i, off, rot, sc = params
    out, lab, ncom, ncube, mout = got
    bad = []
    for i in range(len(crops_n)):
        mode = aug_modes[int(mode_i[i])]
        t_out, t_lab, t_ncom, t_ncube, t_m, t_afwd = twin_augment_one(
            cam, crops_n[i], gt3d[i], com[i], cube[i], m[i], mode, off[i], rot[i], sc[i],
            norm_zero_one=zero_one)
        where = f"{tag} i={i} mode={mode} cam={cam.width}x{cam.height}"
        if not (np.array_equal(t_ncom, ncom[i]) and np.array_equal(t_ncube, ncube[i])):
            bad.append(f"COM/CUBE mismatch {where}")
            continue
        if not np.array_equal(t_m, mout[i]):
            bad.append(f"M mismatch {where}")
            continue
        if mode == "rot":
            lab_ok = np.allclose(t_lab, lab[i], rtol=0.0, atol=1e-5)
        else:
            lab_ok = np.array_equal(t_lab, lab[i])
        if not lab_ok:
            bad.append(f"LABEL mismatch {where} (max {np.abs(t_lab - lab[i]).max():.3e})")
            continue
        if not np.array_equal(t_out, out[i]):
            diff = t_out != out[i]
            if mode == "none" or not flips_excused(t_afwd, diff):
                bad.append(f"IMAGE mismatch {where} ({int(diff.sum())} px, "
                           f"max {np.abs(t_out - out[i]).max():.3e})")
    return bad


# ---------------------------------------------------------------------------
# the prior twin (prof_prior_sweep.py:45-222), per pose
# ---------------------------------------------------------------------------
PRIOR_MODE_SETS = [
    ("com", "rot", "none"),                  # the flagship recipe
    ("com", "rot", "sc", "none"),
    ("rot+com", "none"),
    ("com+rot",),
    ("rot+com+sc",),
    ("rot+sc+com", "com", "sc"),
    ("none",),                               # the reference's fast path
    ("sc",),
]


def joint_img_to_3d(cam, s):
    """importers.py:80-91 (ICVL) / :756-766 (flip-y)."""
    s = np.asarray(s, np.float32)
    ret = np.zeros(3, np.float32)
    ret[0] = (s[0] - cam.ux) * s[2] / cam.fx
    if cam.flip_y:
        ret[1] = (cam.uy - s[1]) * s[2] / cam.fy
    else:
        ret[1] = (s[1] - cam.uy) * s[2] / cam.fy
    ret[2] = s[2]
    return ret


def joint_3d_to_img(cam, s):
    """importers.py:104-119 / :779-793 with the z == 0 case."""
    s = np.asarray(s, np.float32)
    ret = np.zeros(3, np.float32)
    if s[2] == 0.0:
        ret[0] = cam.ux
        ret[1] = cam.uy
        return ret
    ret[0] = s[0] / s[2] * cam.fx + cam.ux
    if cam.flip_y:
        ret[1] = cam.uy - s[1] / s[2] * cam.fy
    else:
        ret[1] = s[1] / s[2] * cam.fy + cam.uy
    ret[2] = s[2]
    return ret


def joints_3d_to_img(cam, pts):
    return np.stack([joint_3d_to_img(cam, p) for p in pts])


def joints_img_to_3d(cam, pts):
    return np.stack([joint_img_to_3d(cam, p) for p in pts])


def rotate_point_2d(p1, center, angle):
    """transformations.py:71-88."""
    alpha = angle * np.pi / 180.0
    pp = np.asarray(p1, np.float32).copy()
    pp[0:2] -= center[0:2]
    pr = np.zeros_like(pp)
    pr[0] = pp[0] * np.cos(alpha) - pp[1] * np.sin(alpha)
    pr[1] = pp[0] * np.sin(alpha) + pp[1] * np.cos(alpha)
    pr[2] = pp[2]
    pr[0:2] += center[0:2]
    return pr


def rotate_points_2d(pts, center, angle):
    return np.stack([rotate_point_2d(p, center, angle) for p in pts])


def rotate_point_3d(p1, center, ax, ay, az):
    """transformations.py:122-139: euler2mat 'rxyz' = Rx(ax) Ry(ay) Rz(az)
    on column vectors."""
    rx, ry, rz = np.deg2rad([ax, ay, az])

    def Rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)

    def Ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)

    def Rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)

    r = np.dot(np.dot(Rx(rx), Ry(ry)), Rz(rz))
    pp = np.asarray(p1, np.float64) - center
    return (np.dot(r, pp) + center).astype(np.float32)


def rotate_points_3d(pts, center, ax, ay, az):
    return np.stack([rotate_point_3d(p, center, ax, ay, az) for p in pts])


def twin_sample(cam, base_poses, base_com_img, base_cube, aug_modes,
                modes, ridxs, off, sc, rot, rot3d):
    """The reference loop (handdetector.py:850-909) per pose, on the drawn
    parameter arrays.  ``base_com_img`` is in image coordinates and goes to
    3D per pose through the scalar projection first."""
    num = len(modes)
    j = base_poses.shape[1]
    new_poses = np.zeros((num, j, 3), np.float32)
    new_com = np.zeros((num, 3), np.float32)
    new_cube = np.zeros((num, 3), np.float32)
    if tuple(aug_modes) == ("none",):
        nb = base_poses.shape[0]
        normalized = (base_poses.astype(np.float32)
                      / (base_cube[:, 2].astype(np.float32) / 2.0)[:, None, None])
        return normalized.reshape(nb, j * 3), None, None
    for i in range(num):
        mode = aug_modes[modes[i]]
        ridx = ridxs[i]
        cube = base_cube[ridx].astype(np.float32)
        com3d = joint_img_to_3d(cam, base_com_img[ridx])
        pose = base_poses[ridx].astype(np.float32)
        if mode == "com":
            new_com[i] = com3d + off[i]
            new_cube[i] = cube
            new_poses[i] = (pose + com3d - new_com[i]) / (new_cube[i][2] / 2.0)
        elif mode == "rot":
            new_com[i] = com3d
            new_cube[i] = cube
            if not rot3d:
                joint_2d = joints_3d_to_img(cam, pose + new_com[i])
                data_2d = rotate_points_2d(joint_2d, joint_3d_to_img(cam, com3d)[0:2],
                                           rot[i, 0])
                new_poses[i] = ((joints_img_to_3d(cam, data_2d) - new_com[i])
                                / (new_cube[i][2] / 2.0))
            else:
                new_poses[i] = ((rotate_points_3d(pose + new_com[i], new_com[i], rot[i, 0],
                                                  rot[i, 1], rot[i, 2]) - new_com[i])
                                / (new_cube[i][2] / 2.0))
        elif mode == "sc":
            new_com[i] = com3d
            new_cube[i] = cube * sc[i]
            new_poses[i] = pose / (new_cube[i][2] / 2.0)
        elif mode == "none":
            new_com[i] = com3d
            new_cube[i] = cube
            new_poses[i] = pose / (new_cube[i][2] / 2.0)
        else:
            ops = set(mode.split("+"))
            new_com[i] = com3d + off[i]
            new_cube[i] = cube
            pose = pose + com3d - new_com[i]
            if "sc" in ops:
                pose = pose * sc[i]  # the quirk: the cube is not scaled (:892-894)
            if not rot3d:
                # the quirk: rotate about the new com's projection, re-centre
                # about the old com3D (:884-887)
                joint_2d = joints_3d_to_img(cam, pose + com3d)
                data_2d = rotate_points_2d(joint_2d, joint_3d_to_img(cam, new_com[i])[0:2],
                                           rot[i, 0])
                new_poses[i] = ((joints_img_to_3d(cam, data_2d) - com3d)
                                / (new_cube[i][2] / 2.0))
            else:
                new_poses[i] = ((rotate_points_3d(pose + new_com[i], new_com[i], rot[i, 0],
                                                  rot[i, 1], rot[i, 2]) - new_com[i])
                                / (new_cube[i][2] / 2.0))
    return new_poses.reshape(num, j * 3), new_com, new_cube


class FixedDraws:
    """An rng that hands ``sample_random_poses`` pre-drawn arrays in its
    draw order (modes, ridx, off, sc, rot), by call sequence."""

    def __init__(self, modes, ridxs, off_raw, sc_raw, rot):
        self.modes, self.ridxs, self.off_raw, self.sc_raw, self.rot = (
            modes, ridxs, off_raw, sc_raw, rot)
        self._int_calls = 0
        self._norm_calls = 0

    def integers(self, lo, hi, size):
        self._int_calls += 1
        return self.modes if self._int_calls == 1 else self.ridxs

    def standard_normal(self, size=None):
        self._norm_calls += 1
        return self.off_raw if self._norm_calls == 1 else self.sc_raw

    def uniform(self, lo, hi, size):
        return self.rot


def prior_sweep(cameras: Sequence, n_scenes: int, sample_fn, poses_per_set: int = 64,
                seed: int = 20260820):
    """The prior probe's sweep: ``n_scenes`` scenes over ``cameras`` in turn,
    each through every mode set of ``PRIOR_MODE_SETS`` with 2D and 3D
    rotation; ``sample_fn`` (the port's ``sample_random_poses``) against
    ``twin_sample`` on the same drawn parameters.  Returns (values checked,
    the worst relative error, max(|twin|, 1) in the denominator)."""
    rng = np.random.default_rng(seed)
    n_checked, worst = 0, 0.0
    for si in range(n_scenes):
        cam = cameras[si % len(cameras)]
        n_base = int(rng.integers(3, 12))
        j = int(rng.integers(5, 22))
        base_poses = rng.normal(0.0, 60.0, (n_base, j, 3))
        base_com = np.stack([rng.uniform(20, cam.width - 20, n_base),
                             rng.uniform(20, cam.height - 20, n_base),
                             rng.uniform(250, 1400, n_base)], axis=1)
        base_cube = rng.uniform(150, 400, (n_base, 1)) * np.ones((1, 3))
        for mset in PRIOR_MODE_SETS:
            for rot3d in (False, True):
                prng = np.random.default_rng(1000 * si + len(mset))
                modes = prng.integers(0, len(mset), poses_per_set)
                ridxs = prng.integers(0, n_base, poses_per_set)
                off_raw = prng.standard_normal((poses_per_set, 3))
                sc_raw = prng.standard_normal(poses_per_set)
                rot = prng.uniform(-180.0, 180.0, (poses_per_set, 3))
                got = sample_fn(cam, FixedDraws(modes, ridxs, off_raw, sc_raw, rot),
                                base_poses, base_com, base_cube, poses_per_set,
                                aug_modes=mset, rot3d=rot3d)
                want, _, _ = twin_sample(cam, base_poses, base_com, base_cube, mset, modes,
                                         ridxs, off_raw * 5.0, np.abs(sc_raw * 0.02 + 1.0),
                                         rot, rot3d)
                rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))
                worst = max(worst, rel)
                n_checked += got.size
    return n_checked, worst
