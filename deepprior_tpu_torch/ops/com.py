"""Centre-of-mass hand localization on batched depth frames, plain PyTorch.

Counterpart of deepprior_tpu/ops/com.py (reference handdetector.py:91-108,
546-632).  The CoM is a masked moment over the full frame: the bbox crop
becomes part of the mask, so every step is a batched tensor op.  The JAX
control flow translates as follows: ``fori_loop`` is a Python loop,
``while_loop`` a loop over a fixpoint test (one host sync per iteration),
``vmap`` a leading batch axis, ``cummin(reverse=True)`` flip/cummin/flip,
``.at[].add`` ``scatter_add_`` and ``.at[].max`` ``scatter_reduce_('amax')``.
``argmin``/``argmax`` take the first index on a tie, as JAX does.

``label_components`` has two routes with one contract.  On a CPU tensor it
is the plain ``label_scan``, the JAX package's ``while_loop`` of segmented
min-scans, with one host sync per pass.  On a CUDA tensor it is the
hand-written union-find kernel K8 (csrc/label.cu, ops/hopper_label.py):
three launches and no host sync, so the slice scan of ``detect`` reads
nothing back to the host until its CoM.

Sums of pixel coordinates over many pixels can pass 2^24 and then depend
on the reduction order in float32, as the JAX package's do; every division
is IEEE division of two tensors (ops/crop.py's module doc).
"""

from __future__ import annotations

import torch

from deepprior_tpu_torch.ops import hopper_label
from deepprior_tpu_torch.ops.crop import (
    _div,
    _exact_floor_div,
    clamp_depth,
    com_to_bounds,
)
from deepprior_tpu_torch.utils.profiling import annotate


def _grid(h, w, device):
    """Float column (1, W) and row (H, 1) coordinates."""
    cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return cols, rows


def _moments(mask, value):
    """(mean col, mean row, mean value) over the masked pixels of
    (..., H, W), the count clamped to 1, and the count."""
    h, w = mask.shape[-2:]
    cols, rows = _grid(h, w, mask.device)
    num = mask.sum((-2, -1)).to(torch.float32)
    safe = num.clamp(min=1.0)
    cx = torch.where(mask, cols, 0.0).sum((-2, -1)) / safe
    cy = torch.where(mask, rows, 0.0).sum((-2, -1)) / safe
    cz = torch.where(mask, value, 0.0).sum((-2, -1)) / safe
    return torch.stack([cx, cy, cz], dim=-1), num


def _first_argmin(x):
    """Index of the first minimum along the last axis of (..., N)."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device).expand(x.shape)
    hit = x == x.min(dim=-1, keepdim=True).values
    return torch.where(hit, iota, n).min(dim=-1).values


def _first_argmax(x):
    """Index of the first maximum along the last axis of (..., N)."""
    return _first_argmin(-x)


def calculate_com(dpt, min_depth=10.0, max_depth=1500.0):
    """CoM of the valid depth pixels: (mean col, mean row, mean depth)
    (handdetector.py:91-108); pixels outside [min_depth, max_depth] are
    ignored and an empty image yields (0, 0, 0).

    dpt: (..., H, W); min/max_depth broadcast over the batch.  Returns
    (..., 3)."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    min_d = torch.as_tensor(min_depth, dtype=torch.float32, device=dpt.device)
    max_d = torch.as_tensor(max_depth, dtype=torch.float32, device=dpt.device)
    valid = ((dpt >= min_d[..., None, None]) & (dpt <= max_d[..., None, None])
             & (dpt > 0.0))
    com, num = _moments(valid, dpt)
    return torch.where((num > 0)[..., None], com, 0.0)


def check_image(dpt, tol=1.0):
    """Content check: std(dpt) >= tol (handdetector.py:110-120)."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    return torch.std(dpt, dim=(-2, -1), correction=0) >= tol


def _masked_com_in_bounds(dpt, xstart, xend, ystart, yend, zstart, zend,
                          empty_z=None, min_depth=None, max_depth=None):
    """CoM of each sample's z-thresholded bbox crop, without materializing
    it (handdetector.py:554-563): valid = in-bbox & d != 0 & d <= zend,
    value = max(d, zstart), and value within the per-image
    [min_depth, max_depth] when given (the reference's calculateCoM
    re-masks by the detector's limits).  x/y are full-image coordinates.

    An empty crop falls back to (xstart, ystart, the thresholded depth at
    the bbox centre), with ``empty_z`` in place of a zero centre depth when
    given (handdetector.py:415-418).

    dpt (B, H, W); every bound (B,).  Returns (B, 3)."""
    b, h, w = dpt.shape
    cols, rows = _grid(h, w, dpt.device)

    def c(t):  # (B,) -> (B, 1, 1)
        return t[:, None, None]

    in_bbox = ((cols >= c(xstart)) & (cols < c(xend))
               & (rows >= c(ystart)) & (rows < c(yend)))
    valid = in_bbox & (dpt != 0.0) & (dpt <= c(zend))
    value = torch.maximum(dpt, c(zstart))
    if max_depth is not None:
        valid = valid & (value <= c(max_depth))
    if min_depth is not None:
        valid = valid & (value >= c(min_depth))
    com, num = _moments(valid, value)

    two = torch.full_like(xstart, 2.0)
    ccx = xstart + _exact_floor_div(xend - xstart, two)
    ccy = ystart + _exact_floor_div(yend - ystart, two)
    inside = (ccx >= 0) & (ccx < w) & (ccy >= 0) & (ccy < h)
    raw = dpt[torch.arange(b, device=dpt.device),
              ccy.clamp(0, h - 1).long(), ccx.clamp(0, w - 1).long()]
    center_d = torch.where(inside, raw, 0.0)
    center_d = torch.where((center_d != 0.0) & (center_d < zstart), zstart,
                           center_d)
    center_d = torch.where(center_d > zend, 0.0, center_d)
    if empty_z is not None:
        center_d = torch.where(center_d == 0.0, float(empty_z), center_d)
    fallback = torch.stack([xstart, ystart, center_d], dim=-1)
    return torch.where((num > 0)[:, None], com, fallback)


def refine_com_iterative(dpt, com, cube, fx, fy, num_iter=5, empty_z=None,
                         min_depth=None, max_depth=None):
    """Iterative CoM refinement: crop -> CoM -> recentre, ``num_iter``
    times (handdetector.py:546-567).

    dpt (B, H, W) clamped depth with com (B, 3), or one (H, W) frame with
    com (3,); cube (3,) or (B, 3).  empty_z: the docom import path's 300 mm
    fallback, None elsewhere.  min_depth/max_depth: the per-image limits
    ``clamp_depth`` returned (scalar or (B,)); omitted, clamp_depth's own
    defaults 10 and 1500, which are exact or looser, never tighter."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    com = torch.as_tensor(com, dtype=torch.float32, device=dpt.device)
    squeeze = dpt.dim() == 2
    if squeeze:
        dpt, com = dpt[None], com[None]
    cube = torch.as_tensor(cube, dtype=torch.float32, device=dpt.device)
    cube = cube.expand(com.shape)
    b = com.shape[0]
    img_hw = dpt.shape[-2:]
    min_d = torch.as_tensor(10.0 if min_depth is None else min_depth,
                            dtype=torch.float32, device=dpt.device).expand(b)
    max_d = torch.as_tensor(1500.0 if max_depth is None else max_depth,
                            dtype=torch.float32, device=dpt.device).expand(b)
    for _ in range(num_iter):
        xs, xe, ys, ye, zs, ze = com_to_bounds(com, cube, fx, fy, img_hw)
        com = _masked_com_in_bounds(dpt, xs, xe, ys, ye, zs, ze, empty_z,
                                    min_d, max_d)
    return com[0] if squeeze else com


def detect_closest(dpt, cube, fx, fy, num_iter=5, min_depth=10.0,
                   max_depth=1500.0):
    """Hand detection seeded at the closest valid pixel, then refined
    iteratively: the JAX package's cheap variant of HandDetector.detect,
    with no minimum-area gate (a noise speck nearer than the hand wins the
    seed; ``detect`` has the gate).

    dpt: (B, H, W) clamped depth; min/max_depth: scalar or (B,), the
    per-image limits ``clamp_depth`` returned.  Returns (B, 3)."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    b, h, w = dpt.shape
    min_d = torch.as_tensor(min_depth, dtype=torch.float32,
                            device=dpt.device).expand(b)
    max_d = torch.as_tensor(max_depth, dtype=torch.float32,
                            device=dpt.device).expand(b)
    valid = ((dpt >= min_d[:, None, None]) & (dpt <= max_d[:, None, None])
             & (dpt > 0))
    flat = dpt.reshape(b, h * w)
    idx = _first_argmin(torch.where(valid.reshape(b, h * w), flat, torch.inf))
    com0 = torch.stack([(idx % w).to(torch.float32),
                        (idx // w).to(torch.float32),
                        flat.gather(1, idx[:, None])[:, 0]], dim=-1)
    return refine_com_iterative(dpt, com0, cube, fx, fy, num_iter,
                                min_depth=min_d, max_depth=max_d)


def _shift(x, axis, offset, fill):
    """Shift ``x`` by ``offset`` along ``axis``, filling vacated slots."""
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = abs(offset)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if offset > 0:
        return torch.cat([pad, x.narrow(axis, 0, n - offset)], dim=axis)
    return torch.cat([x.narrow(axis, -offset, n + offset), pad], dim=axis)


def _scan(fn, x, axis, reverse):
    """An inclusive scan ``fn`` along ``axis``, from the end if reverse."""
    if reverse:
        return fn(x.flip(axis), axis).flip(axis)
    return fn(x, axis)


def _seg_min_scan(lab, mask, axis, region=None):
    """Min of ``lab`` within each maximal run of connected pixels along
    ``axis``; runs break at unmasked pixels and, given ``region``, where the
    region id changes.

    A segmented prefix-min is cummin(lab - K*cumsum(reset)) + K*cumsum(reset)
    with K > max(lab): keys of earlier segments sit at least K higher and
    never win.  Forward + backward passes give the full run min."""
    axis = axis % lab.dim()
    k = lab.shape[-1] * lab.shape[-2] + 1

    def cumsum(x, dim):
        return torch.cumsum(x, dim, dtype=torch.int32)

    def cummin(x, dim):
        return torch.cummin(x, dim).values

    def directional(offset):
        r = ~mask
        if region is not None:
            r = r | (region != _shift(region, axis, offset, -1))
        cnt = _scan(cumsum, r.to(torch.int32), axis, offset < 0)
        return _scan(cummin, lab - k * cnt, axis, offset < 0) + k * cnt

    return torch.minimum(directional(1), directional(-1))


def label_components(mask, region=None):
    """Connected-component labels.

    mask: (..., H, W) bool.  region: optional integer (..., H, W); pixels
    connect only within equal region ids (``detect`` labels every depth
    slice in one pass).  Returns int32 (..., H, W): each foreground pixel
    holds the smallest linear index of its 4-connected component,
    background holds H*W.

    On a CUDA tensor the union-find kernel K8 (``hopper_label.label_kernel``)
    labels in one pass with no host sync, added to the innermost open span
    as ``passes`` = 1; it launches or raises.  On any other device the
    plain ``label_scan``, which adds the passes it took."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    if mask.is_cuda:
        lab = hopper_label.label_kernel(mask, region)
        annotate(passes=1)
        return lab
    return label_scan(mask, region)


def label_scan(mask, region=None):
    """``label_components`` by alternating row/column segmented min-scans,
    until a pass changes nothing: the plain version, on any device.  The
    passes it took (one host sync each) are added to the innermost open
    span as ``passes``."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    h, w = mask.shape[-2:]
    big = h * w
    iota = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, iota, big)
    passes = 0
    while True:
        passes += 1
        lab2 = torch.where(mask, _seg_min_scan(lab, mask, -1, region), big)
        lab3 = torch.where(mask, _seg_min_scan(lab2, mask, -2, region), big)
        if torch.equal(lab3, lab):
            annotate(passes=passes)
            return lab3
        lab = lab3


def _first_big_blob_com(valid, q, dpt, num_slices, min_area):
    """(found (B,), com (B, 3)) of the largest blob in the first depth
    slice whose largest 4-connected blob exceeds ``min_area`` pixels.

    valid: (B, H, W) bool, q: (B, H, W) slice index per pixel, dpt:
    (B, H, W) clamped depth.  All slices are labelled in one pass with q as
    the connectivity region; per-component area and slice come from one
    scatter over the labels.  com is (mean col, mean row, mean depth) over
    the blob (handdetector.py:592-607)."""
    b, h, w = valid.shape
    hw = h * w
    lab = label_components(valid, q)
    flat = lab.reshape(b, hw).long()
    counts = torch.zeros((b, hw + 1), dtype=torch.float32, device=valid.device)
    counts.scatter_add_(1, flat, valid.reshape(b, hw).to(torch.float32))
    counts[:, hw] = 0.0
    # slice id per component (uniform within one by construction)
    slice_of = torch.zeros((b, hw + 1), dtype=torch.int32, device=valid.device)
    slice_of.scatter_reduce_(1, flat, q.reshape(b, hw).to(torch.int32) + 1,
                             reduce="amax")  # 0 = background, else slice+1
    qualifies = counts > float(min_area)
    first_slice = torch.where(qualifies, slice_of, num_slices + 2).min(dim=1).values
    found = first_slice <= num_slices + 1
    target = qualifies & (slice_of == first_slice[:, None])
    best = _first_argmax(torch.where(target, counts, -1.0))
    # the blob's own pixel count is counts[best], which the JAX package
    # divides by
    blob = (lab == best[:, None, None].to(lab.dtype)) & valid
    return found, _moments(blob, dpt)[0]


def detect(dpt, cube, fx, fy, num_slices=20, min_area=200, num_iter=5):
    """Hand detection with the reference's semantics
    (handdetector.py:569-632): scan ``num_slices`` near-to-far depth
    slices, take the largest connected blob of the FIRST slice whose
    largest blob exceeds ``min_area`` pixels, then refine its CoM
    iteratively.  A pixel exactly on an interior slice boundary belongs to
    one slice here and to both in the reference's [lo, hi] scans.

    dpt: (B, H, W) or (H, W) RAW depth (the per-image clamp is applied
    here).  Returns (B, 3) or (3,) CoMs, zeros where nothing passes the
    area gate."""
    dpt = torch.as_tensor(dpt, dtype=torch.float32)
    squeeze = dpt.dim() == 2
    if squeeze:
        dpt = dpt[None]
    dc, dmin, dmax = clamp_depth(dpt)
    dz = torch.clamp(_div(dmax - dmin, float(num_slices)), min=1e-6)
    valid = dc > 0.0
    q = torch.floor((dc - dmin[:, None, None]) / dz[:, None, None])
    q = q.clamp(0, num_slices - 1).to(torch.int32)
    found, com0 = _first_big_blob_com(valid, q, dc, num_slices, min_area)
    com = refine_com_iterative(dc, com0, cube, fx, fy, num_iter,
                               min_depth=dmin, max_depth=dmax)
    com = torch.where(found[:, None], com, 0.0)
    return com[0] if squeeze else com
