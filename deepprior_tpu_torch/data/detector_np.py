"""Literal numpy implementation of the crop pipeline (host-side oracle).

Counterpart of deepprior_tpu/data/detector_np.py, bound to the port's
``Camera``: the algorithm of ``HandDetector.cropArea3D`` (reference
src/util/handdetector.py:382-490) as plain vectorized numpy: dynamic bbox
slice -> constant pad -> z-threshold -> aspect-preserving resize ->
centre-embed, plus the host CoM detection (scipy's connected components).
The realtime pipeline uses it for the INIT hand-size calibration and for
host-side detection.  It imports numpy and scipy only.

No cv2 dependency: the nearest resize reproduces cv2.INTER_NEAREST's
``src = floor(dst * scale)`` indexing directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deepprior_tpu_torch.camera import Camera


class HandCropper:
    """Per-image host-side crop pipeline (constructor mirrors
    handdetector.py:49-69: per-image depth clamping)."""

    def __init__(self, dpt: np.ndarray, camera: Camera,
                 resize_method: str = "nearest"):
        dpt = np.asarray(dpt, np.float32).copy()
        self.max_depth = min(1500.0, float(dpt.max()))
        self.min_depth = max(10.0, float(dpt.min()))
        dpt[dpt > self.max_depth] = 0.0
        dpt[dpt < self.min_depth] = 0.0
        self.dpt = dpt
        self.camera = camera
        self.fx = abs(camera.fx)
        self.fy = abs(camera.fy)
        # the reference ctor's resize-method switch (handdetector.py:57-69):
        # 'nearest' = RESIZE_CV2_NN (the reference default), 'linear' =
        # RESIZE_CV2_LINEAR, 'nd_bilinear' = RESIZE_BILINEAR (the
        # hand-written ND-aware resize, handdetector.py:132-202)
        if resize_method not in ("nearest", "linear", "nd_bilinear"):
            raise ValueError(f"unknown resize method {resize_method!r}")
        self.resize_method = resize_method

    # ------------------------------------------------------------------
    def calculate_com(self, dpt: Optional[np.ndarray] = None) -> np.ndarray:
        """Masked-moment CoM (handdetector.py:91-108)."""
        d = self.dpt if dpt is None else np.asarray(dpt, np.float32)
        valid = (d >= self.min_depth) & (d <= self.max_depth) & (d > 0)
        num = int(valid.sum())
        if num == 0:
            return np.zeros(3, np.float32)
        rows, cols = np.nonzero(valid)
        return np.array(
            [cols.mean(), rows.mean(), d[valid].mean()], np.float32
        )

    def check_image(self, tol: float) -> bool:
        return bool(np.std(self.dpt) >= tol)

    # ------------------------------------------------------------------
    def com_to_bounds(self, com, size) -> Tuple[int, int, int, int, float, float]:
        """handdetector.py:204-226 (floor(x+0.5) rounding, center fallback)."""
        h, w = self.dpt.shape
        if np.isclose(com[2], 0.0):
            return (
                w // 4,
                w // 4 + w // 2,
                h // 4,
                h // 4 + h // 2,
                self.min_depth,
                self.max_depth,
            )
        zstart = com[2] - size[2] / 2.0
        zend = com[2] + size[2] / 2.0
        xstart = int(np.floor((com[0] * com[2] / self.fx - size[0] / 2.0) / com[2] * self.fx + 0.5))
        xend = int(np.floor((com[0] * com[2] / self.fx + size[0] / 2.0) / com[2] * self.fx + 0.5))
        ystart = int(np.floor((com[1] * com[2] / self.fy - size[1] / 2.0) / com[2] * self.fy + 0.5))
        yend = int(np.floor((com[1] * com[2] / self.fy + size[1] / 2.0) / com[2] * self.fy + 0.5))
        return xstart, xend, ystart, yend, zstart, zend

    def get_crop(self, xstart, xend, ystart, yend, zstart, zend, thresh_z=True):
        """Slice + constant-pad + z-threshold (handdetector.py:260-296).

        Deviation from the reference (documented, not reproduced): the
        reference's `d[max(ystart,0):min(yend,h)]` slice wraps negatively
        when the bbox lies entirely above/left of the image (yend < 0
        slices from the image END), emitting real image rows where the
        device paths (ops/crop.py in_img test) emit zero padding.  Here
        the bbox is intersected with the image and everything outside is
        zero — identical to the reference whenever any part of the bbox
        overlaps the image, and matching the device paths always.
        """
        d = self.dpt
        h, w = d.shape
        oh, ow = yend - ystart, xend - xstart
        crop = np.zeros((max(oh, 0), max(ow, 0)), d.dtype)
        y0, y1 = max(ystart, 0), min(yend, h)
        x0, x1 = max(xstart, 0), min(xend, w)
        if y1 > y0 and x1 > x0:
            crop[y0 - ystart : y1 - ystart, x0 - xstart : x1 - xstart] = d[
                y0:y1, x0:x1
            ]
        if thresh_z:
            near = (crop < zstart) & (crop != 0)
            crop[near] = zstart
            crop[crop > zend] = 0.0
        return crop

    @staticmethod
    def resize_nearest(src: np.ndarray, sz_wh: Tuple[int, int]) -> np.ndarray:
        """cv2.INTER_NEAREST-equivalent resize: src = floor(dst * scale)."""
        sw, sh = sz_wh
        h, w = src.shape
        cols = np.minimum((np.arange(sw) * (w / sw)).astype(np.int64), w - 1)
        rows = np.minimum((np.arange(sh) * (h / sh)).astype(np.int64), h - 1)
        return src[np.ix_(rows, cols)]

    @staticmethod
    def _halfpixel_taps(h, w, sz_wh):
        """cv2 half-pixel sample grid with edge-clamped taps, f32 in the
        same op order as the device paths (ops/crop.py, ops/resize.py) so
        floors/weights agree bit-for-bit.

        Returns (y0, y1, x0, x1 int index vectors; fy (sh, 1), fx (1, sw))."""
        sw, sh = sz_wh
        ys = (np.arange(sh, dtype=np.float32) + np.float32(0.5)) * (
            np.float32(h) / np.float32(sh)
        ) - np.float32(0.5)
        xs = (np.arange(sw, dtype=np.float32) + np.float32(0.5)) * (
            np.float32(w) / np.float32(sw)
        ) - np.float32(0.5)
        y0 = np.clip(np.floor(ys), 0, h - 1)
        x0 = np.clip(np.floor(xs), 0, w - 1)
        fy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None]
        fx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :]
        y0 = y0.astype(np.int64)
        x0 = x0.astype(np.int64)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        return y0, y1, x0, x1, fy, fx

    @classmethod
    def resize_linear(cls, src: np.ndarray, sz_wh: Tuple[int, int]) -> np.ndarray:
        """cv2.INTER_LINEAR-equivalent resize (half-pixel mapping,
        edge-clamped taps) — the reference's RESIZE_CV2_LINEAR
        (handdetector.py:347-348)."""
        src = np.asarray(src, np.float32)
        h, w = src.shape
        y0, y1, x0, x1, fy, fx = cls._halfpixel_taps(h, w, sz_wh)
        v00 = src[np.ix_(y0, x0)]
        v01 = src[np.ix_(y0, x1)]
        v10 = src[np.ix_(y1, x0)]
        v11 = src[np.ix_(y1, x1)]
        return (
            v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx
        ).astype(np.float32)

    @classmethod
    def resize_bilinear_nd(cls, src: np.ndarray, sz_wh: Tuple[int, int],
                           nd_value: float = 0.0) -> np.ndarray:
        """The reference's hand-written ND-aware bilinear resize
        (RESIZE_BILINEAR, handdetector.py:132-202): invalid (== nd_value)
        taps drop out with weight renormalization; >= 3 invalid taps of 4
        -> nd_value.  Numpy twin of ops/resize.resize_bilinear_nd (same
        half-pixel grid, same blend)."""
        src = np.asarray(src, np.float32)
        h, w = src.shape
        y0, y1, x0, x1, fy, fx = cls._halfpixel_taps(h, w, sz_wh)
        taps = [src[np.ix_(yi, xi)] for yi, xi in
                ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
        weights = [(1 - fy) * (1 - fx), (1 - fy) * fx,
                   fy * (1 - fx), fy * fx]
        masks = [t != nd_value for t in taps]
        wsum = sum(wt * m for wt, m in zip(weights, masks))
        vsum = sum(wt * np.where(m, t, 0.0)
                   for wt, m, t in zip(weights, masks, taps))
        n_invalid = sum((~m).astype(np.int32) for m in masks)
        return np.where(
            (n_invalid >= 3) | (wsum <= 0.0), nd_value,
            vsum / np.maximum(wsum, 1e-12),
        ).astype(np.float32)

    def resize_crop(self, crop: np.ndarray, sz_wh: Tuple[int, int]) -> np.ndarray:
        """resizeCrop's method dispatch (handdetector.py:336-352)."""
        if self.resize_method == "nearest":
            return self.resize_nearest(crop, sz_wh)
        if self.resize_method == "linear":
            return self.resize_linear(crop, sz_wh)
        return self.resize_bilinear_nd(crop, sz_wh, nd_value=0.0)

    # ------------------------------------------------------------------
    def crop_area_3d(
        self,
        com=None,
        size=(250.0, 250.0, 250.0),
        dsize=(128, 128),
        docom: bool = False,
    ):
        """The full crop (handdetector.py:382-490, minus the refineNet hook).

        Returns (crop (dh, dw) float32 mm, M (3, 3), com).
        """
        if com is None:
            com = self.calculate_com()
        com = np.asarray(com, np.float32).copy()

        xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com, size)
        # a CoM depth near (but not at) zero projects the metric cube to a
        # bbox of millions of pixels: the reference explodes here too
        # (cv2.resize of a giant canvas, handdetector.py:427-447), and this
        # host twin would materialize it.  The device paths (ops/crop.py)
        # stay well-defined via static shapes, so only the oracle needs a
        # loud guard instead of an OOM/hang.
        h, w = self.dpt.shape
        if (xend - xstart) * (yend - ystart) > 1024 * h * w:
            raise ValueError(
                f"degenerate CoM depth {com[2]:.3g} mm: cube {tuple(size)} "
                f"projects to a {int(xend - xstart)}x{int(yend - ystart)} px "
                "bbox (the reference framework fails on this input as well); "
                "com_z must be 0 (center-crop fallback) or a physical depth"
            )
        cropped = self.get_crop(xstart, xend, ystart, yend, zstart, zend)

        if docom:
            # recompute the CoM inside the cube and recrop (py:413-427)
            com = self.calculate_com(cropped)
            if np.allclose(com, 0.0):
                com[2] = cropped[cropped.shape[0] // 2, cropped.shape[1] // 2]
                if np.isclose(com[2], 0.0):
                    com[2] = 300.0
            com[0] += xstart
            com[1] += ystart
            xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com, size)
            cropped = self.get_crop(xstart, xend, ystart, yend, zstart, zend)

        wb, hb = xend - xstart, yend - ystart
        dw, dh = dsize
        if wb > hb:
            sz = (dw, hb * dw // wb)
        else:
            sz = (wb * dh // hb, dh)
        scale = sz[1] / float(hb) if hb > wb else sz[0] / float(wb)

        rz = self.resize_crop(cropped, sz)

        ret = np.zeros((dh, dw), np.float32)  # ND background == 0 post-clamp
        ox = int(np.floor(dw / 2.0 - rz.shape[1] / 2.0))
        oy = int(np.floor(dh / 2.0 - rz.shape[0] / 2.0))
        ret[oy : oy + rz.shape[0], ox : ox + rz.shape[1]] = rz

        m = np.array(
            [
                [scale, 0.0, -scale * xstart + ox],
                [0.0, scale, -scale * ystart + oy],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        return ret, m, com

    def apply_crop_3d(self, dpt, com, size, dsize, thresh_z=True, background=None):
        """Crop+resize+center-embed an arbitrary depth image
        (handdetector.py:353-380)."""
        xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com, size)
        save = self.dpt
        self.dpt = np.asarray(dpt, np.float32)
        try:
            cropped = self.get_crop(xstart, xend, ystart, yend, zstart, zend,
                                    thresh_z)
        finally:
            self.dpt = save
        wb, hb = xend - xstart, yend - ystart
        dw, dh = dsize
        if wb > hb:
            sz = (dw, hb * dw // wb)
        else:
            sz = (wb * dh // hb, dh)
        rz = self.resize_crop(cropped, sz)
        if background is None:
            background = 0.0  # ND value post-clamp
        ret = np.full((dh, dw), background, np.float32)
        ox = int(np.floor(dw / 2.0 - rz.shape[1] / 2.0))
        oy = int(np.floor(dh / 2.0 - rz.shape[0] / 2.0))
        ret[oy : oy + rz.shape[0], ox : ox + rz.shape[1]] = rz
        return ret

    def get_inverse_crop(self, crop, out_hw, xstart, xend, ystart, yend,
                         zstart, zend, thresh_z=True, background=0.0):
        """Paste a crop back into a full frame (handdetector.py:298-334)."""
        out = np.full(out_hw, background, np.float32)
        h, w = out_hw
        if xend <= xstart or yend <= ystart:
            return out
        if (xend < 0 and xstart < 0) or (xend > w and xstart > w):
            return out
        if (yend < 0 and ystart < 0) or (yend > h and ystart > h):
            return out
        rz = self.resize_nearest(np.asarray(crop, np.float32),
                                 (xend - xstart, yend - ystart))
        ys, ye = max(ystart, 0), min(yend, h)
        xs, xe = max(xstart, 0), min(xend, w)
        out[ys:ye, xs:xe] = rz[
            ys - ystart : rz.shape[0] - (yend - ye),
            xs - xstart : rz.shape[1] - (xend - xe),
        ]
        if thresh_z:
            near = (out < zstart) & (out != 0)
            out[near] = zstart
            out[out > zend] = 0.0
        return out

    # ------------------------------------------------------------------
    def refine_com_iterative(self, com, num_iter, size=(250.0, 250.0, 250.0)):
        """handdetector.py:546-567 (CoM in full-image coordinates)."""
        com = np.asarray(com, np.float32).copy()
        for _ in range(num_iter):
            xstart, xend, ystart, yend, zstart, zend = self.com_to_bounds(com, size)
            cropped = self.get_crop(xstart, xend, ystart, yend, zstart, zend)
            c = self.calculate_com(cropped)
            if np.allclose(c, 0.0):
                c[2] = cropped[cropped.shape[0] // 2, cropped.shape[1] // 2]
            # crop col c maps to image col xstart + c (the reference adds
            # max(xstart, 0), which is off by |xstart| for bboxes crossing
            # the left/top edge — we use correct image coordinates)
            c[0] += xstart
            c[1] += ystart
            com = c
        return com

    def detect(self, size=(250.0, 250.0, 250.0), num_slices=20, min_area=200):
        """Full-frame detection: depth slices -> connected components ->
        iterative CoM refinement (handdetector.py:569-632), using
        scipy.ndimage.label instead of cv2 contours.

        Returns the CoM, or zeros if nothing is found.
        """
        from scipy import ndimage

        dz = (self.max_depth - self.min_depth) / float(num_slices)
        for i in range(num_slices):
            lo = i * dz + self.min_depth
            hi = (i + 1) * dz + self.min_depth
            mask = (self.dpt >= lo) & (self.dpt <= hi) & (self.dpt > 0)
            if not mask.any():
                continue
            labels, n = ndimage.label(mask)
            if n == 0:
                continue
            sizes = ndimage.sum_labels(mask, labels, index=np.arange(1, n + 1))
            big = np.argsort(sizes)[::-1]
            if sizes[big[0]] <= min_area:
                continue
            blob = labels == (big[0] + 1)
            rows, cols = np.nonzero(blob)
            com = np.array(
                [cols.mean(), rows.mean(), self.dpt[blob].mean()], np.float32
            )
            return self.refine_com_iterative(com, 5, size)
        return np.zeros(3, np.float32)

    @staticmethod
    def check_pose(joints) -> bool:
        """Anatomical plausibility check — a stub that always passes, like
        the reference (handdetector.py:492-502 returns True unconditionally;
        kept for API parity)."""
        return True

    def estimate_hand_size(self, com, size=(250.0, 250.0, 250.0), tol=0.0):
        """Metric cube from the extent of the z-sliced blob around the CoM
        (handdetector.py:911-937, bbox from the thresholded mask)."""
        zstart = com[2] - size[2] / 2.0
        zend = com[2] + size[2] / 2.0
        mask = (self.dpt >= zstart) & (self.dpt <= zend) & (self.dpt > 0)
        if not mask.any():
            return size
        rows, cols = np.nonzero(mask)
        w = cols.max() - cols.min() + 1
        h = rows.max() - rows.min() + 1
        szx = w * com[2] / self.fx
        szy = h * com[2] / self.fy
        sz = (szx + szy) / 2.0
        return (sz + tol, sz + tol, sz + tol)
