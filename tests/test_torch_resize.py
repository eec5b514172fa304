"""The port's resize ops (deepprior_tpu_torch.ops.resize) against the JAX
package and the numpy host twin (data/detector_np.HandCropper), on the
same seeded numpy images: rtol 1e-6.

The host twin maps nearest rows in float64 and the bilinear grid with a
float32 division, where the JAX package and the port multiply float32 by
the float32 ratio; at these sizes every floor and weight agrees."""

import numpy as np
import pytest
import torch

from deepprior_tpu.data.detector_np import HandCropper
from deepprior_tpu.ops import resize as jresize

from deepprior_tpu_torch.ops import resize as tresize

SIZES = {"down": ((40, 56), (13, 29)), "up": ((13, 17), (40, 61)),
         "mixed": ((31, 24), (16, 48))}


def _depth(shape, seed, nd_frac):
    """Depth-like values with a fraction of ND (0) pixels."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(300.0, 900.0, shape).astype(np.float32)
    img[rng.uniform(size=shape) < nd_frac] = 0.0
    return img


@pytest.mark.parametrize("size", list(SIZES))
def test_resize_nearest_matches_jax_and_host(size):
    (h, w), (oh, ow) = SIZES[size]
    img = _depth((2, h, w), 1, 0.1)
    got = tresize.resize_nearest(torch.from_numpy(img), (oh, ow)).numpy()
    np.testing.assert_allclose(got, np.asarray(jresize.resize_nearest(img, (oh, ow))),
                               rtol=1e-6)
    for i in range(2):
        np.testing.assert_allclose(got[i], HandCropper.resize_nearest(img[i], (ow, oh)),
                                   rtol=1e-6)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("nd_frac", [0.0, 0.3, 0.7])
def test_resize_bilinear_nd_matches_jax_and_host(size, nd_frac):
    (h, w), (oh, ow) = SIZES[size]
    img = _depth((2, h, w), 2, nd_frac)
    got = tresize.resize_bilinear_nd(torch.from_numpy(img), (oh, ow)).numpy()
    want = np.asarray(jresize.resize_bilinear_nd(img, (oh, ow)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for i in range(2):
        host = HandCropper.resize_bilinear_nd(img[i], (ow, oh))
        np.testing.assert_allclose(got[i], host, rtol=1e-6)
    if nd_frac == 0.0:  # all valid: the plain cv2 bilinear resize
        for i in range(2):
            np.testing.assert_allclose(got[i], HandCropper.resize_linear(img[i], (ow, oh)),
                                       rtol=1e-6)


def test_nd_blend_matches_jax():
    rng = np.random.default_rng(3)
    taps = [_depth((6, 9), 10 + i, 0.4) for i in range(4)]
    fy = rng.uniform(0.0, 1.0, (6, 1)).astype(np.float32)
    fx = rng.uniform(0.0, 1.0, (1, 9)).astype(np.float32)
    fy[0] = 0.0
    fx[0, 0] = 1.0
    want = np.asarray(jresize.nd_blend(*taps, fy, fx, 0.0))
    got = tresize.nd_blend(*map(torch.from_numpy, taps), torch.from_numpy(fy),
                           torch.from_numpy(fx), 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # >= 3 invalid taps -> ND, whatever the weights
    n_invalid = sum((t == 0.0).astype(int) for t in taps)
    assert (got[n_invalid >= 3] == 0.0).all()
