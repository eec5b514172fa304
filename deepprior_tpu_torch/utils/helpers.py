"""Small host-side helpers (reference src/util/helpers.py:35-153); the
port's own copy of deepprior_tpu/utils/helpers.py."""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def cartesian(arrays: Sequence[np.ndarray], out: np.ndarray = None) -> np.ndarray:
    """Cartesian product of 1-D arrays (helpers.py:35-85)."""
    arrays = [np.asarray(a) for a in arrays]
    dtype = np.result_type(*arrays)
    n = int(np.prod([a.size for a in arrays]))
    if out is None:
        out = np.zeros((n, len(arrays)), dtype=dtype)
    m = n // arrays[0].size
    out[:, 0] = np.repeat(arrays[0], m)
    if arrays[1:]:
        cartesian(arrays[1:], out=out[:m, 1:])
        for j in range(1, arrays[0].size):
            out[j * m : (j + 1) * m, 1:] = out[:m, 1:]
    return out


def shuffle_many_inplace(arrays: List[np.ndarray], random_state=None) -> None:
    """Consistent Fisher-Yates over a list of arrays — used to co-shuffle
    data/labels/com/cube/M (helpers.py:87-108)."""
    rng = random_state or np.random
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays):
        raise ValueError("arrays must be co-indexed")
    for i in range(n - 1, 0, -1):
        j = int(rng.randint(0, i + 1)) if hasattr(rng, "randint") else int(
            rng.integers(0, i + 1)
        )
        for a in arrays:
            a[[i, j]] = a[[j, i]]


def gaussian_kernel(size: int, sigma: float = None) -> np.ndarray:
    """2D Gaussian kernel, normalized to sum 1 (helpers.py:~120)."""
    if sigma is None:
        sigma = size / 6.0
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma (helpers.py:~140)."""
    rgb = np.asarray(rgb)
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.float32)


def chunks(lst: Sequence, n: int) -> Iterator:
    """Yield successive n-sized chunks (helpers.py:148-153)."""
    for i in range(0, len(lst), n):
        yield lst[i : i + n]
