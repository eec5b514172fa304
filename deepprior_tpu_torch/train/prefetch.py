"""Epoch indexing with the reference's tail padding (numpy copies of
deepprior_tpu/train/prefetch.py's ``aligned_epoch_indices`` and
``chunked_epochs``).  ``DevicePrefetcher`` and ``macro_chunks`` belong to
streamed training, not ported yet (ROADMAP.md Queue 1 item 13)."""

from __future__ import annotations

import numpy as np


def aligned_epoch_indices(rng, n: int, batch_size: int):
    """One epoch's sample indices with the reference's alignData tail
    (nettrainer.py:365-413): a fresh permutation of all n samples, the last
    incomplete minibatch padded to batch_size with seeded-random repeats
    from ``RandomState(n)``, the reference's pad_random seeding quirk (the
    same pad every epoch), so every frame trains every epoch.

    Consumes exactly one rng.permutation(n).  Returns
    (ceil(n / batch_size) * batch_size,) indices."""
    perm = rng.permutation(n)
    rem = n % batch_size
    if rem == 0:
        return perm
    pad = np.random.RandomState(n).randint(0, n, size=batch_size - rem)
    return np.concatenate([perm, pad])


def chunked_epochs(arrays: dict, batch_size: int, n_epochs: int,
                   seed: int = 23455):
    """Host-side batch generator over a dict of co-indexed numpy arrays,
    reshuffled per epoch; the tail batch is alignData-padded."""
    n = next(iter(arrays.values())).shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(n_epochs):
        idx_all = aligned_epoch_indices(rng, n, batch_size)
        for s in range(0, idx_all.shape[0], batch_size):
            idx = idx_all[s : s + batch_size]
            yield {k: v[idx] for k, v in arrays.items()}
