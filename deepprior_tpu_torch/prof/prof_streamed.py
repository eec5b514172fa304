"""Streamed against resident training on the card.

    python -m deepprior_tpu_torch.prof.prof_streamed [--batches 128 512]

Writes a seeded MSRA15 tree (8 subjects x 256 frames of 320x240, the real
.bin format; ``data/trees.py``) into a temporary directory, imports it with
the batched crop on the card, fits a PCA prior, and times full-width
PoseRegNet training (float32, hidden 1024, PCA 30, aug com/rot/none, K5)
at each batch size, two loops in turns (two epochs a run, four runs each
after a warm-up):

- ``fit``: the training set resident on the card;
- ``fit_streamed``: chunks of 8 minibatches gathered from host memory
  into the prefetcher's pinned slots with ``torch.index_select``.

Prints ms a step, samples/s and the prefetcher's staging ms a chunk (its
worker's time: gather, copy, the upload's launch), each line with the
card's name and power limit.  Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from deepprior_tpu_torch.camera import MSRA15_CAMERA
from deepprior_tpu_torch.data import trees
from deepprior_tpu_torch.data.basetypes import ImageSequence
from deepprior_tpu_torch.data.importers import MSRA15Importer
from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.prior import fit_pose_prior
from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer
from deepprior_tpu_torch.utils.profiling import card_label, require_cuda

SUBJECTS = [f"P{i}" for i in range(8)]
FRAMES, EPOCHS, CHUNK = 256, 2, 8


def load_data(dev):
    """The tree's 2,048 frames as host TrainData, and the PCA prior."""
    with tempfile.TemporaryDirectory() as root:
        trees.write_msra15_tree(root, subjects=SUBJECTS, frames=FRAMES, seed=31)
        imp = MSRA15Importer(root, use_cache=False, device=dev)
        frames = [f for s in SUBJECTS for f in imp.loadSequence(s, device_crop=True).data]
    data = TrainData.from_sequence(ImageSequence("train", frames, {"cube": (200,) * 3}))
    prior = fit_pose_prior(MSRA15_CAMERA, np.random.default_rng(0), data.gt3d_crop, data.com,
                           data.cube, n_components=30, num_poses=50_000)
    return data, prior


def main(argv=None, log=print):
    """Returns {batch: {loop: [(ms a step, staging ms a chunk or None)]}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="*", default=[128, 512])
    args = ap.parse_args(argv)
    dev = require_cuda("prof_streamed")
    card = card_label(dev)
    data, prior = load_data(dev)
    arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
    resident = data.to(dev)
    out = {}
    for batch in args.batches:
        steps = -(-data.n // batch)
        loops = {}
        for name in ("fit", "fit_streamed"):
            tr = Trainer(PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30)),
                         TrainConfig(batch_size=batch, n_epochs=EPOCHS), MSRA15_CAMERA,
                         prior=prior, device=dev)
            loops[name] = (tr, tr.init_state())

        def run(name):
            tr, st = loops[name]
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "fit":
                tr.fit(st, resident, log=lambda m: None)
            else:
                tr.fit_streamed(st, arrays, chunk_steps=CHUNK, log=lambda m: None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3 / (EPOCHS * steps)
            stage = None if name == "fit" else float(np.median(tr.prefetcher.stage_s)) * 1e3
            return ms, stage

        for name in loops:
            run(name)  # warm-up
        res = {name: [] for name in loops}
        for order in (("fit", "fit_streamed"), ("fit_streamed", "fit")) * 2:
            for name in order:
                res[name].append(run(name))
        for name, runs in res.items():
            ms = [r[0] for r in runs]
            line = (f"[{card}] B={batch} {name}: {min(ms):.4f}-{max(ms):.4f} ms a step "
                    f"= {batch / (np.mean(ms) / 1e3):.1f} samples/s")
            if runs[0][1] is not None:
                st = [r[1] for r in runs]
                line += (f"; staging {min(st):.3f}-{max(st):.3f} ms a chunk of "
                         f"{min(CHUNK, steps)} steps (median of each run)")
            log(line)
        out[batch] = res
    return out


if __name__ == "__main__":
    main()
