"""A model family's choices, the one seam through which the trainer
(train/trainer.py) and the estimator (realtime/fused.py) reach a model:

- ``inputs(batch, camera, step=None, stats=None)``: the network's input of
  a batch of crops (dict of crops, com, cube, m); ``stats`` takes the
  family's counters (0-d tensors on the device, added to with no host
  sync);
- ``mirror_dim``: the input's axis a right hand is mirrored along;
- ``targets(labels_norm, step=None, batch=None, camera=None)``,
  ``loss(out, y)``: training; ``batch`` is the (augmented) batch the
  labels belong to and ``camera`` the trainer's, for a family whose targets
  lie in the crop (A2J);
- ``joints(out, batch, camera=None)``: the joints (B, J, 3) in mm about the
  CoM;
- ``rows(out, y, batch, camera=None)``: evaluation's per-sample statistics;
- ``extras(x, out)``: what the serving estimator (realtime/fused.py) returns
  after the joints, the CoM and the crops;
- ``freezes``: whether a serving artifact (realtime/export.py) may freeze
  the estimator's pipeline.

``family_of(model, prior)`` is the model itself where it brings these
(models/v2v.py::V2VPoseNet: an occupancy grid in, 3D heatmaps out;
models/a2j.py::A2J: the crop in, anchors' votes out), else
``CropRegression`` (PoseRegNet, ResNet, ScaleNet: the crops in, the PCA
embedding or the normalized joints out).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepprior_tpu_torch.prior import PCAPrior


def _loss_from_targets(out, y):
    """(B, D) targets: the squared error summed over D, mean over the batch;
    (B, J, 3) targets: summed over xyz, mean over joints and the batch
    (poseregnettrainer.py:92-101)."""
    if y.dim() == 2:
        per_sample = torch.sum(torch.square(out - y), dim=1)
    else:
        out3 = out.reshape(y.shape)
        per_sample = torch.mean(torch.sum(torch.square(out3 - y), dim=2), dim=1)
    return torch.mean(per_sample)


class CropRegression:
    """The crop regressors' family (PoseRegNet, ResNet, ScaleNet): the crops
    in as one-channel maps, mirrored along their width; out, the PCA
    embedding of the cube-normalized joints when a prior is attached
    (poseregnettrainer.py:252-259), else the joints; ``_loss_from_targets``."""

    mirror_dim = -1
    freezes = True

    def __init__(self, prior: Optional[PCAPrior]):
        self.prior = prior

    def inputs(self, batch, camera, step=None, stats=None):
        return batch["crops"][:, None]

    def targets(self, labels_norm, step=None, batch=None, camera=None):
        if self.prior is not None:
            return self.prior.transform(labels_norm.reshape(labels_norm.shape[0], -1))
        return labels_norm

    def loss(self, out, y):
        return _loss_from_targets(out, y)

    def joints(self, out, batch, camera=None):
        """The joints (B, J, 3) in mm about the CoM."""
        d3 = self.prior.inverse_transform(out) if self.prior is not None else out
        return d3.reshape(out.shape[0], -1, 3) * (batch["cube"][:, 2] / 2.0)[:, None, None]

    def extras(self, x, out):
        return ()

    def rows(self, out, y, batch, camera=None):
        """(cost, normalized error, joint distances in mm) of each sample
        (poseregnettrainer.py:122-126)."""
        if y.dim() == 2:
            cost_ps = torch.sum(torch.square(out - y), dim=1)
            err_ps = torch.sqrt(cost_ps)
        else:
            sq = torch.sum(torch.square(out.reshape(y.shape) - y), dim=2)
            cost_ps = torch.mean(sq, dim=1)
            err_ps = torch.mean(torch.sqrt(sq), dim=1)
        dist = torch.sqrt(torch.sum(
            torch.square(self.joints(out, batch) - batch["gt3d_crop"]), dim=2))
        return cost_ps, err_ps, dist


def family_of(model, prior: Optional[PCAPrior] = None):
    """The model where it brings its family's choices, else
    ``CropRegression(prior)``."""
    return model if hasattr(model, "targets") else CropRegression(prior)
