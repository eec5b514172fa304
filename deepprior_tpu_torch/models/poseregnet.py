"""PoseRegNet: the DeepPose-style CNN regressor (NCHW).

Counterpart of deepprior_tpu/models/poseregnet.py (reference
src/net/poseregnet.py:44-165):
type 0:  C(8,5x5)P4 -> C(8,5x5)P2 -> C(8,3x3) -> FC1024 -> drop ->
         FC1024 -> drop -> FC(numJoints*nDims)   (128x128 input:
         124->31, 27->13, 11 -> flatten 8*11*11 = 968)
type 11: the same trunk with a 30-D linear bottleneck before the final
         linear decode.

Input (B, 1, 128, 128); output (B, out_dim) float32.  Parameters are
float32; compute runs in ``cfg.dtype``.  Under the 'sp' axis
(``spatial``, a parallel/spatial.py ``Plan``) the trunk computes this
rank's block of rows of each map and gathers the last one before the head.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from deepprior_tpu_torch.models.layers import ConvPool, MLPHead

INPUT_HW = 128  # the crop size the trunk's flatten width is fixed for
_TRUNK = (  # (features, kernel, pool) of the three ConvPool layers
    (8, (5, 5), (4, 4)),
    (8, (5, 5), (2, 2)),
    (8, (3, 3), (1, 1)),
)


class PoseRegNetConfig(NamedTuple):
    num_joints: int = 14
    n_dims: int = 3
    embedding: Optional[int] = None  # type 11's 30-D bottleneck
    hidden: int = 1024
    dropout: bool = True
    # FC nonlinearity; a 2-arg callable (layers.prelu) enables the
    # reference's learned-parameter activation
    activation: Any = torch.relu
    dtype: torch.dtype = torch.float32
    # the JAX package's MXU lane-packed conv; no effect here
    packed_conv: bool = False

    @property
    def out_dim(self) -> int:
        return self.num_joints * self.n_dims


def _trunk_out_hw(hw: int) -> int:
    for _, (k, _), (p, _) in _TRUNK:
        hw = (hw - k + 1) // p
    return hw


class PoseRegNet(nn.Module):
    def __init__(self, cfg: PoseRegNetConfig = PoseRegNetConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        convs, c_in = [], 1
        for feats, kernel, pool in _TRUNK:
            convs.append(ConvPool(c_in, feats, kernel, pool, dtype=cfg.dtype,
                                  packed=cfg.packed_conv))
            c_in = feats
        self.convs = nn.ModuleList(convs)
        self.head = MLPHead(
            c_in * _trunk_out_hw(INPUT_HW) ** 2,
            cfg.out_dim,
            hidden=cfg.hidden,
            dropout=cfg.dropout,
            embedding=cfg.embedding,
            activation=cfg.activation,
            dtype=cfg.dtype,
        )
        self.spatial = None  # the 'sp' axis' Plan (parallel/spatial.py)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He/Xavier init drawn from ``generator`` (a seeded
        ``torch.Generator`` on the parameters' device, or None)."""
        for conv in self.convs:
            conv.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, 1, H, W) normalized depth crop -> (B, out_dim) float32.
        In training mode ``generator`` draws the dropout masks."""
        plan = self.spatial
        rows = (None,) * len(self.convs) if plan is None else plan.rows[0]
        for conv, r in zip(self.convs, rows):
            x = conv(x, rows=r)
        if plan is not None:
            x = plan.gather[0](x)
        return self.head(x, generator=generator).to(torch.float32)
