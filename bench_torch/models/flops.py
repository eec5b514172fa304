"""Model flops, counted by ``torch.utils.flop_counter.FlopCounterMode``
(every convolution and matrix product, 2 x MAC) over the plain reference's
networks on the meta device: no memory and no time.  The arithmetic of the
port's ``utils/flops.py::model_flops``, applied to the benchmark's own
networks so that a change to the program cannot change the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch.reference import nets


def _meta(layout: dict, grad: bool) -> dict:
    return {k: torch.empty(v.shape, device="meta", requires_grad=grad and v.dim() >= 1
                           and not k.endswith(("running_mean", "running_var")))
            for k, v in layout.items()}


def forward_flops(family: str, layout: dict, batch: int, hw: int = 128) -> int:
    """Flops of one evaluation-mode forward pass at ``batch``."""
    w = _meta(layout, False)
    x = torch.empty((batch, 1, hw, hw), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        nets.NETS[family](w, x)
    return int(counter.get_total_flops())


def train_step_flops(family: str, layout: dict, batch: int, hw: int = 128) -> int:
    """Flops of one training step's forward and backward passes at
    ``batch`` (the gradient of every weight; none of the input)."""
    w = _meta(layout, True)
    x = torch.empty((batch, 1, hw, hw), device="meta")
    kw = {"train": True} if family == "resnet" else {}
    counter = FlopCounterMode(display=False)
    with counter:
        out = nets.NETS[family](w, x, **kw)
        out.sum().backward()
    return int(counter.get_total_flops())
