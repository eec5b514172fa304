"""V2V-PoseNet's model flops, counted by
``torch.utils.flop_counter.FlopCounterMode`` (every convolution and
transposed convolution, 2 x MAC) over the benchmark's plain reference
network (``reference/v2v.py``) on the meta device: no memory and no time.
A change to the program cannot change the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch.reference import v2v


def _meta(layout: dict, grad: bool) -> dict:
    return {k: torch.empty(v.shape, device="meta", requires_grad=grad
                           and not k.endswith(("running_mean", "running_var")))
            for k, v in layout.items()}


def forward_flops(layout: dict, batch: int, grid: int = 88) -> int:
    """Flops of one forward pass at ``batch`` on a grid^3 input."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        v2v.net(_meta(layout, False), torch.empty((batch, 1, grid, grid, grid), device="meta"))
    return int(counter.get_total_flops())


def train_step_flops(layout: dict, batch: int, grid: int = 88) -> int:
    """Flops of one training step's forward and backward passes at
    ``batch`` (the gradient of every weight; none of the input)."""
    counter = FlopCounterMode(display=False)
    with counter:
        out = v2v.net(_meta(layout, True), torch.empty((batch, 1, grid, grid, grid),
                                                       device="meta"))
        out.sum().backward()
    return int(counter.get_total_flops())
