"""A2J's model flops, counted by ``torch.utils.flop_counter.FlopCounterMode``
(every convolution and matrix product, 2 x MAC) over the benchmark's plain
reference network (``reference/a2j.py``) on the meta device: no memory and
no time.  A change to the program cannot change the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch.reference import a2j


def _meta(layout: dict, grad: bool) -> dict:
    return {k: torch.empty(v.shape, device="meta", requires_grad=grad
                           and not k.endswith(("running_mean", "running_var")))
            for k, v in layout.items()}


def _crop(batch: int, hw: int):
    return torch.empty((batch, 1, hw, hw), device="meta")


def forward_flops(layout: dict, batch: int, num_joints: int = 14, hw: int = 176) -> int:
    """Flops of one forward pass of the network at ``batch`` on hw^2 crops."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        a2j.net(_meta(layout, False), _crop(batch, hw), num_joints)
    return int(counter.get_total_flops())


def train_step_flops(layout: dict, batch: int, num_joints: int = 14, hw: int = 176) -> int:
    """Flops of one training step's forward and backward passes at
    ``batch`` (the gradient of every weight; none of the input)."""
    counter = FlopCounterMode(display=False)
    with counter:
        out = a2j.net(_meta(layout, True), _crop(batch, hw), num_joints)
        sum(t.sum() for t in out).backward()
    return int(counter.get_total_flops())
