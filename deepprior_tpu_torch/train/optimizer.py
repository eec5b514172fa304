"""Optimizers and the LR schedule of the reference trainer.

Counterpart of deepprior_tpu/train/optimizer.py:

- ``ReferenceAdam``: ADAM "version 2" with the beta1 decay gamma = 1 - 1e-8
  (reference src/trainer/optimizer.py:58-90).  Not ``torch.optim.Adam``,
  which orders its operations differently.
- ``ReferenceRMSProp``: RMSProp with the reference's epsilon-as-floor
  (optimizer.py:92-116: the rms is clamped from below by 0.01, not added).
- ``SGDMomentum``: optax.trace, the momentum direction g + decay * trace.
- ``lr_of_ep``: lr/10 (ep <= 1), lr/3 (1 < ep <= 2), then
  lr * exp(-0.04 * ep) (reference nettrainer.py:54), in float32.

Each optimizer computes the reference's direction u and applies
p + (-lr * u), as the JAX trainer applies ``tx.update`` scaled by -lr.
Adam's ``weight_decay`` (A2J's recipe; 0 by default) adds the coupled L2
term g + weight_decay * p to every gradient before the direction, as
``torch.optim.Adam``'s ``weight_decay`` does; at 0 the step launches nothing
more and its bits are unchanged.
The arithmetic is float32 on the parameters' device, with the per-step
scalars (Adam's count and bias corrections) kept there as 0-d tensors so
that a step never waits for the device; the per-parameter updates run as
``torch._foreach_*`` ops, a few launches for all parameters.
"""

from __future__ import annotations

import numpy as np
import torch


def lr_of_ep(base_lr: float):
    """Per-epoch learning-rate schedule (nettrainer.py:54), float32 as
    the JAX schedule computes it."""
    lr = np.float32(base_lr)

    def schedule(epoch) -> np.float32:
        ep = np.float32(epoch)
        if ep <= 1:
            return np.float32(base_lr / 10.0)
        if ep <= 2:
            return np.float32(base_lr / 3.0)
        return np.float32(lr * np.exp(np.float32(-0.04) * ep))

    return schedule


class _DirectionOptimizer(torch.optim.Optimizer):
    """Applies p + (-lr * u) for the direction u of ``_direction``.

    ``SLOTS`` names the per-parameter state tensors (zeros like the
    parameter); ``COUNTED`` optimizers keep a float32 step count per group
    that starts at 1.  Both are made with the optimizer, not at the first
    step, so that a snapshot taken before any step has the same structure
    as one taken after."""

    SLOTS: tuple = ()
    COUNTED = False

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        self._materialize()

    def _direction(self, group, params, grads):
        raise NotImplementedError

    def _materialize(self):
        for group in self.param_groups:
            if self.COUNTED:
                group["count"] = torch.ones((), dtype=torch.float32,
                                            device=group["params"][0].device)
            for p in group["params"]:  # distinct zero moments per parameter
                self.state[p].update({k: torch.zeros_like(p) for k in self.SLOTS})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group.get("weight_decay", 0.0):
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            updates = self._direction(group, params, grads)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
        return loss


class ReferenceAdam(_DirectionOptimizer):
    """Exact reference ADAM (optimizer.py:58-90): the count starts at 1,
    beta1_t = beta1 * gamma^(t-1), m_hat = m / (1 - beta1^t),
    v_hat = v / (1 - beta2^t), u = m_hat / (sqrt(v_hat) + eps).

    gamma is taken in float32, where the default 1 - 1e-8 rounds to 1.0
    (1e-8 is below half an ulp of 1), so the decay folds away exactly as in
    the reference's float32 Theano run and in the JAX package.  Do not
    compute it in float64: beta1_t would drift from the reference.
    """

    def __init__(self, params, lr: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 gamma: float = 1.0 - 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, beta1=beta1, beta2=beta2,
                                      eps=eps, gamma=gamma, weight_decay=weight_decay))

    SLOTS = ("mu", "nu")
    COUNTED = True

    def _direction(self, group, params, grads):
        dev = params[0].device
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]

        def f32(x):
            return torch.full((), x, dtype=torch.float32, device=dev)

        t = group["count"]
        beta1, beta2 = f32(group["beta1"]), group["beta2"]
        beta1_t = beta1 * torch.pow(f32(group["gamma"]), t - 1.0)
        torch._foreach_mul_(mus, beta1_t)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - beta1_t))
        torch._foreach_mul_(nus, beta2)
        torch._foreach_add_(
            nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - beta2))
        mu_hat = torch._foreach_div(mus, 1.0 - torch.pow(beta1, t))
        nu_hat = torch._foreach_div(nus, 1.0 - torch.pow(f32(beta2), t))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, group["eps"])
        group["count"] = t + 1.0
        return torch._foreach_div(mu_hat, denom)


class ReferenceRMSProp(_DirectionOptimizer):
    """Reference RMSProp (optimizer.py:92-116): ms = decay * ms + (1 -
    decay) * g^2, u = g / max(sqrt(ms), eps): the rms floored, not fuzzed."""

    def __init__(self, params, lr: float = 0.001, decay: float = 0.9,
                 eps: float = 0.01):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    SLOTS = ("ms",)

    def _direction(self, group, params, grads):
        ms = [self.state[p]["ms"] for p in params]
        torch._foreach_mul_(ms, group["decay"])
        torch._foreach_add_(
            ms, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                   1.0 - group["decay"]))
        rms = torch._foreach_clamp_min(torch._foreach_sqrt(ms), group["eps"])
        return torch._foreach_div(grads, rms)


class SGDMomentum(_DirectionOptimizer):
    """optax.trace(decay=momentum): trace = g + momentum * trace, u = trace."""

    def __init__(self, params, lr: float = 0.001, momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    SLOTS = ("trace",)

    def _direction(self, group, params, grads):
        traces = [self.state[p]["trace"] for p in params]
        torch._foreach_mul_(traces, group["momentum"])
        torch._foreach_add_(traces, grads)  # g + decay * trace
        return [t.clone() for t in traces]


def make_optimizer(kind: str, params, lr: float = 0.0, momentum: float = 0.9,
                   weight_decay: float = 0.0) -> _DirectionOptimizer:
    """Optimizer by the JAX package's name; the trainer sets ``lr`` per
    epoch from ``lr_of_ep``.  Weight decay is Adam's only."""
    if kind == "adam":
        return ReferenceAdam(params, lr=lr, weight_decay=weight_decay)
    if weight_decay:
        raise ValueError(f"weight_decay is Adam's only, not {kind!r}'s")
    if kind == "rmsprop":
        return ReferenceRMSProp(params, lr=lr)
    if kind == "sgd_momentum":
        return SGDMomentum(params, lr=lr, momentum=momentum)
    raise ValueError(f"unknown optimizer {kind!r}")
