"""The plain reference of the training step, and the comparison that decides
a training cell's ``correct``.

The reference follows three of the program's steps from the same
weights and ADAM state, on the same rows, with the same augmentation
draws and dropout masks (the same generators, in the same state, drawn in
the program's order): augment -> PCA targets -> the network in training
mode -> the summed squared error -> autograd -> the reference ADAM, in
float32 with TF32 off.  It follows the first three steps, from the drawn
weights, and three steps inside the measured window, from the state the
program had before them.

Compared, each by its worst case:
  loss_rel       the gap of each step's loss, over the reference's
  grad_norm_gap  the first gradient as the optimizer got it (from ADAM's
                 first moment before and after the first step), by leaf:
                 the gap between the two norms over the larger of the
                 reference's norm of that leaf and of the median leaf
  step_norm_gap  the parameters' change over the three steps, likewise;
                 leaves whose reference gradient is under a thousandth of
                 the median leaf's (nought but rounding) are left out
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import geometry as G
from bench_torch.reference import nets

ADAM_BETA1 = np.float32(0.9)
SMALL_GRAD = 1e-3  # of the median leaf's gradient norm: a leaf that does not move


def training_set(cfg, depth, com, joints, n, device):
    """NYU-sized training tensors from a pool of rendered frames: the
    plain crop of each (normalized to [-1, 1]), tiled to ``n`` rows.
    Returns a dict of crops (n, 128, 128), gt3d_crop (n, J, 3), com
    (n, 3), cube (n, 3) and m (n, 3, 3), float32 on ``device``."""
    cam = G.Camera.of(cfg)
    d = torch.as_tensor(depth, device=device)
    c = torch.as_tensor(com, device=device)
    cube = torch.tensor(cfg["cube_mm"], dtype=torch.float32, device=device).expand(len(c), 3)
    crops, m = G.normalized_crop(G.clamp_depth(d)[0], c, cube, cam.fx, cam.fy)
    idx = torch.arange(n, device=device) % len(c)
    return {"crops": crops[idx].contiguous(),
            "gt3d_crop": torch.as_tensor(joints, device=device)[idx].contiguous(),
            "com": c[idx].contiguous(), "cube": cube[idx].contiguous(), "m": m[idx].contiguous()}


def generators(device, seeds=None, states=None):
    """The (augmentation, dropout) generators, seeded with ``seeds`` or set
    to ``states``, the program's generators' states at a step."""
    gens = [torch.Generator(device=device) for _ in range(2)]
    for i, g in enumerate(gens):
        if states is not None:
            g.set_state(states[i])
        else:
            g.manual_seed(int(seeds[i]))
    return gens


def follow(cfg, start, comp, mean, data, rows, lr, gens, adam_state=None, steps=3):
    """The reference's ``steps`` steps from the parameters ``start`` (by
    name; BatchNorm statistics are left out, training mode normalizes by
    the batch) and ``adam_state`` (mu, nu, count; None for a fresh ADAM).
    rows: (steps, B) index tensors; gens: from ``generators``.  Returns
    (losses, first gradients by leaf, the change by leaf)."""
    tr = cfg["train"]
    family = cfg["model"]["family"]
    cam = G.Camera.of(cfg)
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in start.items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    begin = {k: v.detach().clone() for k, v in params.items()}
    aug_gen, drop_gen = gens
    adam = nets.Adam(params, state=adam_state)
    modes = tuple(tr["aug_modes"])
    kw = {"train": True} if family == "resnet" else {}
    losses, grad1 = [], None
    for s in range(steps):
        batch = {k: v.index_select(0, rows[s]) for k, v in data.items()}
        b = batch["crops"].shape[0]
        with torch.no_grad():
            draws = G.sample_augment_params(aug_gen, b, len(modes), tr["sigma_com"],
                                            tr["sigma_sc"], tr["rot_range"])
            crops, labels = G.augment(draws, batch["crops"], batch["gt3d_crop"], batch["com"],
                                      batch["cube"], batch["m"], cam, modes)
            y = nets.pca_encode(labels.reshape(b, -1), comp, mean)
        with nets.plain_float32():
            out = nets.NETS[family](params, crops[:, None], drop_gen, **kw)
            loss = torch.mean(torch.sum(torch.square(out - y), dim=1))
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(grads, lr)
        losses.append(float(loss.detach()))
    delta = {k: (params[k].detach() - begin[k]) for k in params}
    return losses, grad1, delta


def gradient_from_moments(mu0: dict, mu1: dict) -> dict:
    """The gradient ADAM got at a step, from its first moment before
    (``mu0``) and after (``mu1``) it: (mu1 - beta1 mu0) / (1 - beta1), with
    the program's float32 coefficients, worked in float64."""
    b1 = float(ADAM_BETA1)
    one_minus = float(np.float32(1.0) - ADAM_BETA1)
    return {k: (mu1[k].double() - b1 * mu0[k].double()) / one_minus for k in mu1}


def _norms(tree: dict, names) -> dict:
    return {k: float(torch.linalg.vector_norm(tree[k].double())) for k in names}


def _leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """By leaf: |norm(prog) - norm(ref)| over the larger of the reference's
    norm of that leaf and of the median leaf."""
    rn, pn = _norms(ref, names), _norms(prog, names)
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}


def _median_leaf(ref: dict, names) -> str:
    rn = _norms(ref, names)
    order = sorted(names, key=rn.get)
    return order[len(order) // 2]


def compare(prog_losses, prog_g1, prog_delta, ref_losses, ref_grad1, ref_delta) -> dict:
    """The readings, from the program's (losses, the first step's gradient
    from ``gradient_from_moments``, the change after the steps) and the
    reference's: the worst case of each, and the steadier first loss and
    median leaf."""
    rel = [abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses)]
    gn = _norms(ref_grad1, ref_grad1)
    med = float(np.median(list(gn.values())))
    moving = [k for k, v in gn.items() if v >= SMALL_GRAD * med]
    grad = _leaf_gaps(prog_g1, ref_grad1, list(ref_grad1))
    flips = sum(int((torch.sign(prog_g1[k]) * torch.sign(ref_grad1[k].double()) < 0).sum())
                for k in ref_grad1)
    size = sum(v.numel() for v in ref_grad1.values())
    step = _leaf_gaps(prog_delta, ref_delta, moving)
    return {"loss_rel": max(rel), "loss1_rel": rel[0],
            "grad_norm_gap": max(grad.values()), "step_norm_gap": max(step.values()),
            "grad_median_leaf_gap": grad[_median_leaf(ref_grad1, list(ref_grad1))],
            "step_median_leaf_gap": step[_median_leaf(ref_delta, moving)],
            # the share of weights whose first gradient has the other sign:
            # ADAM's first steps move each by the same lr whatever its size
            "grad_sign_flip_share": flips / size}
