"""The plain reference's networks: PoseRegNet type 0, ResNet-47 (DeepPrior++'s
pre-activation bottleneck ResNet) and ScaleNet type 1, each a function of
a dict of weights named as the port's state dicts name them, in float32,
plus the PCA decode and the reference ADAM.

Written from the published descriptions (deep-prior-pp src/net/poseregnet.py,
resnet.py, scalenet.py, trainer/optimizer.py) in plain PyTorch; nothing
here imports the program.  The convolutions and products run with TF32 off
(``plain_float32``), as the configurations state.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

DROPOUT_KEEP = 0.7  # dropout rate 0.3
BN_EPS = 1e-5
SCALENET_POOLS = ((4, 2, 1), (2, 2, 1), (2, 1, 1))


@contextlib.contextmanager
def plain_float32():
    """cuDNN's convolutions and cuBLAS's products in float32, not TF32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(cudnn, "conv", None)
    if hasattr(matmul, "fp32_precision") and hasattr(conv, "fp32_precision"):
        switches, off = ((conv, "fp32_precision"), (matmul, "fp32_precision")), "ieee"
    else:
        switches, off = ((cudnn, "allow_tf32"), (matmul, "allow_tf32")), False
    saved = [getattr(o, a) for o, a in switches]
    for o, a in switches:
        setattr(o, a, off)
    try:
        yield
    finally:
        for (o, a), v in zip(switches, saved):
            setattr(o, a, v)


def _dropout(x, generator):
    """Inverted dropout; the mask is drawn as the program draws it."""
    if generator is None:
        return x
    keep = torch.empty_like(x).bernoulli_(DROPOUT_KEEP, generator=generator)
    divisor = torch.full((), DROPOUT_KEEP, dtype=x.dtype, device=x.device)
    return torch.where(keep.bool(), x / divisor, 0.0)


def head(w, x, generator=None):
    """FC1024 - ReLU - dropout - FC1024 - ReLU - dropout - FC(out).
    ``generator`` None is evaluation (no dropout)."""
    x = x.reshape(x.shape[0], -1)
    n = sum(1 for k in w if k.startswith("head.dense.") and k.endswith(".weight"))
    for i in range(n):
        x = F.linear(x, w[f"head.dense.{i}.weight"], w[f"head.dense.{i}.bias"])
        if i < 2:
            x = _dropout(torch.relu(x), generator)
    return x


def _conv_pool(w, prefix, x, pool):
    x = F.conv2d(x, w[prefix + ".weight"], w[prefix + ".bias"])
    if pool != 1:
        x = F.max_pool2d(x, pool, pool)
    return torch.relu(x)


def poseregnet(w, x, generator=None):
    """x (B, 1, 128, 128) -> (B, out): conv 8x5x5 / pool 4, conv 8x5x5 /
    pool 2, conv 8x3x3, then the head."""
    for i, pool in enumerate((4, 2, 1)):
        x = _conv_pool(w, f"convs.{i}.conv", x, pool)
    return head(w, x, generator)


def scalenet(w, x, generator=None):
    """x (B, 1, 128, 128) -> (B, 3): three towers over the crop and its /2
    and /4 centre crops, concatenated into the head."""
    h, wd = x.shape[-2:]
    feats = []
    for t, pools in enumerate(SCALENET_POOLS):
        f = 2 ** t
        dh, dw = h // f, wd // f
        ys, xs = h // 2 - dh // 2, wd // 2 - dw // 2
        y = x[..., ys:ys + dh, xs:xs + dw]
        for layer, pool in enumerate(pools):
            y = _conv_pool(w, f"towers.{t}.layers.{layer}.conv", y, pool)
        feats.append(y.flatten(1))
    return head(w, torch.cat(feats, dim=1), generator)


def _batch_norm(w, prefix, x, train):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.square(x - mean[:, None, None]).mean(dim=(0, 2, 3))
    else:
        mean, var = w[prefix + ".running_mean"], w[prefix + ".running_var"]
    inv = torch.rsqrt(var + BN_EPS) * w[prefix + ".weight"]
    return (x - mean[:, None, None]) * inv[:, None, None] + w[prefix + ".bias"][:, None, None]


def resnet(w, x, generator=None, train=False):
    """x (B, 1, 128, 128) -> (B, out): stem conv 5x5 and pool 2, the
    pre-activation bottlenecks (a projection block, the first of each
    stage that widens, strides 2), BN-ReLU, the head.  ``train``
    normalizes by the batch's statistics."""
    x = F.max_pool2d(F.conv2d(x, w["stem.weight"], w["stem.bias"], padding=2), 2, 2)
    n = 1 + max(int(k.split(".")[1]) for k in w if k.startswith("blocks."))
    for i in range(n):
        p = f"blocks.{i}."
        proj = p + "shortcut.weight" in w
        stride = 2 if proj else 1
        pre = torch.relu(_batch_norm(w, p + "bn0", x, train))
        h = F.conv2d(pre, w[p + "conv0.weight"], w[p + "conv0.bias"], stride=stride)
        h = F.conv2d(torch.relu(_batch_norm(w, p + "bn1", h, train)),
                     w[p + "conv1.weight"], w[p + "conv1.bias"], padding=1)
        h = F.conv2d(torch.relu(_batch_norm(w, p + "bn2", h, train)),
                     w[p + "conv2.weight"], w[p + "conv2.bias"])
        short = F.conv2d(pre, w[p + "shortcut.weight"], w[p + "shortcut.bias"],
                         stride=stride) if proj else x
        x = short + h
    x = torch.relu(_batch_norm(w, "bn", x, train))
    return head(w, x, generator)


NETS = {"poseregnet": poseregnet, "resnet": resnet, "scalenet": scalenet}


def pca_decode(emb, components, mean):
    """(N, K) embeddings -> (N, J*3) poses, products summed in float32."""
    return torch.sum(emb[:, :, None] * components, dim=1) + mean


def pca_encode(poses, components, mean):
    return torch.sum((poses - mean)[:, :, None] * components.T, dim=1)


class Adam:
    """The reference ADAM (optimizer.py:58-90 of deep-prior-pp), in float32
    as the reference's float32 run computes it: the count starts at 1,
    beta1_t = beta1 * gamma^(t-1) with gamma = 1 - 1e-8, which is 1.0 in
    float32; m_hat = m / (1 - beta1^t), v_hat = v / (1 - beta2^t),
    p -= lr * m_hat / (sqrt(v_hat) + eps).  ``state`` (mu, nu, t) starts
    it from a later step's moments and count."""

    def __init__(self, params: dict, beta1=0.9, beta2=0.999, eps=1e-8, state=None):
        self.params = params
        self.beta1, self.beta2, self.eps = np.float32(beta1), np.float32(beta2), eps
        self.c2 = float(np.float32(1.0 - beta2))  # folded in float64, as the reference's graph does
        if state is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.t = 1
        else:
            mu, nu, self.t = state
            self.mu = {k: mu[k].float().clone() for k in params}
            self.nu = {k: nu[k].float().clone() for k in params}

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        # the scalars in float32, handed to torch as the floats they are
        t, b1, b2, one = np.float32(self.t), self.beta1, self.beta2, np.float32(1.0)
        c1, c2 = float(one - b1), self.c2
        h1, h2 = float(one - b1 ** t), float(one - b2 ** t)
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = float(b1) * self.mu[k] + c1 * g
            self.nu[k] = float(b2) * self.nu[k] + c2 * g * g
            m_hat = self.mu[k] / h1
            v_hat = self.nu[k] / h2
            p -= lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        self.t += 1
