"""The plain reference of V2V-PoseNet's training step, in plain PyTorch.

Written from the published description (Moon, Chang and Lee, CVPR 2018,
arXiv:1711.07399; the blocks of github.com/dragonbook/V2V-PoseNet-pytorch
src/v2v_model.py) and from the port's conventions for the grid, the
targets and the decode; it imports neither JAX nor either package of this
repository, so the machine with the card loads it by path
(``chip_smoke.py``).  Float32, convolutions with TF32 off
(``plain_float32``).

- ``net(w, x, train)``: the network as a function of a dict of weights
  named as the port's state dict names them; ``train`` normalizes by the
  batch's statistics (biased variance), else by the running ones.
- ``voxelize``, ``heatmap_targets``, ``decode_heatmaps``, ``loss``: the
  occupancy grid of a normalized crop, the joints' Gaussians, their argmax
  back to mm, and the summed squared error averaged over the batch.
- ``RMSProp``: the reference RMSProp (deep-prior-pp
  src/trainer/optimizer.py:92-116): ms = 0.9 ms + 0.1 g^2,
  p -= lr g / max(sqrt(ms), 0.01).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FRONT = ("front.0", "front.1", "front.2")  # the residual blocks after the stem


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


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def _bn(w, p, x, train):
    if train:
        mean = x.mean(dim=(0, 2, 3, 4))
        var = torch.square(x - mean[:, None, None, None]).mean(dim=(0, 2, 3, 4))
    else:
        mean, var = w[p + ".running_mean"], w[p + ".running_var"]
    inv = torch.rsqrt(var + BN_EPS) * w[p + ".weight"]
    return (x - mean[:, None, None, None]) * inv[:, None, None, None] \
        + w[p + ".bias"][:, None, None, None]


def _conv(w, p, x, padding=0):
    return F.conv3d(x, w[p + ".weight"], w[p + ".bias"], padding=padding)


def _basic(w, p, x, train, k):
    return torch.relu(_bn(w, p + ".bn", _conv(w, p + ".conv", x, (k - 1) // 2), train))


def _res(w, p, x, train):
    h = torch.relu(_bn(w, p + ".bn1", _conv(w, p + ".conv1", x, 1), train))
    h = _bn(w, p + ".bn2", _conv(w, p + ".conv2", h, 1), train)
    if p + ".skip_conv.weight" in w:
        x = _bn(w, p + ".skip_bn", _conv(w, p + ".skip_conv", x), train)
    return torch.relu(h + x)


def _up(w, p, x, train):
    h = F.conv_transpose3d(x, w[p + ".conv.weight"], w[p + ".conv.bias"], stride=2)
    return torch.relu(_bn(w, p + ".bn", h, train))


def net(w, x, train=True):
    """x (B, 1, G, G, G) -> heatmaps (B, J, G/2, G/2, G/2)."""
    h = F.max_pool3d(_basic(w, "stem", x, train, 7), 2, 2)
    for p in FRONT:
        h = _res(w, p, h, train)
    s1 = _res(w, "skip1", h, train)
    h = _res(w, "enc1", F.max_pool3d(h, 2, 2), train)
    s2 = _res(w, "skip2", h, train)
    h = _res(w, "enc2", F.max_pool3d(h, 2, 2), train)
    h = _res(w, "dec2", _res(w, "mid", h, train), train)
    h = _up(w, "up2", h, train) + s2
    h = _up(w, "up1", _res(w, "dec1", h, train), train) + s1
    h = _res(w, "back_res", h, train)
    for i in range(2):
        h = _basic(w, f"back.{i}", h, train, 1)
    return _conv(w, "out", h)


# ---------------------------------------------------------------------------
# the grid, the targets, the decode, the loss
# ---------------------------------------------------------------------------
def img_to_3d(uvd, fx, fy, ux, uy, flip_y=True):
    """(u, v, d) -> (x, y, z) mm through the pinhole camera."""
    u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    x = (u - ux) * d / torch.full_like(d, fx)
    if flip_y:
        y = (uy - v) * d / torch.full_like(d, fy)
    else:
        y = (v - uy) * d / torch.full_like(d, fy)
    return torch.stack([x, y, d], dim=-1)


def inv3x3(m):
    """Inverses of (..., 3, 3) matrices by the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = torch.ones_like(det) / det
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def edge(cube, cube_voxels):
    """A voxel's edge in mm: cube_z over the voxels across the cube."""
    z = cube[:, 2]
    return z / torch.full_like(z, float(cube_voxels))


def voxelize(crops, com, cube, m, cam, grid=88, cube_voxels=96):
    """crops (B, H, W) normalized depth, com (B, 3) (u, v, d), cube (B, 3),
    m (B, 3, 3), cam (fx, fy, ux, uy, flip_y) -> (B, G, G, G) occupancy:
    each pixel with d strictly inside (-1, 1), at z = d cube_z / 2 + c_z,
    its centre through m^-1 and the camera, marks voxel
    floor((p - c) / s + V / 2) - (V - G) / 2 where that lies in the grid."""
    b, h, w = crops.shape
    dev = crops.device
    c3 = img_to_3d(com, *cam)
    z = crops * (cube[:, 2] / 2.0)[:, None, None] + com[:, 2, None, None]
    mi = inv3x3(m)[:, :, :, None, None]
    uc = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + 0.5
    vc = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + 0.5
    x_h = (mi[:, 0, 0] * uc + mi[:, 0, 1] * vc) + mi[:, 0, 2]
    y_h = (mi[:, 1, 0] * uc + mi[:, 1, 1] * vc) + mi[:, 1, 2]
    w_h = (mi[:, 2, 0] * uc + mi[:, 2, 1] * vc) + mi[:, 2, 2]
    uvd = torch.stack(torch.broadcast_tensors(x_h / w_h, y_h / w_h, z), dim=-1)
    s = edge(cube, cube_voxels)[:, None, None, None]
    rel = (img_to_3d(uvd, *cam) - c3[:, None, None, :]) / s
    ijk = (torch.floor(rel + cube_voxels / 2.0) - (cube_voxels - grid) // 2).long()
    keep = (crops > -1.0) & (crops < 1.0) & ((ijk >= 0) & (ijk < grid)).all(dim=-1)
    out = torch.zeros((b, grid, grid, grid), dtype=torch.float32, device=dev)
    for n in range(b):
        i, j, k = ijk[n][keep[n]].unbind(-1)
        out[n, i, j, k] = 1.0
    return out


def heatmap_targets(labels_norm, grid=88, cube_voxels=96, sigma=1.7):
    """labels_norm (B, J, 3) -> (B, J, G/2, G/2, G/2): exp(-|g - t|^2 /
    (2 sigma^2)) over the integer grid, t = (V/2 labels_norm + G/2 - 1) / 2."""
    n = grid // 2
    t = (labels_norm * (cube_voxels / 2.0) + (n - 1)) / 2.0
    g = torch.arange(n, dtype=torch.float32, device=labels_norm.device)
    dx = torch.square(g[:, None, None] - t[..., 0, None, None, None])
    dy = torch.square(g[None, :, None] - t[..., 1, None, None, None])
    dz = torch.square(g[None, None, :] - t[..., 2, None, None, None])
    var2 = torch.full((), 2.0 * sigma * sigma, device=labels_norm.device)
    return torch.exp(-((dx + dy) + dz) / var2)


def decode_heatmaps(heat, com3d, cube, cube_voxels=96):
    """heat (B, J, n, n, n) -> joints (B, J, 3) mm: each argmax voxel i at
    c + (2 i - (n - 1)) s."""
    b, j, n = heat.shape[:3]
    flat = torch.argmax(heat.reshape(b, j, -1), dim=-1)
    i, rest = flat // (n * n), flat % (n * n)
    ijk = torch.stack([i, rest // n, rest % n], dim=-1).float()
    return com3d[:, None, :] + (2.0 * ijk - (n - 1)) * edge(cube, cube_voxels)[:, None, None]


def loss(out, target):
    """Squared error summed over joints and voxels, mean over the batch."""
    return torch.mean(torch.sum(torch.square(out - target).reshape(out.shape[0], -1), dim=1))


class RMSProp:
    """The reference RMSProp: ms = decay ms + (1 - decay) g^2 (from zeros,
    or ``ms``), p -= lr g / max(sqrt(ms), eps)."""

    def __init__(self, params: dict, decay=0.9, eps=0.01, ms=None):
        self.params, self.decay, self.eps = params, decay, eps
        self.ms = {k: (torch.zeros_like(v) if ms is None else ms[k].float().clone())
                   for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        for k, p in self.params.items():
            g = grads[k]
            self.ms[k] = self.ms[k] * self.decay + (g * g) * (1.0 - self.decay)
            p.add_(-lr * (g / torch.clamp(torch.sqrt(self.ms[k]), min=self.eps)))
