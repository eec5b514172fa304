"""The plain reference of A2J's training step: the network, the anchors'
vote, the loss, the targets through the crop transform and the camera,
Adam with its weight decay, and ``follow``: the reference's steps from the
same weights, Adam state, rows and augmentation draws as the program's,
augmented by ``reference/geometry.py``.  Nothing here imports the program.

Written from the paper (Xiong et al., "A2J: Anchor-to-Joint Regression
Network for 3D Articulated Pose Estimation from a Single Depth Image", ICCV
2019) and the authors' release github.com/zhangboshen/A2J (src/model.py,
src/anchor.py, src/nyu.py).  Float32, convolutions with TF32 off
(``plain_float32``).  Its departures from the release:

- layer4 of the ResNet-50 runs at stride 1 with dilation 2 in its three
  blocks, so that both heads read an H/16 map (11x11 at 176x176);
- every convolution is He-normal and the heads' biases are 0 (no ImageNet
  weights); BatchNorm starts at weight 1, bias 0;
- the depth target is the joint's z less the CoM's, in mm, and the crop is
  the port's [-1, 1] of the cube's depth range, not the release's
  standardized depth;
- the crop is mirrored along its width for a right hand (``MIRROR_DIM``),
  as the crop regressors' is;
- the loss's three terms are each a smooth L1 at beta 1, means over the
  joints (and both in-plane coordinates), then over the batch;
- the decode and the loss run over the batch at once (the release loops
  over its samples);
- Adam is deep-prior-pp's (``reference/nets.py``) with the coupled L2 term
  g + weight_decay p, where the release uses ``torch.optim.Adam``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_torch.reference import geometry as G
from bench_torch.reference import nets
from bench_torch.reference.nets import plain_float32
from bench_torch.reference.v2v import augmented_frame

BN_EPS = 1e-5
STRIDE = 16
OFFSETS = (2.0, 6.0, 10.0, 14.0)  # the anchors' rows and columns inside a cell
SPATIAL_FACTOR = 0.5
REG_LOSS_FACTOR = 3.0
WEIGHT_DECAY = 1e-4
MIRROR_DIM = -1  # a right hand's (B, 1, H, W) crop is flipped along W
STAGES = ((3, 1, 1), (4, 2, 1), (6, 2, 1), (3, 1, 2))  # layer1-4: blocks, stride, dilation


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def _bn(w, p, x):
    """Training mode: the batch's mean and biased variance."""
    mean = x.mean(dim=(0, 2, 3))
    var = torch.square(x - mean[:, None, None]).mean(dim=(0, 2, 3))
    inv = torch.rsqrt(var + BN_EPS) * w[p + ".weight"]
    return (x - mean[:, None, None]) * inv[:, None, None] + w[p + ".bias"][:, None, None]


def _bottleneck(w, p, x, stride, dilation):
    h = torch.relu(_bn(w, p + ".bn1", F.conv2d(x, w[p + ".conv1.weight"])))
    h = torch.relu(_bn(w, p + ".bn2", F.conv2d(h, w[p + ".conv2.weight"], stride=stride,
                                               padding=dilation, dilation=dilation)))
    h = _bn(w, p + ".bn3", F.conv2d(h, w[p + ".conv3.weight"]))
    if p + ".down.weight" in w:
        x = _bn(w, p + ".down_bn", F.conv2d(x, w[p + ".down.weight"], stride=stride))
    return torch.relu(h + x)


def _head(w, p, x):
    for k in range(4):
        x = F.conv2d(x, w[f"{p}.convs.{k}.weight"], w[f"{p}.convs.{k}.bias"], padding=1)
        x = torch.relu(_bn(w, f"{p}.bns.{k}", x))
    return F.conv2d(x, w[p + ".out.weight"], w[p + ".out.bias"], padding=1)


def net(w, x, num_joints):
    """x (B, 1, H, W) crops -> (cls (B, N, J), reg (B, N, J, 2), dep (B, N, J)),
    BatchNorm in training mode: the dilated ResNet-50 on the crop expanded to
    three channels, then the three heads, each (B, C, H', W') map read as
    (B, W', H', C)."""
    b, _, hh, ww = x.shape
    h = F.conv2d(x.expand(b, 3, hh, ww), w["trunk.conv1.weight"], stride=2, padding=3)
    h = F.max_pool2d(torch.relu(_bn(w, "trunk.bn1", h)), 3, 2, 1)
    x3 = None
    for i, (n, stride, dilation) in enumerate(STAGES):
        for k in range(n):
            h = _bottleneck(w, f"trunk.layer{i + 1}.{k}", h, stride if k == 0 else 1, dilation)
        if i == 2:
            x3 = h
    j = num_joints

    def layout(t, *tail):
        return t.permute(0, 3, 2, 1).reshape(b, -1, *tail)

    return (layout(_head(w, "cls", x3), j), layout(_head(w, "reg", h), j, 2),
            layout(_head(w, "dep", h), j))


# ---------------------------------------------------------------------------
# the anchors, the vote, the loss
# ---------------------------------------------------------------------------
def anchors(side: int, device) -> torch.Tensor:
    """(N, 2) (row, column) crop pixels: anchor n = (w side + h) 16 + 4 i + j
    at (16 h + P[i], 16 w + P[j])."""
    rows, cols = [], []
    for wi in range(side):
        for hi in range(side):
            for pi in OFFSETS:
                for pj in OFFSETS:
                    rows.append(STRIDE * hi + pi)
                    cols.append(STRIDE * wi + pj)
    return torch.tensor([rows, cols], dtype=torch.float32, device=device).T.contiguous()


def vote(out, side: int):
    """(sum_n w_n anchor_n (B, J, 2), sum_n w_n (anchor_n + reg_n) (B, J, 2),
    sum_n w_n dep_n (B, J)), w the softmax of cls over the anchors."""
    cls, reg, dep = out
    a = anchors(side, cls.device).to(cls.dtype)
    wgt = torch.softmax(cls, dim=1)
    at = torch.einsum("bnj,nk->bjk", wgt, a)
    rc = torch.einsum("bnj,bnjk->bjk", wgt, a[None, :, None, :] + reg)
    return at, rc, torch.einsum("bnj,bnj->bj", wgt, dep)


def _sl1(d):
    a = d.abs()
    return torch.where(a <= 1.0, 0.5 * a * a, a - 0.5)


def loss(out, y, side: int):
    """mean sl1(gt - sum w anchor) + 3 (0.5 mean sl1(gt - rc) + mean sl1(gt_d - depth))."""
    at, rc, depth = vote(out, side)
    gt, gd = y[..., :2], y[..., 2]
    return _sl1(gt - at).mean() + REG_LOSS_FACTOR * (
        SPATIAL_FACTOR * _sl1(gt - rc).mean() + _sl1(gd - depth).mean())


# ---------------------------------------------------------------------------
# the targets and the joints, through the crop transform and the camera
# ---------------------------------------------------------------------------
def _through(m, u, v):
    x = (m[:, 0, 0, None] * u + m[:, 0, 1, None] * v) + m[:, 0, 2, None]
    y = (m[:, 1, 0, None] * u + m[:, 1, 1, None] * v) + m[:, 1, 2, None]
    h = (m[:, 2, 0, None] * u + m[:, 2, 1, None] * v) + m[:, 2, 2, None]
    return x / h, y / h


def targets(labels_norm, com, cube, m, cam: G.Camera):
    """(B, J, 3): (row, column) in crop pixels of each joint (labels_norm x
    cube_z / 2 about the CoM's metric position, projected, then through m)
    and its z less the CoM's, in mm."""
    c3 = cam.img_to_3d(com)
    mm = labels_norm * (cube[:, 2] / 2.0)[:, None, None] + c3[:, None, :]
    uvd = cam.three_d_to_img(mm)
    col, row = _through(m, uvd[..., 0], uvd[..., 1])
    return torch.stack([row, col, mm[..., 2] - c3[:, None, 2]], dim=-1)


def joints(out, com, m, cam: G.Camera, side: int):
    """(B, J, 3) mm about the CoM: the vote back through m^-1 and the camera."""
    _, rc, depth = vote(out, side)
    u, v = _through(G.inv3x3(m), rc[..., 1], rc[..., 0])
    xyz = cam.img_to_3d(torch.stack([u, v, com[:, None, 2] + depth], dim=-1))
    return xyz - cam.img_to_3d(com)[:, None, :]


# ---------------------------------------------------------------------------
# the training set, the optimizer, the followed steps
# ---------------------------------------------------------------------------
def training_set(cfg, depth, com, joints_mm, n, device):
    """NYU-sized training tensors from a pool of rendered frames: the plain
    crop of each at the configuration's ``input_hw`` and cube (normalized to
    [-1, 1]), tiled to ``n`` rows.  Returns a dict of crops (n, hw, hw),
    gt3d_crop (n, J, 3), com (n, 3), cube (n, 3) and m (n, 3, 3), float32 on
    ``device``."""
    cam = G.Camera.of(cfg)
    hw = int(cfg["input_hw"])
    d = torch.as_tensor(depth, device=device)
    c = torch.as_tensor(com, device=device)
    cube = torch.tensor(cfg["cube_mm"], dtype=torch.float32, device=device).expand(len(c), 3)
    crops, m = G.normalized_crop(G.clamp_depth(d)[0], c, cube, cam.fx, cam.fy, (hw, hw))
    idx = torch.arange(n, device=device) % len(c)
    return {"crops": crops[idx].contiguous(),
            "gt3d_crop": torch.as_tensor(joints_mm, device=device)[idx].contiguous(),
            "com": c[idx].contiguous(), "cube": cube[idx].contiguous(), "m": m[idx].contiguous()}


class DecayedAdam(nets.Adam):
    """``nets.Adam`` on g + weight_decay p: the L2 term coupled into the
    gradient before the moments."""

    def __init__(self, params: dict, weight_decay=WEIGHT_DECAY, state=None):
        super().__init__(params, state=state)
        self.weight_decay = weight_decay

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        super().step({k: g + self.weight_decay * self.params[k] for k, g in grads.items()}, lr)


def follow(cfg, start, data, rows, lr, aug_gen, adam_state=None, steps=3):
    """The reference's ``steps`` steps from the parameters ``start`` (by
    name; BatchNorm's statistics are left out, training mode normalizes by
    the batch) and ``adam_state`` (mu, nu, count; None: a fresh Adam).
    rows: (steps, B) index tensors; aug_gen: the augmentation generator in
    the program's state.  Returns (losses, the first step's gradients as
    Adam got them, weight decay included, the change by leaf)."""
    tr = cfg["train"]
    cam = G.Camera.of(cfg)
    side = int(cfg["input_hw"]) // STRIDE
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in start.items()
              if not k.endswith(("running_mean", "running_var"))}
    begin = {k: v.detach().clone() for k, v in params.items()}
    opt = DecayedAdam(params, weight_decay=tr["weight_decay"], state=adam_state)
    modes = tuple(tr["aug_modes"])
    losses, grad1 = [], None
    for s in range(steps):
        batch = {k: v.index_select(0, rows[s]) for k, v in data.items()}
        b, h, w = batch["crops"].shape
        with torch.no_grad():
            draws = G.sample_augment_params(aug_gen, b, len(modes), tr["sigma_com"],
                                            tr["sigma_sc"], tr["rot_range"])
            crops, labels = G.augment(draws, batch["crops"], batch["gt3d_crop"], batch["com"],
                                      batch["cube"], batch["m"], cam, modes)
            com, cube, m = augmented_frame(draws, batch["com"], batch["cube"], batch["m"], cam,
                                           modes, (h, w))
            y = targets(labels, com, cube, m, cam)
        with plain_float32():
            value = loss(net(params, crops[:, None], cfg["num_joints"]), y, side)
            grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        if grad1 is None:
            grad1 = {k: g.detach() + opt.weight_decay * params[k].detach()
                     for k, g in grads.items()}
        opt.step(grads, lr)
        losses.append(float(value.detach()))
    return losses, grad1, {k: params[k].detach() - begin[k] for k in params}


def decay_gap(got: dict, raw: dict, start: dict, weight_decay: float) -> float:
    """The weight decay a program's optimizer added at a step, against the
    reference's: got (the gradient the optimizer got, from its moments) less
    raw (the loss's gradient, ``.grad``), over weight_decay x the parameters
    at the step's start, as one gap over the whole model, in float64.  A
    decay left out or doubled reads 1."""
    num = den = 0.0
    for k in got:
        want = weight_decay * start[k].double()
        num += float(torch.sum(torch.square(got[k].double() - raw[k].double() - want)))
        den += float(torch.sum(torch.square(want)))
    return (num / den) ** 0.5
