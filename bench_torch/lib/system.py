"""The system under test, built from a seed: the port's networks with weights
the benchmark draws itself on the device, and the drawn PCA basis.

The program's modules give only the layout (the state dicts' names and
shapes); every value is the benchmark's, so the plain reference gets the
same weights without taking anything the program made.
"""

from __future__ import annotations

import numpy as np
import torch

# independent random streams of one run, each derived from (seed, stream)
STREAMS = {"pose_net": 1, "refiner_net": 2, "pca": 3, "frames": 4, "schedule": 5,
           "sample": 6, "train": 7, "follow": 8}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def compute_dtype(precision: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]


def _program_net(spec: dict, dtype: torch.dtype):
    """The port's network of ``spec`` (a configuration's model entry),
    made on the meta device: a layout without values."""
    from deepprior_tpu_torch.models import (PoseRegNet, PoseRegNetConfig, ResNet,
                                            ResNetConfig, ScaleNet, ScaleNetConfig)

    family, out = spec["family"], spec["out_dim"]
    with torch.device("meta"):
        if family == "poseregnet":
            return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=out, hidden=spec["hidden"],
                                               dropout=spec["dropout"], dtype=dtype))
        if family == "resnet":
            return ResNet(ResNetConfig(num_joints=1, n_dims=out, depth=spec["depth"],
                                       stages=tuple(spec["stages"]), hidden=spec["hidden"],
                                       dropout=spec["dropout"], dtype=dtype))
        if family == "scalenet":
            return ScaleNet(ScaleNetConfig(num_joints=1, n_dims=out, hidden=spec["hidden"],
                                           dropout=spec["dropout"], dtype=dtype))
    raise ValueError(f"unknown model family {family!r}")


def draw_weights(layout: dict, seed: int, device) -> dict:
    """Weights for a state-dict ``layout`` (name -> tensor of its shape), drawn
    in one call on ``device`` from ``seed``: He-normal for every kernel of
    two or more dimensions (std sqrt(2 / fan_in)), zero biases, BatchNorm
    scales 1 and statistics 0 / 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kernels = {k: v.shape for k, v in layout.items() if v.dim() >= 2}
    total = sum(int(np.prod(s)) for s in kernels.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, t in layout.items():
        shape = tuple(t.shape)
        if name in kernels:
            n = int(np.prod(shape))
            fan_in = n // shape[0]
            out[name] = (flat[at:at + n] * float(np.sqrt(2.0 / fan_in))).reshape(shape)
            at += n
        elif name.endswith("running_var") or (name.endswith("weight") and t.dim() == 1):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def program_net(spec: dict, weights: dict, precision: str, device):
    """The port's network of ``spec`` on ``device`` holding a copy of
    ``weights``, computing in ``precision``."""
    net = _program_net(spec, compute_dtype(precision)).to_empty(device=device)
    net.load_state_dict(weights)
    return net


def net_weights(spec: dict, seed: int, stream: str, device) -> dict:
    """The benchmark's weights of the network ``spec`` for run ``seed``."""
    layout = _program_net(spec, torch.float32).state_dict()
    return draw_weights(layout, stream_seed(seed, stream), device)


def pca_basis(cfg: dict, seed: int, device):
    """A drawn PCA prior: (components (K, J*3) with orthonormal rows, mean
    (J*3,)), float32 on ``device``."""
    k, d = cfg["pca"]["components"], cfg["pca"]["pose_dim"]
    r = rng(seed, "pca")
    q, _ = np.linalg.qr(r.standard_normal((d, k)))
    mean = r.normal(0.0, 0.1, d)
    return (torch.as_tensor(q.T, dtype=torch.float32, device=device),
            torch.as_tensor(mean, dtype=torch.float32, device=device))


def program_camera(cfg: dict):
    from deepprior_tpu_torch.camera import Camera

    c = cfg["camera"]
    return Camera(c["fx"], c["fy"], c["ux"], c["uy"], c["flip_y"], c["width"], c["height"])


def program_prior(components, mean):
    from deepprior_tpu_torch.prior import PCAPrior

    return PCAPrior(components.clone(), mean.clone())
