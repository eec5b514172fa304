"""Weight conversion from the JAX package's flax variable trees.

``state_dict_from_flax`` is the one entry: it reads the model family off
the tree and returns the port's state dict for it."""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _nhwc_rows_to_nchw(kernel: np.ndarray, c: int) -> np.ndarray:
    """Reorder a Dense kernel's input rows from flax's NHWC flatten order
    ((h*W + w)*C + c) to the NCHW flatten order (c*H*W + h*W + w)."""
    rows = kernel.shape[0]
    hw = rows // c
    side = math.isqrt(hw)
    if c * side * side != rows:
        raise ValueError(
            f"first Dense has {rows} input rows, not C*H*H for C={c}"
        )
    return kernel.reshape(side, side, c, -1).transpose(2, 0, 1, 3).reshape(rows, -1)


def poseregnet_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``PoseRegNet`` ``variables["params"]`` (numpy leaves) ->
    ``state_dict`` of deepprior_tpu_torch.models.PoseRegNet.

    Names: ConvPool_{0,1,2}/Conv_0/{kernel,bias},
    MLPHead_0/Dense_{i}/{kernel,bias} and, for a learned-parameter
    activation, MLPHead_0/c{0,1}.  Conv kernels go HWIO -> OIHW; Dense
    kernels (in, out) -> (out, in), the first one's rows permuted from the
    NHWC flatten order to the NCHW one.
    """
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.tensor(np.asarray(arr, np.float32))  # a copy

    n_conv = len([k for k in params if k.startswith("ConvPool_")])
    for i in range(n_conv):
        conv = params[f"ConvPool_{i}"]["Conv_0"]
        put(f"convs.{i}.conv.weight", np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        put(f"convs.{i}.conv.bias", conv["bias"])
    last_c = np.asarray(params[f"ConvPool_{n_conv - 1}"]["Conv_0"]["kernel"]).shape[-1]

    head = params["MLPHead_0"]
    dense = sorted((k for k in head if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    for i, k in enumerate(dense):
        kern = np.asarray(head[k]["kernel"])
        if i == 0:
            kern = _nhwc_rows_to_nchw(kern, last_c)
        put(f"head.dense.{i}.weight", kern.T)
        put(f"head.dense.{i}.bias", head[k]["bias"])
    for c in ("c0", "c1"):
        if c in head:
            put(f"head.{c}", head[c])
    return sd


def _conv_from_flax(sd, prefix, conv) -> None:
    """A flax Conv's {kernel (HWIO), bias} as the torch Conv2d ``prefix``'s
    OIHW weight and bias."""
    sd[f"{prefix}.weight"] = torch.tensor(
        np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = torch.tensor(np.asarray(conv["bias"], np.float32))


def scalenet_state_dict_from_flax(params: Dict[str, Any], resize_factor: int = 2,
                                  input_hw: int = 128) -> Dict[str, torch.Tensor]:
    """flax ``ScaleNet`` ``variables["params"]`` (numpy leaves) ->
    ``state_dict`` of deepprior_tpu_torch.models.ScaleNet.

    Names: separate towers _Tower_{t}/ConvPool_{i}/Conv_0/{kernel,bias},
    shared ones _SharedConvTowers_0/shared_conv_{i}/{kernel,bias}, and
    MLPHead_0/Dense_{i}.  The head's first Dense reads the concatenation of
    the three flattened towers (968 + 968 + 512 rows at 128x128 input, from
    8 x 11 x 11, 8 x 11 x 11 and 8 x 8 x 8 maps), so its rows go from the
    NHWC to the NCHW flatten order block by block; one permutation of the
    whole matrix would mix the towers.
    """
    from deepprior_tpu_torch.models.scalenet import FEATURES, tower_sides

    sd: Dict[str, torch.Tensor] = {}
    if "_SharedConvTowers_0" in params:
        shared = params["_SharedConvTowers_0"]
        for i in range(len(shared)):
            _conv_from_flax(sd, f"towers.layers.{i}.conv", shared[f"shared_conv_{i}"])
    else:
        for t in range(3):
            tower = params[f"_Tower_{t}"]
            for i in range(len(tower)):
                _conv_from_flax(sd, f"towers.{t}.layers.{i}.conv",
                                tower[f"ConvPool_{i}"]["Conv_0"])
    head = params["MLPHead_0"]
    dense = sorted((k for k in head if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    for i, k in enumerate(dense):
        kern = np.asarray(head[k]["kernel"], np.float32)
        if i == 0:
            blocks, start = [], 0
            for side in tower_sides(input_hw, resize_factor):
                rows = FEATURES * side * side
                blocks.append(_nhwc_rows_to_nchw(kern[start:start + rows], FEATURES))
                start += rows
            if start != kern.shape[0]:
                raise ValueError(
                    f"first Dense has {kern.shape[0]} input rows, the towers "
                    f"give {start} at {input_hw}x{input_hw}"
                )
            kern = np.concatenate(blocks)
        sd[f"head.dense.{i}.weight"] = torch.tensor(kern.T.copy())
        sd[f"head.dense.{i}.bias"] = torch.tensor(np.asarray(head[k]["bias"], np.float32))
    return sd


def _batchnorm_from_flax(sd, prefix, params, stats) -> None:
    """A flax BatchNorm's {scale, bias} and {mean, var} as a
    ``layers.BatchNorm``'s weight, bias and running statistics."""
    for name, arr in (("weight", params["scale"]), ("bias", params["bias"]),
                      ("running_mean", stats["mean"]), ("running_var", stats["var"])):
        sd[f"{prefix}.{name}"] = torch.tensor(np.asarray(arr, np.float32))


def resnet_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``ResNet`` variables ({"params", "batch_stats"}, numpy leaves) ->
    ``state_dict`` of deepprior_tpu_torch.models.ResNet.

    flax module order: Conv_0 (the stem), _Bottleneck_{i} with
    BatchNorm_{0,1,2}, Conv_{0,1,2} and, in a projection block, Conv_3 (the
    shortcut), then BatchNorm_0 and Dense_{i}.  The first Dense's rows go
    from the NHWC to the NCHW flatten order.
    """
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv_from_flax(sd, "stem", params["Conv_0"])
    i = 0
    while f"_Bottleneck_{i}" in params:
        bp, bs = params[f"_Bottleneck_{i}"], stats[f"_Bottleneck_{i}"]
        for j in range(3):
            _batchnorm_from_flax(sd, f"blocks.{i}.bn{j}", bp[f"BatchNorm_{j}"],
                                 bs[f"BatchNorm_{j}"])
            _conv_from_flax(sd, f"blocks.{i}.conv{j}", bp[f"Conv_{j}"])
        if "Conv_3" in bp:
            _conv_from_flax(sd, f"blocks.{i}.shortcut", bp["Conv_3"])
        i += 1
    _batchnorm_from_flax(sd, "bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    last_c = np.asarray(params["BatchNorm_0"]["scale"]).shape[0]
    i = 0
    while f"Dense_{i}" in params:
        kern = np.asarray(params[f"Dense_{i}"]["kernel"], np.float32)
        if i == 0:
            kern = _nhwc_rows_to_nchw(kern, last_c)
        sd[f"head.dense.{i}.weight"] = torch.tensor(kern.T.copy())
        sd[f"head.dense.{i}.bias"] = torch.tensor(
            np.asarray(params[f"Dense_{i}"]["bias"], np.float32))
        i += 1
    return sd


def flax_family(params: Dict[str, Any]) -> str:
    """'poseregnet', 'resnet' or 'scalenet', read off a flax
    ``variables["params"]`` tree's top-level module names."""
    if "_Bottleneck_0" in params:
        return "resnet"
    if "_Tower_0" in params or "_SharedConvTowers_0" in params:
        return "scalenet"
    if "ConvPool_0" in params:
        return "poseregnet"
    raise ValueError(f"no model family has the flax modules {sorted(params)}")


def state_dict_from_flax(variables: Dict[str, Any]) -> Tuple[str, Dict[str, torch.Tensor]]:
    """flax variables ({"params"} and, for a ResNet, {"batch_stats"}; numpy
    leaves) -> (family, the port model's state dict), the family from
    ``flax_family``."""
    family = flax_family(variables["params"])
    if family == "resnet":
        return family, resnet_state_dict_from_flax(variables)
    if family == "scalenet":
        return family, scalenet_state_dict_from_flax(variables["params"])
    return family, poseregnet_state_dict_from_flax(variables["params"])


def train_state_from_flax(trainer, params: Dict[str, Any], batch_stats=None):
    """A port ``TrainState`` that starts from a flax model's parameters (e.g.
    the JAX ``TrainState.params``, and for a ResNet its ``batch_stats``),
    with the fresh optimizer state the JAX ``init_state`` gives: zero
    moments, count 1.  The family is read off the tree (``flax_family``)."""
    _, sd = state_dict_from_flax({"params": params, "batch_stats": batch_stats})
    return trainer.init_state(state_dict=sd)
