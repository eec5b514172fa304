"""Reference-trained pickle weights as the port's ``state_dict``s
(counterpart of deepprior_tpu/utils/refweights.py).

The reference saves a net as a pickle dict (netbase.py:405-422):
  {'class': <name>, 'network': <str>,
   '<layerNum>-values': [W, b, ...params, ...params_nontrained]}
with Theano's conventions:
  * a conv W is OIHW and theano.conv2d is a TRUE convolution
    (filter_flip=True): torch's Conv2d (OIHW cross-correlation) takes the
    kernel flipped spatially and not transposed;
  * activations flatten NCHW into C*H*W rows, torch's own order, so the
    first Dense after a conv trunk keeps its rows (the JAX loader permutes
    them to flax's NHWC order);
  * a Hidden layer's W is (in, out): torch's Linear weight is W.T;
  * ConvPoolLayer adds the bias before the max-pool; max(x + b) ==
    max(x) + b, so it maps onto the port's bias-after-pool layers;
  * a BatchNorm layer stores [beta, gamma] + [mean, inv_std] with inv_std
    = 1 / sqrt(var + 1e-4) (batchnormlayer.py:141-155); the port
    normalizes by sqrt(var' + 1e-5), so var' = inv_std^-2 - 1e-5 gives the
    reference's normalization.
Nonlinearity and Dropout layers carry no parameters (empty '-values').

Supported: PoseRegNet types 0/11, ScaleNet type 1 and ResNet-47, gzip or
raw '.pkl' (e.g. the network_prior.pkl the reference mains save, its PCA
decode appended as a last linear layer).
"""

from __future__ import annotations

import gzip
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepprior_tpu_torch.models.layers import BN_EPS  # the reference's is 1e-4


def load_reference_pickle(path: str) -> Dict[int, List[np.ndarray]]:
    """Read a reference NetBase pickle -> {layerNum: [param arrays]}.

    Handles the '.gz' double format like netbase.py:417 and Python-2 era
    protocol-2 pickles (latin1 numpy decoding).  Unpickling runs code named
    in the file: load only pickles you trust."""
    opener = gzip.open if path.lower().endswith(".gz") else open
    with opener(path, "rb") as fh:
        state = pickle.load(fh, encoding="latin1")
    out: Dict[int, List[np.ndarray]] = {}
    for key, val in state.items():
        if not key.endswith("-values"):
            continue
        out[int(key.split("-")[0])] = [np.asarray(v) for v in val]
    return out


def _t(arr) -> torch.Tensor:
    # a C-order copy: a flipped 1x1 kernel counts as contiguous to
    # ascontiguousarray and keeps its negative strides
    return torch.tensor(np.array(arr, np.float32, order="C"))


def _conv_weight(theano_w) -> torch.Tensor:
    """OIHW true-convolution filter -> torch's OIHW cross-correlation."""
    return _t(np.asarray(theano_w)[:, :, ::-1, ::-1])


def _put_dense(sd, layers, nums) -> None:
    """The Hidden layers ``nums`` as ``head.dense.{i}.weight`` (W.T) and bias."""
    for i, num in enumerate(nums):
        w, b = layers[num]
        sd[f"head.dense.{i}.weight"] = _t(np.asarray(w).T)
        sd[f"head.dense.{i}.bias"] = _t(b)


def _dense_nums(layers, first: int) -> List[int]:
    """Layer numbers from ``first`` on that carry parameters: the Hidden
    layers of a head (Dropout layers carry none)."""
    return [i for i in sorted(layers) if i >= first and layers[i]]


def poseregnet_state_dict_from_reference(layers) -> Dict[str, torch.Tensor]:
    """A PoseRegNet pickle (poseregnet.py:61-101: 3 ConvPool layers, then
    Hidden/Dropout pairs and the final linear(s)) -> ``state_dict`` of
    models.PoseRegNet.  Type 0 has 3 Hidden layers, type 11 (or a
    network_prior.pkl) 4."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        w, b = layers[i]
        sd[f"convs.{i}.conv.weight"] = _conv_weight(w)
        sd[f"convs.{i}.conv.bias"] = _t(b)
    _put_dense(sd, layers, _dense_nums(layers, 3))
    return sd


def scalenet_state_dict_from_reference(layers) -> Dict[str, torch.Tensor]:
    """A ScaleNet type-1 pickle (scalenet.py:53-130: 3 towers of 3 ConvPool
    layers, then the FC head over the concatenated tower features) ->
    ``state_dict`` of models.ScaleNet with separate towers.  Each tower
    flattens NCHW before the concatenation (scalenet.py:169-175), as the
    port's towers do."""
    sd: Dict[str, torch.Tensor] = {}
    for t in range(3):
        for j in range(3):
            w, b = layers[t * 3 + j]
            sd[f"towers.{t}.layers.{j}.conv.weight"] = _conv_weight(w)
            sd[f"towers.{t}.layers.{j}.conv.bias"] = _t(b)
    _put_dense(sd, layers, _dense_nums(layers, 9))
    return sd


def resnet_state_dict_from_reference(layers, cfg=None) -> Dict[str, torch.Tensor]:
    """A ResNet-47 pickle -> ``state_dict`` of models.ResNet (``cfg``, default
    ``ResNetConfig()``, gives the stages).

    Emission order (resnet.py:196-347, res_block:349-414): the stem
    ConvPool, then per bottleneck block 3 x (BatchNorm, Nonlinearity, Conv)
    and, in a projection block, the 1x1 shortcut conv last; the final
    BatchNorm + Nonlinearity; then the Hidden/Dropout head.  A BatchNorm's
    inv_std becomes the variance inv_std^-2 - 1e-5 (in float32, as the JAX
    loader computes it)."""
    from deepprior_tpu_torch.models.resnet import ResNetConfig

    cfg = cfg or ResNetConfig()
    nums = [i for i in sorted(layers) if layers[i]]  # skip NL/Dropout
    it = iter(nums)
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix):
        w, b = layers[next(it)]
        sd[f"{prefix}.weight"] = _conv_weight(w)
        sd[f"{prefix}.bias"] = _t(b)

    def bn(prefix):
        beta, gamma, mean, inv_std = layers[next(it)]
        var = 1.0 / np.square(np.asarray(inv_std)) - BN_EPS
        for name, arr in (("weight", gamma), ("bias", beta), ("running_mean", mean),
                          ("running_var", var)):
            sd[f"{prefix}.{name}"] = _t(arr)

    conv("stem")
    c_in, i = cfg.stages[0], 0
    for width in cfg.stages[1:]:
        for _ in range(cfg.blocks_per_stage):
            for j in range(3):
                bn(f"blocks.{i}.bn{j}")
                conv(f"blocks.{i}.conv{j}")
            if c_in != width:
                conv(f"blocks.{i}.shortcut")
            c_in, i = width, i + 1
    bn("bn")
    _put_dense(sd, layers, list(it))
    return sd


def _theano_conv(weight: torch.Tensor) -> np.ndarray:
    return np.array(weight.detach().cpu().numpy()[:, :, ::-1, ::-1], order="C")


def reference_pickle_from_state_dict(state_dict: Dict[str, torch.Tensor], family: str,
                                     decode=None) -> Dict[str, Any]:
    """The inverse mapping: a port ``state_dict`` -> the reference pickle
    layout (write it with ``pickle.dump(..., protocol=2)``), for the
    round-trip tests and to hand weights to the reference.

    family: "poseregnet", "scalenet" or "resnet".  ``decode`` (a
    ``prior.PCAPrior``) appends the PCA decode as a last linear layer, as
    the reference mains save
    network_prior.pkl (main_nyu_posereg_embedding.py:148-158).  A ResNet
    BatchNorm's variance goes out as inv_std = 1 / sqrt(var + 1e-5)."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    arr = lambda k: np.ascontiguousarray(sd[k].numpy())  # noqa: E731
    layers: List[List[np.ndarray]] = []

    def conv(prefix):
        layers.append([_theano_conv(sd[f"{prefix}.weight"]), arr(f"{prefix}.bias")])

    def bn(prefix):
        # correctly rounded from float64: the float32 round trip back to the
        # variance then moves it by a few ulps only
        var = arr(f"{prefix}.running_var").astype(np.float64)
        inv_std = 1.0 / np.sqrt(var + BN_EPS)
        layers.append([arr(f"{prefix}.bias"), arr(f"{prefix}.weight"),
                       arr(f"{prefix}.running_mean"), inv_std.astype(np.float32)])
        layers.append([])  # the Nonlinearity

    if family == "poseregnet":
        for i in range(3):
            conv(f"convs.{i}.conv")
    elif family == "scalenet":
        for t in range(3):
            for j in range(3):
                conv(f"towers.{t}.layers.{j}.conv")
    elif family == "resnet":
        conv("stem")
        i = 0
        while f"blocks.{i}.conv0.weight" in sd:
            for j in range(3):
                bn(f"blocks.{i}.bn{j}")
                conv(f"blocks.{i}.conv{j}")
            if f"blocks.{i}.shortcut.weight" in sd:
                conv(f"blocks.{i}.shortcut")
            i += 1
        bn("bn")
    else:
        raise ValueError(f"unknown family {family!r}")
    dense = []
    while f"head.dense.{len(dense)}.weight" in sd:
        k = f"head.dense.{len(dense)}"
        dense.append([np.ascontiguousarray(arr(f"{k}.weight").T), arr(f"{k}.bias")])
    if decode is not None:
        dense.append([np.ascontiguousarray(decode.components.cpu().numpy()),
                      np.ascontiguousarray(decode.mean.cpu().numpy())])
    for i, d in enumerate(dense):
        layers.append(d)
        if i < 2 and i < len(dense) - 1:
            layers.append([])  # a Dropout layer
    name = {"poseregnet": "PoseRegNet", "scalenet": "ScaleNet", "resnet": "ResNet"}[family]
    state: Dict[str, Any] = {"class": name, "network": name}
    for num, vals in enumerate(layers):
        state[f"{num}-values"] = vals
    return state


def model_from_reference_pickle(path: str, family: str, dtype=None,
                                out_is_embedding: Optional[bool] = None):
    """One-call load of a reference-trained net: pickle -> (model with the
    weights, needs_prior).

    Infers the head from the pickle's dense stack instead of making the
    caller rebuild the reference ``*Params``:

    * 4 denses (1024, 1024, E, J*3): the ``network_prior.pkl`` form the mains
      save (the PCA decode appended as a linear layer), or head types
      11/1/4 with the decode: ``embedding=E``, ``num_joints=J``;
      needs_prior=False.
    * 3 denses ending in a J*3 dim: plain type-0 regression;
      needs_prior=False.
    * 3 denses ending in 30 (or any non-multiple of 3): the net emits the
      PCA embedding; needs_prior=True, and the caller decodes it through
      the matching ``prior.PCAPrior`` (no reference dataset has 10 joints,
      so 30 is unambiguous).

    A 3-dense stack ending in another multiple of 3 is ambiguous from the
    pickle alone (42 = 14 joints x 3, NYU direct regression, but also a
    valid non-default PCA size): the heuristic takes direct regression and
    warns; ``out_is_embedding=True``/``False`` decides explicitly.

    family: "poseregnet" | "resnet" (ScaleNet CoM refiners load through
    ``scalenet_state_dict_from_reference``).  Dropout layers carry no
    parameters, so the model has dropout=False; it is in eval mode, on the
    CPU, computing in ``dtype`` (default float32)."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig

    layers = load_reference_pickle(path)
    if family == "resnet":
        sd, cls, cfg_cls = resnet_state_dict_from_reference(layers), ResNet, ResNetConfig
    elif family == "poseregnet":
        sd, cls, cfg_cls = poseregnet_state_dict_from_reference(layers), PoseRegNet, \
            PoseRegNetConfig
    else:
        raise ValueError(f"unknown family {family!r}")

    sizes = []
    while f"head.dense.{len(sizes)}.bias" in sd:
        sizes.append(int(sd[f"head.dense.{len(sizes)}.bias"].shape[0]))
    out = sizes[-1]
    embedding = sizes[2] if len(sizes) >= 4 else None
    if embedding is not None:  # decode layer appended: the output is the pose
        needs_prior = False
    elif out_is_embedding is not None:
        needs_prior = bool(out_is_embedding)
        if not needs_prior and out % 3 != 0:
            # direct regression decodes as (J, 3): fail here, not later as
            # a reshape error
            raise ValueError(
                f"out_is_embedding=False is impossible: the net ends in a {out}-dim "
                f"dense, and direct regression needs a multiple-of-3 output")
    else:
        needs_prior = out % 3 != 0 or out == 30
        if not needs_prior:
            print(
                f"WARNING: {path} ends in a bare {out}-dim dense; treating it as "
                f"direct {out // 3}-joint regression. If this net was trained with "
                f"a non-default PCA size (nDims={out}), pass out_is_embedding=True "
                "and decode through its PCAPrior.")
    num_joints, n_dims = (1, out) if needs_prior else (out // 3, 3)
    cfg = cfg_cls(num_joints=num_joints, n_dims=n_dims, embedding=embedding,
                  dropout=False, dtype=dtype or torch.float32)
    model = cls(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval(), needs_prior
