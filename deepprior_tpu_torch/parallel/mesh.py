"""Device meshes and the tensor-parallel plan (counterpart of
deepprior_tpu/parallel/mesh.py).

Mesh axes:
  dp  — data parallel: the batch splits here; gradients are averaged over it
  tp  — tensor parallel: the wide FC layers split here (the conv trunks are
        small and replicate; the FC head is where the weights are: ResNet's
        16384x1024 FC1 is 97% of its parameter count)
  dcn — with slices > 1, outermost: the batch splits over ('dcn', 'dp')
        jointly and the gradient sum runs over 'dp' and then 'dcn'; tp stays
        inside a slice

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one device per rank, ranks laid out row-major as the
JAX package lays out ``jax.devices()``.  The FC split follows the Megatron
pattern: alternating column-parallel and row-parallel Linear layers, so two
consecutive layers need one all-reduce forward and one backward
(models/layers.py::MLPHead).

The 'sp' axis (the crop height sharded, with a halo exchange around every
conv and pool) is not ported: sp > 1 raises.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

SP_TODO = ("the 'sp' axis (the crop height sharded over ranks) needs a halo "
           "exchange around every conv and pool; it is not ported yet "
           "(ROADMAP.md Queue 1 item 19)")


def mesh_dims(n: int, dp: Optional[int] = None, tp: int = 1, slices: int = 1,
              sp: int = 1) -> Tuple[Tuple[str, int], ...]:
    """The (name, size) axes of a mesh over ``n`` devices, with the JAX
    package's size rules: dp defaults to what the others leave of a
    slice; 'dp' and 'tp' are always present, 'dcn' only with slices > 1."""
    if sp != 1:
        raise NotImplementedError(SP_TODO)
    assert n % slices == 0, f"{n} devices not divisible by slices={slices}"
    per_slice = n // slices
    if dp is None:
        assert per_slice % tp == 0, \
            f"{per_slice} devices/slice not divisible by tp={tp}"
        dp = per_slice // tp
    assert slices * dp * tp == n, f"slices*dp*tp={slices * dp * tp} != {n} devices"
    dims = [("dcn", slices), ("dp", dp), ("tp", tp)]
    return tuple((name, size) for name, size in dims if size > 1 or name != "dcn")


def _device_type() -> str:
    """'cpu' for a gloo-only group, else 'cuda'."""
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[Sequence[int]] = None,
    slices: int = 1,
    sp: int = 1,
) -> DeviceMesh:
    """A ('dp', 'tp') DeviceMesh — with slices > 1 ('dcn', 'dp', 'tp') —
    over ``devices``, the ranks of the process group (default: all of them,
    the first ``n_devices`` if given), on the CPU for a gloo group and on
    CUDA otherwise.  Needs an initialized process group
    (parallel/multihost.py::initialize); its world must hold every rank of
    the mesh."""
    if sp != 1:
        raise NotImplementedError(SP_TODO)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: launch with "
            "torchrun (torchrun --nproc-per-node N -m <main> ...) or call "
            "deepprior_tpu_torch.parallel.multihost.initialize first")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if n_devices is not None:
        ranks = ranks[:n_devices]
    dims = mesh_dims(len(ranks), dp, tp, slices)
    layout = torch.tensor(ranks, dtype=torch.int64).reshape([s for _, s in dims])
    return DeviceMesh(_device_type(), layout, mesh_dim_names=tuple(name for name, _ in dims))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh axes the batch splits over."""
    return ("dcn", "dp") if "dcn" in mesh.mesh_dim_names else ("dp",)


def replicated(mesh: DeviceMesh) -> list:
    """The DTensor placements of a tensor every rank holds whole."""
    return [Replicate()] * mesh.ndim


def batch_sharding(mesh: DeviceMesh) -> list:
    """The DTensor placements of a batch split along dim 0 over the batch
    axes (dcn and dp), whole along tp."""
    return [Shard(0) if name in batch_axes(mesh) else Replicate()
            for name in mesh.mesh_dim_names]


def data_groups(mesh: DeviceMesh) -> Tuple:
    """The process groups of the batch axes, innermost ('dp') first: the
    order in which ``collectives.all_gather_rows`` joins row blocks."""
    return tuple(mesh.get_group(a) for a in reversed(batch_axes(mesh)))


def data_rank(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index along the batch axes, their size)."""
    index, size = 0, 1
    for a in batch_axes(mesh):
        n = axis_size(mesh, a)
        index, size = index * n + mesh.get_local_rank(a), size * n
    return index, size


def _natural(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def param_shardings(model: nn.Module, mesh, tp_axis: str = "tp",
                    min_width: int = 512) -> Dict[str, object]:
    """The tensor-parallel plan of ``model``: within each parent module the
    ``nn.Linear`` children, in natural name order, alternate column-parallel
    and row-parallel while their widths divide the tp size (the JAX rule);
    everything else replicates.

    ``mesh`` is a DeviceMesh or the tp size.  Returns {module name:
    ``ColwiseParallel()`` or ``RowwiseParallel()``}, the plan
    ``parallelize_module`` takes; train_dist.py and serve.py apply it with
    ``shard_model``, because ``MLPHead`` calls ``F.linear`` on its layers'
    weights in its compute dtype, where ``parallelize_module``'s hooks
    would not see the call.  Empty when tp is 1."""
    tp = mesh if isinstance(mesh, int) else axis_size(mesh, tp_axis)
    plan: Dict[str, object] = {}
    if tp <= 1:
        return plan
    for parent_name, parent in model.named_modules():
        dense = sorted(((name, child) for name, child in parent.named_children()
                        if isinstance(child, nn.Linear)), key=lambda kv: _natural(kv[0]))
        col_next = True
        for name, lin in dense:
            fqn = f"{parent_name}.{name}" if parent_name else name
            if col_next and lin.out_features >= min_width and lin.out_features % tp == 0:
                plan[fqn] = ColwiseParallel()
                col_next = False
            elif not col_next and lin.in_features >= min_width and lin.in_features % tp == 0:
                plan[fqn] = RowwiseParallel()
                col_next = True
    return plan


def shard_model(model: nn.Module, plan: Dict[str, object], tp_group, tp_rank: int,
                tp_size: int, row0: int = 0, rows: Optional[int] = None) -> Dict[str, int]:
    """Apply ``param_shardings``' plan: every planned Linear keeps this
    rank's block of its weight (column-parallel: rows of the output
    features, with the bias; row-parallel: columns of the input features,
    the bias whole), and each ``MLPHead`` gets its ``HeadSplit``.  The
    weights must be whole (every rank the same) when this is called.

    Returns {parameter name: the dim it is split along}: the layout the
    trainer's checkpoints and ``unshard_model`` read."""
    from deepprior_tpu_torch.models.layers import HeadSplit, MLPHead

    layout: Dict[str, int] = {}
    styles = {}
    for fqn, style in plan.items():
        lin = model.get_submodule(fqn)
        colwise = isinstance(style, ColwiseParallel)
        if not colwise and not isinstance(style, RowwiseParallel):
            raise ValueError(f"{fqn}: unsupported parallel style {style!r}")
        with torch.no_grad():
            dim = 0 if colwise else 1
            lin.weight = nn.Parameter(lin.weight.chunk(tp_size, dim)[tp_rank].clone())
            layout[f"{fqn}.weight"] = dim
            if colwise:
                lin.bias = nn.Parameter(lin.bias.chunk(tp_size, 0)[tp_rank].clone())
                layout[f"{fqn}.bias"] = 0
        styles[id(lin)] = "colwise" if colwise else "rowwise"
    for head in model.modules():
        if isinstance(head, MLPHead):
            head_styles = tuple(styles.pop(id(lin), None) for lin in head.dense)
            if head.learned and any(head_styles):
                raise NotImplementedError(
                    "a learned activation (prelu) under tp: its per-unit "
                    "parameters would need the column split too")
            head.split = HeadSplit(head_styles, tp_group, tp_rank, tp_size, row0, rows)
    if styles:
        raise ValueError("the plan splits Linear layers outside an MLPHead")
    return layout


def unshard_model(model: nn.Module, layout: Dict[str, int], tp_group) -> None:
    """Undo ``shard_model``: every split parameter whole again (gathered
    over ``tp_group``), every ``MLPHead`` without its split."""
    from deepprior_tpu_torch.models.layers import MLPHead
    from deepprior_tpu_torch.parallel.collectives import all_gather_dim

    for name, dim in layout.items():
        mod_name, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        with torch.no_grad():
            full = all_gather_dim(getattr(mod, attr).detach(), dim, tp_group)
        setattr(mod, attr, nn.Parameter(full))
    for head in model.modules():
        if isinstance(head, MLPHead):
            head.split = None
