"""The distributed trainer: data-parallel batches, the crop height split
over 'sp' and tensor-parallel FC layers over a DeviceMesh (counterpart of
deepprior_tpu/parallel/train_dist.py).

Every rank runs ``Trainer``'s loop on its rows of each global batch, and the
run computes what one device computes on the whole batch:

- the same batches: every rank draws the epoch's order from the same seed
  and takes its block of B / dp rows of each global batch (``_take``);
- the same draws: the augmentation's (mode, offset, rotation, scale) and
  the dropout masks are drawn for the global batch from the epoch's
  generators, as one device draws them, and each rank keeps its rows (and
  under tp its columns of a column-parallel layer's features); K5 then
  warps the local rows;
- the same gradient: after backward the gradients are summed over the data
  axes in one bucketed all-reduce and divided by their size, and the
  optimizer (train/optimizer.py) runs unchanged on every rank;
- the same BatchNorm: the statistics are the global batch's
  (models/layers.py::BatchNorm.groups), the running statistics equal on
  every rank;
- tp: the Dense layers ``param_shardings`` picks hold this rank's block,
  Megatron-style (models/layers.py::MLPHead.split); the optimizer's moments
  are made from those blocks, so they share their placement;
- sp: every sp rank of one data index runs K5 on the same rows at full
  height and its trunk computes one block of rows of each map
  (parallel/spatial.py; the first conv reads its rows and halo from the
  whole warped crop); the trunk's gradients (convolutions, BatchNorm) are
  then partial sums over sp, the head's whole and equal on every sp rank,
  so in the one bucketed all-reduce over dp x sp the head's are scaled by
  1 / sp first; BatchNorm's statistics run over dp x sp.

Evaluation and prediction split each batch the same way and gather the rows
back, so every rank reports the single-device numbers.  At world size 1 the
step is ``Trainer``'s plus one all-reduce of the gradients over a group of
one, and BatchNorm stays one ``F.batch_norm``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.models.layers import BatchNorm
from deepprior_tpu_torch.ops.augment import sample_augment_params
from deepprior_tpu_torch.parallel.collectives import (
    all_gather_dim, all_gather_rows, reduce_from_group)
from deepprior_tpu_torch.parallel.mesh import (
    axis_size, data_groups, data_rank, param_shardings, replicated, shard_model,
    unshard_model)
from deepprior_tpu_torch.parallel.spatial import SpatialContext, attach
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.train.optimizer import make_optimizer
from deepprior_tpu_torch.train.trainer import (
    TrainConfig, TrainData, Trainer, TrainState, _l2_penalty)


class ShardedTrainData:
    """A training set split over the data-parallel ranks: this rank holds
    ``shard``, its block of ``n / dp`` rows (the set padded to a multiple
    of dp by wrap-around repeats of its first rows).  ``take`` rebuilds
    any global batch from every rank's rows."""

    def __init__(self, shard: TrainData, n: int, index: int, groups):
        self.shard, self.n, self._index, self._groups = shard, n, index, groups

    def to(self, device) -> "ShardedTrainData":
        return self

    def take(self, idx: torch.Tensor):
        """The global batch ``idx``: each rank fills the rows it holds, and
        one all-reduce over the data axes (one buffer for every field)
        joins them; a row comes from exactly one rank, so the sum is exact."""
        per = self.shard.n
        local = idx - self._index * per
        mine = (local >= 0) & (local < per)
        rows = self.shard.take(local.clamp(0, per - 1))
        flat = torch.cat([torch.where(mine.view((-1,) + (1,) * (v.dim() - 1)), v, 0.0)
                          .reshape(-1) for v in rows.values()])
        for g in self._groups:
            dist.all_reduce(flat, group=g)
        out, o = {}, 0
        for k, v in rows.items():
            out[k] = flat[o:o + v.numel()].view(v.shape)
            o += v.numel()
        return out


class DistributedTrainer(Trainer):
    """``Trainer`` over ``mesh`` (parallel/mesh.py::make_mesh), one rank per
    device: ``device`` defaults to the model's."""

    def __init__(
        self,
        model,
        cfg: TrainConfig,
        camera: Camera,
        mesh,
        prior: Optional[PCAPrior] = None,
        device=None,
    ):
        super().__init__(model, cfg, camera, prior=prior, device=device)
        self.mesh = mesh
        self.data_groups = data_groups(mesh)
        self.data_index, self.n_data = data_rank(mesh)
        if cfg.batch_size % self.n_data:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the data-parallel "
                f"size {self.n_data}")
        self.local_batch = cfg.batch_size // self.n_data
        self.row0 = self.data_index * self.local_batch
        self.tp = axis_size(mesh, "tp")
        self.tp_group = mesh.get_group("tp") if self.tp > 1 else None
        self.tp_rank = mesh.get_local_rank("tp") if self.tp > 1 else 0
        sp = axis_size(mesh, "sp")
        self.spatial = (SpatialContext(mesh.get_group("sp"), mesh.get_local_rank("sp"), sp)
                        if sp > 1 else None)
        self.layout = {}  # parameter name -> the dim it is split along

    # ------------------------------------------------------------------
    def _shard(self):
        """Split the model as the mesh says: the tp plan, the dropout rows,
        the sp plan, BatchNorm's groups.  Nothing to split on a world of one."""
        model = self.model
        if self.tp > 1 or self.n_data > 1:
            self.layout = shard_model(model, param_shardings(model, self.mesh),
                                      self.tp_group, self.tp_rank, self.tp,
                                      self.row0, self.cfg.batch_size)
        groups = self.data_groups if self.n_data > 1 else ()
        if self.spatial is not None:
            attach(model, self.spatial)
            groups = groups + (self.spatial.group,)
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.groups = groups

    def _unshard(self):
        if self.layout:
            unshard_model(self.model, self.layout, self.tp_group)
            self.layout = {}

    def init_state(self, example_crops=None, state_dict=None) -> TrainState:
        """``Trainer.init_state`` on every rank (the same seed: the same
        whole weights), then the split: the tp layers keep their blocks,
        BatchNorm's buffers stay whole, and the optimizer's moments are
        made from the blocks."""
        self._unshard()
        state = super().init_state(example_crops, state_dict)
        self._shard()
        state.optimizer = make_optimizer(self.cfg.optimizer, self.model.parameters(),
                                         lr=self.cfg.learning_rate,
                                         momentum=self.cfg.momentum)
        return state

    # ------------------------------------------------------------------
    def _rows(self, t):
        return t[self.row0:self.row0 + self.local_batch]

    def _take(self, data, idx):
        if isinstance(data, ShardedTrainData):
            return {k: self._rows(v) for k, v in data.take(idx).items()}
        return data.take(self._rows(idx))

    def _train_step_core(self, state, batch, aug, drop_generator, lr):
        """``batch`` holds this rank's rows; ``aug``, a generator, draws the
        global batch's augmentation, of which this rank keeps its rows."""
        cfg = self.cfg
        if cfg.aug_modes and not isinstance(aug, (tuple, list)):
            drawn = sample_augment_params(aug, cfg.batch_size, len(cfg.aug_modes),
                                          cfg.sigma_com, cfg.sigma_sc, cfg.rot_range,
                                          device=self.device)
            aug = tuple(self._rows(p) for p in drawn)
        return super()._train_step_core(state, batch, aug, drop_generator, lr)

    def _head_ids(self, model):
        """The head's parameters: whole on every sp rank."""
        return {id(p) for p in model.head.parameters()}

    def _penalty(self, model):
        """The L2 sum over the whole weights: the split ones' partial sums
        summed over tp (the gradient stays each rank's block's own).  Under
        sp the trunk's gradients are summed over the sp ranks, so only sp
        rank 0 differentiates the trunk's term; every rank's value is the
        same whole sum."""
        split = [p for n, p in model.named_parameters()
                 if n in self.layout and n.endswith("weight")]
        if not split and self.spatial is None:
            return _l2_penalty(model)
        ids = {id(p) for p in split}
        const_trunk = self.spatial is not None and self.spatial.rank > 0
        head = self._head_ids(model)

        def sq(w):
            return torch.sum(torch.square(
                w.detach() if const_trunk and id(w) not in head else w))

        whole = sum(sq(m.weight) for m in model.modules()
                    if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
                    and id(m.weight) not in ids)
        if not split:
            return whole
        part = sum(torch.sum(torch.square(p)) for p in split)
        return whole + reduce_from_group(part, self.tp_group)

    def _reduce_grads(self, model):
        """Average the gradients over the data axes: one all-reduce of one
        flat buffer (over the data axes and sp), then the division by the
        data size.  Under sp the head's gradients, equal on every sp rank,
        are scaled by 1 / sp before the sum; the trunk's are partial sums."""
        params = [p for p in model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        groups = self.data_groups
        if self.spatial is not None:
            head, o = self._head_ids(model), 0
            for p in params:
                if id(p) in head:
                    flat[o:o + p.numel()].mul_(1.0 / self.spatial.size)
                o += p.numel()
            groups = groups + (self.spatial.group,)
        for g in groups:
            dist.all_reduce(flat, group=g)
        flat.div_(self.n_data)
        grads = [p.grad for p in params]
        o = 0
        for g in grads:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()

    def _epoch_costs(self, losses):
        """The global batch's loss of each step: the ranks' means averaged,
        in one all-reduce for the epoch."""
        costs = torch.stack(losses)
        for g in self.data_groups:
            dist.all_reduce(costs, group=g)
        return (costs / self.n_data).cpu().numpy()

    def _eval_rows(self, fn, batch):
        if batch["crops"].shape[0] % self.n_data:
            raise ValueError(f"an evaluation batch of {batch['crops'].shape[0]} rows "
                             f"does not split over {self.n_data} data-parallel ranks")
        per = batch["crops"].shape[0] // self.n_data
        mine = {k: v[self.data_index * per:(self.data_index + 1) * per]
                for k, v in batch.items()}
        return tuple(all_gather_rows(t, self.data_groups) for t in fn(mine))

    def _forward_rows(self, model, x):
        if x.shape[0] % self.n_data:
            raise ValueError(f"a prediction batch of {x.shape[0]} rows does not "
                             f"split over {self.n_data} data-parallel ranks")
        per = x.shape[0] // self.n_data
        out = model(x[self.data_index * per:(self.data_index + 1) * per])
        return all_gather_rows(out, self.data_groups)

    def _stream_indices(self, chunks):
        """Each (k, B) index chunk cut to this rank's rows: the prefetcher
        stages only those."""
        for idx in chunks:
            yield idx[:, self.row0:self.row0 + self.local_batch]

    # ------------------------------------------------------------------
    def _leaf_out(self, name, t, sharded: bool):
        """A split tensor: a ``DTensor`` of this rank's block for the sharded
        format (each rank writes its own), the whole tensor for one file."""
        if name not in self.layout:
            return t
        dim = self.layout[name]
        if sharded:
            from torch.distributed.tensor import DTensor, Shard

            placements = replicated(self.mesh)
            placements[self.mesh.mesh_dim_names.index("tp")] = Shard(dim)
            return DTensor.from_local(t.detach(), self.mesh, placements, run_check=False)
        return all_gather_dim(t.detach(), dim, self.tp_group)

    def _leaf_in(self, name, t):
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            return t.to_local()
        if name in self.layout:
            return t.chunk(self.tp, self.layout[name])[self.tp_rank]
        return t

    def full_state_dict(self, state: TrainState):
        """The model's state dict with every split tensor whole (a
        collective: every rank calls it), for the serving checkpoint."""
        return {k: self._leaf_out(k, v, False) for k, v in state.model.state_dict().items()}

    # ------------------------------------------------------------------
    def place_data(self, data: TrainData, shard: bool = False):
        """The training set on this rank's device.

        shard=False (default): every rank holds all of it.  shard=True:
        this rank holds its block of N / dp rows, so the set's size scales
        with the ranks; the set is padded to a multiple of dp with
        wrap-around repeats of its first rows (the reference pads short
        macro batches so, nettrainer.py:365-413), and the padded rows join
        the epoch order.  The steps see the same global batches either way
        (``ShardedTrainData.take``), so without padding the loss trace is
        the replicated run's."""
        if not shard:
            return data.to(self.device)
        arrays = [np.asarray(x) for x in data]
        n = arrays[0].shape[0]
        pad = (-n) % self.n_data
        per = (n + pad) // self.n_data
        lo = self.data_index * per

        def block(x):
            if pad:
                x = np.concatenate([x, x[:pad]], axis=0)
            return x[lo:lo + per]

        shard_data = TrainData(*(block(x) for x in arrays)).to(self.device)
        return ShardedTrainData(shard_data, n + pad, self.data_index, self.data_groups)

    def stream_put(self, batch: dict) -> dict:
        """One host batch {name: (B, ...)}: this rank's rows on its device."""
        return {k: torch.as_tensor(np.asarray(v)[self.row0:self.row0 + self.local_batch])
                .to(self.device) for k, v in batch.items()}

    def stream_put_chunk(self, chunk: dict) -> dict:
        """One host macro chunk {name: (k, B, ...)}: this rank's rows of each
        minibatch on its device."""
        return {k: torch.as_tensor(np.asarray(v)[:, self.row0:self.row0 + self.local_batch])
                .to(self.device) for k, v in chunk.items()}

