"""The trainer: device-resident data, augmentation and optimization.

Counterpart of deepprior_tpu/train/trainer.py (reference NetTrainer,
src/trainer/nettrainer.py:75-997).  The training set lives on the device;
each step indexes it with a device index tensor, augments on the device
(ops/augment.py: the warp kernel K5, or K4, on a CUDA device), projects
the targets through the PCA prior, runs the forward and backward pass and
the reference optimizer's update.  The losses of an epoch stay on the
device and are fetched once at its end, as the JAX epoch scan returns
them, so the host never waits for the card inside an epoch.

Loss semantics match poseregnettrainer.py:92-101:
  (B, D) targets:     sum of squared errors over D, mean over batch
  (B, J, 3) targets:  squared error summed over xyz, mean over joints,
                      mean over batch
plus optional L2 weight decay iff the model has no dropout
(poseregnettrainer.py:106-107).

The model family's choices come from ``family`` (models/family.py::
family_of, the seam the serving estimator takes too): the model itself
where it brings them (models/v2v.py::V2VPoseNet: an occupancy grid in, 3D
heatmaps out; models/a2j.py::A2J: the crop in, anchors' votes out, its
targets in crop pixels through the augmented batch's crop transform and
the camera, which the step hands ``targets``), else ``CropRegression``
(PoseRegNet, ResNet, ScaleNet: the crops in as one-channel maps, the PCA
embedding or the normalized joints out).  A family's ``inputs`` may count
into ``stats`` (V2V-PoseNet's ``voxels_set`` and ``voxels_seen``): 0-d
tensors on the device, added to once a step with no host sync; read them
after the steps.

Random draws: the epoch order from ``np.random.default_rng(cfg.seed)``
(one permutation an epoch), and one ``torch.Generator`` on the device for
the augmentation and one for the dropout masks, both seeded anew at each
epoch from (``cfg.seed``, epoch).  A run resumed at epoch k burns k
permutations and seeds epoch k's generators as the uninterrupted run did,
so it draws the same numbers; ``fit`` and ``fit_streamed`` consume the
same streams step for step, so they give the same loss trace on one
device.  A snapshot resumed on another device type restores the
parameters, BatchNorm statistics and optimizer state exactly; its draws
are then that device's generator's, which are other numbers.  The draws
are not the JAX package's keys; the parity tests feed both packages the
same augmentation draws through ``_train_step_core``.

Snapshots (``save_train_state``/``load_train_state``) hold the state dict,
the optimizer's moments and counts, the step, the epoch and the
early-stopping tracker, with the TrainConfig fingerprint: one file in the
port's checkpoint format (train/checkpoint.py), or with
``sharded_snapshots`` a directory that every rank writes its shards into
(train/checkpoint_sharded.py, async); loads take either.

``train_step`` is one step on a batch of rows, the call ``fit`` and
``fit_streamed`` make.  While spans record (utils/profiling.py) a step
records ``train.step`` around ``train.augment`` (augmentation, the
family's inputs and targets; V2V-PoseNet's record ``train.voxelize`` and
``train.targets`` inside it), ``train.forward`` (the model and the loss),
``train.backward`` (backward and ``_reduce_grads``) and
``train.optimizer`` (the update), each with the state's step number as
its ``id``.

parallel/train_dist.py::DistributedTrainer runs this loop on many ranks
through the hooks ``_take``, ``_penalty``, ``_reduce_grads``,
``_epoch_costs``, ``_eval_rows``, ``_forward_rows``, ``_stream_indices``,
``_leaf_out`` and ``_leaf_in``; on one device each is the identity.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.device import float32_compute
from deepprior_tpu_torch.models.family import family_of
from deepprior_tpu_torch.ops.augment import augment_batch
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.train.checkpoint import (
    checkpoint_keys, load_checkpoint, save_checkpoint)
from deepprior_tpu_torch.train.optimizer import lr_of_ep, make_optimizer
from deepprior_tpu_torch.train.prefetch import (
    DevicePrefetcher, aligned_epoch_indices, index_chunks)
from deepprior_tpu_torch.utils.profiling import span


class TrainConfig(NamedTuple):
    """The JAX package's TrainConfig, field for field."""

    batch_size: int = 128
    learning_rate: float = 0.001
    n_epochs: int = 100
    optimizer: str = "adam"
    momentum: float = 0.9
    weightreg_factor: float = 0.0
    aug_modes: Optional[Sequence[str]] = ("com", "rot", "none")
    sigma_com: float = 5.0
    sigma_sc: float = 0.02
    rot_range: float = 180.0
    norm_zero_one: bool = False
    # True: K5, the warp kernel that computes the augmentation geometry and
    # fuses the un/renormalization; False: K4; None = augment_batch's
    # default (K5 on a CUDA device, ops/augment.py::warp_route)
    aug_fuse_norm: Optional[bool] = None
    # the TPU warp kernel's samples per grid step; accepted, no effect
    aug_block_k: Optional[int] = None
    # warp interpolation of the augmentation recrops: 'nearest' (the
    # reference default) or 'linear' (the gather warp only)
    aug_resize: str = "nearest"
    snapshot_every: int = 5
    eval_every: int = 1  # epochs between validation-observer runs
    # sub-epoch observer cadence in minibatches (reference
    # validation_frequency, nettrainer.py:859-889); None = epoch ends only
    validation_frequency: Optional[int] = None
    use_early_stopping: bool = True
    seed: int = 23455
    model_has_dropout: bool = True  # gates weight decay (reference semantics)


class TrainData(NamedTuple):
    """Training tensors (numpy arrays on the host, or tensors after ``to``).

    crops:     (N, H, W) normalized depth crops
    gt3d_crop: (N, J, 3) CoM-centred labels in mm
    com:       (N, 3) image-coord CoM
    cube:      (N, 3) metric cubes (mm)
    m:         (N, 3, 3) crop transforms
    """

    crops: object
    gt3d_crop: object
    com: object
    cube: object
    m: object

    @classmethod
    def from_sequence(cls, seq, normalize=True, norm_zero_one=False):
        """Stack an ImageSequence as Dataset.imgStackDepthOnly does
        (reference dataset.py:72-111), keeping the tensors augmentation
        needs; the numpy normalization of the JAX package, op for op."""
        crops = np.stack([f.dpt for f in seq.data]).astype(np.float32)
        com = np.stack([f.com for f in seq.data]).astype(np.float32)
        cube = np.broadcast_to(
            np.asarray(seq.config["cube"], np.float32), (len(seq.data), 3)
        ).copy()
        m = np.stack([f.T for f in seq.data]).astype(np.float32)
        gt3d = np.stack([f.gt3Dcrop for f in seq.data]).astype(np.float32)
        if normalize:
            com_z = com[:, 2][:, None, None]
            cube_z = cube[:, 2][:, None, None]
            d = np.where(crops == 0.0, com_z + cube_z / 2.0, crops)
            if norm_zero_one:
                crops = (d - (com_z - cube_z / 2.0)) / cube_z
            else:
                crops = (d - com_z) / (cube_z / 2.0)
            crops = crops.astype(np.float32)
        return cls(crops, gt3d, com, cube, m)

    @property
    def n(self) -> int:
        return self.crops.shape[0]

    def to(self, device) -> "TrainData":
        """The same data as float32 tensors on ``device``."""
        return TrainData(*(torch.as_tensor(a, dtype=torch.float32).to(device)
                           for a in self))

    def take(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The rows ``idx`` (on the data's device) as a batch dict."""
        return {k: v.index_select(0, idx) for k, v in self._asdict().items()}


@dataclass
class TrainState:
    """What the JAX TrainState carries: the model (its parameters), the
    optimizer (its moments) and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _l2_penalty(model: nn.Module):
    """Sum of squares of the conv (2D, 3D, transposed 3D) and dense weights,
    never biases, activation slopes or BatchNorm parameters
    (convpoollayer.py:288, hiddenlayer.py:159, batchnormlayer.py:146), as
    the JAX package's "kernel" leaves."""
    total = 0.0
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            total = total + torch.sum(torch.square(mod.weight))
    return total


class Trainer:
    """Drives one model over device-resident TrainData on ``device``
    (default: the model's).  A float32 model computes in float32 within the
    trainer's steps, evaluation and prediction (``float32_compute``).
    ``weight_decay`` is Adam's coupled L2 (g + weight_decay * p before its
    moments; A2J's recipe), 0 by default; not a TrainConfig field, which is
    the JAX package's field for field."""

    def __init__(
        self,
        model: nn.Module,
        cfg: TrainConfig,
        camera: Camera,
        prior: Optional[PCAPrior] = None,
        device=None,
        weight_decay: float = 0.0,
    ):
        if cfg.aug_resize not in ("nearest", "linear"):
            raise ValueError(f"unknown aug_resize {cfg.aug_resize!r}")
        if cfg.aug_resize == "linear" and (cfg.aug_fuse_norm or cfg.aug_block_k):
            raise ValueError(
                "aug_fuse_norm and aug_block_k drive the warp kernel, which is "
                "nearest-only; unset them with aug_resize='linear'"
            )
        self.device = torch.device(
            device if device is not None else next(model.parameters()).device
        )
        self.model = model.to(self.device)
        self.cfg = cfg
        self.camera = camera
        self.prior = prior.to(self.device) if prior is not None else None
        cfg_dtype = getattr(getattr(model, "cfg", None), "dtype", torch.float32)
        self._precision = (float32_compute if cfg_dtype == torch.float32
                           else contextlib.nullcontext)
        self.history: Dict[str, list] = {"train_cost": [], "val_error_mm": []}
        # the family's inputs, targets, loss and decode: the model's own, if
        # it brings them
        self.family = family_of(model, self.prior)
        self.stats: Dict[str, torch.Tensor] = {}
        # the rolling snapshot's format: one file (train/checkpoint.py) or,
        # True, a sharded directory (train/checkpoint_sharded.py)
        self.sharded_snapshots = False
        self._sharded_ckptr = None
        self.weight_decay = weight_decay

    # ------------------------------------------------------------------
    def init_state(self, example_crops=None, state_dict=None) -> TrainState:
        """Fresh parameters drawn from ``cfg.seed`` (on the CPU, so every
        device starts from the same weights; BatchNorm statistics reset to
        0 / 1), or ``state_dict``'s, and a fresh optimizer.  example_crops is accepted for the JAX signature;
        the shapes here are static."""
        if state_dict is None:
            self.model.cpu().reset_parameters(
                torch.Generator().manual_seed(self.cfg.seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        opt = make_optimizer(self.cfg.optimizer, self.model.parameters(),
                             lr=self.cfg.learning_rate, momentum=self.cfg.momentum,
                             weight_decay=self.weight_decay)
        return TrainState(self.model, opt, 0)

    # ------------------------------------------------------------------
    def _train_step_core(self, state: TrainState, batch, aug, drop_generator,
                         lr: float):
        """The training step: augment -> targets -> forward/backward ->
        the reference optimizer's update.

        batch: dict of crops, gt3d_crop, com, cube, m tensors; aug: a
        ``torch.Generator`` for the augmentation draws, or pre-drawn
        (mode_idx, off, rot, sc); drop_generator draws the dropout masks.
        The model runs in training mode, so a ResNet's BatchNorm statistics
        update once per step, as the JAX step's new batch_stats do.
        Returns (state, loss as a 0-d tensor on the device)."""
        cfg = self.cfg
        step = state.step
        with span("train.step", id=step), self._precision():
            with span("train.augment", id=step), torch.no_grad():
                crops, gt3d, cube = batch["crops"], batch["gt3d_crop"], batch["cube"]
                com, m = batch["com"], batch["m"]
                if cfg.aug_modes:
                    params = aug if isinstance(aug, (tuple, list)) else None
                    crops, labels_norm, com, cube, m = augment_batch(
                        None if params is not None else aug,
                        crops, gt3d, com, cube, m, self.camera,
                        aug_modes=tuple(cfg.aug_modes),
                        sigma_com=cfg.sigma_com, sigma_sc=cfg.sigma_sc,
                        rot_range=cfg.rot_range, norm_zero_one=cfg.norm_zero_one,
                        fuse_norm=cfg.aug_fuse_norm, block_k=cfg.aug_block_k,
                        resize=cfg.aug_resize, params=params,
                    )
                else:
                    labels_norm = gt3d / (cube[:, 2] / 2.0)[:, None, None]
                aug_batch = {"crops": crops, "com": com, "cube": cube, "m": m}
                x = self.family.inputs(aug_batch, self.camera, step, self.stats)
                y = self.family.targets(labels_norm, step, batch=aug_batch, camera=self.camera)

            model, opt = state.model, state.optimizer
            with span("train.forward", id=step):
                model.train()
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.zero_grad(set_to_none=True)
                out = model(x, generator=drop_generator)
                loss = self.family.loss(out, y)
                if cfg.weightreg_factor > 0.0 and not cfg.model_has_dropout:
                    loss = loss + cfg.weightreg_factor * self._penalty(model)
            with span("train.backward", id=step):
                loss.backward()
                self._reduce_grads(model)
            with span("train.optimizer", id=step):
                opt.step()
        state.step += 1
        return state, loss.detach()

    def train_step(self, state: TrainState, batch, aug, drop_generator, lr: float):
        """One training step on ``batch`` (the step's rows, as ``_take``
        gives them): the public entry to ``_train_step_core``, which ``fit``
        and ``fit_streamed`` call.  Returns (state, loss as a 0-d tensor on
        the device)."""
        return self._train_step_core(state, batch, aug, drop_generator, lr)

    # the hooks of the distributed trainer; on one device, the identity
    def _take(self, data, idx):
        """The step's batch: the rows ``idx`` of the training data."""
        return data.take(idx)

    def _penalty(self, model):
        return _l2_penalty(model)

    def _reduce_grads(self, model):
        """Between backward and the optimizer: the gradients as they are."""

    def _epoch_costs(self, losses):
        """The epoch's per-step losses, fetched to the host."""
        return torch.stack(losses).cpu().numpy()

    def _eval_rows(self, fn, batch):
        """fn(batch) -> per-sample tensors, for the whole batch."""
        return fn(batch)

    def _forward_rows(self, model, x):
        return model(x)

    def _stream_indices(self, chunks):
        """fit_streamed's (k, B) index chunks, as this process stages them."""
        return chunks

    def _leaf_out(self, name, t, sharded: bool):
        """A snapshot's tensor of parameter ``name`` as it is written."""
        return t

    def _leaf_in(self, name, t):
        """A restored tensor of parameter ``name`` as the live state holds it."""
        return t

    # ------------------------------------------------------------------
    def evaluate(self, state: TrainState, data: TrainData) -> Dict[str, float]:
        """Validation observers: cost, normalized error, mm error avg/max
        (poseregnettrainer.py:122-126).  The tail batch is padded by
        repeating the last sample and the padding is masked out of every
        statistic; the sums stay on the device and four scalars are
        fetched."""
        data = data.to(self.device)
        model = state.model
        b = self.cfg.batch_size
        n = data.n
        n_steps = -(-n // b)
        idx = np.arange(n_steps * b)
        mask = torch.from_numpy(idx < n).to(self.device, torch.float32)
        idx = torch.from_numpy(np.minimum(idx, n - 1)).to(self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sum_c, sum_e, sum_d = zero, zero, zero
        max_d = torch.full((), -np.inf, dtype=torch.float32, device=self.device)
        model.eval()

        def per_sample(batch):
            """(cost, normalized error, joint distances) of each sample."""
            gt3d, half = batch["gt3d_crop"], batch["cube"][:, 2] / 2.0
            y = self.family.targets(gt3d / half[:, None, None], batch=batch, camera=self.camera)
            return self.family.rows(model(self.family.inputs(batch, self.camera)), y, batch,
                                    camera=self.camera)

        with self._precision(), torch.no_grad():
            for s in range(n_steps):
                sl = slice(s * b, (s + 1) * b)
                mk = mask[sl]
                cost_ps, err_ps, dist = self._eval_rows(per_sample, data.take(idx[sl]))
                sum_c = sum_c + torch.sum(cost_ps * mk)
                sum_e = sum_e + torch.sum(err_ps * mk)
                sum_d = sum_d + torch.sum(dist * mk[:, None])
                max_d = torch.maximum(max_d, torch.max(
                    torch.where(mk[:, None] > 0, dist, -np.inf)))
        sum_c, sum_e, sum_d, max_d = torch.stack(
            [sum_c, sum_e, sum_d, max_d]).cpu().tolist()
        nj = data.gt3d_crop.shape[1]
        return {
            "cost": sum_c / n,
            "error_norm": sum_e / n,
            "error_mm_avg": sum_d / (n * nj),
            "error_mm_max": max_d,
        }

    def predict(self, state: TrainState, crops, batch_size: Optional[int] = None):
        """Batched inference in eval mode, the tail batch padded by
        repetition (netbase.py:217-316).  Returns a numpy array."""
        model = state.model
        model.eval()
        b = batch_size or self.cfg.batch_size
        crops = torch.as_tensor(crops, dtype=torch.float32).to(self.device)
        n = crops.shape[0]
        outs = []
        with self._precision(), torch.no_grad():
            for s in range(0, n, b):
                chunk = crops[s : s + b]
                pad = b - chunk.shape[0]
                if pad:
                    chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1, -1)])
                out = self._forward_rows(model, chunk[:, None])
                outs.append(out[: b - pad] if pad else out)
        return torch.cat(outs).cpu().numpy()

    def predict_joints(self, state: TrainState, data: TrainData,
                       batch_size: Optional[int] = None):
        """The joints (N, J, 3) in mm of ``data``'s rows in eval mode: the
        family's decode of the model's output about each row's CoM, plus the
        CoM; the tail batch padded by repetition.  Returns a numpy array."""
        model = state.model
        model.eval()
        data = data.to(self.device)
        b = batch_size or self.cfg.batch_size
        n = data.n
        idx = torch.from_numpy(np.minimum(np.arange(-(-n // b) * b), n - 1)).to(self.device)
        outs = []
        with self._precision(), torch.no_grad():
            for s in range(0, n, b):
                batch = data.take(idx[s:s + b])
                out = self._forward_rows(model, self.family.inputs(batch, self.camera))
                com3d = self.camera.img_to_3d(batch["com"])
                outs.append(self.family.joints(out, batch, camera=self.camera)
                            + com3d[:, None, :])
        return torch.cat(outs)[:n].cpu().numpy()

    def predict_with_intermediates(self, state: TrainState, crops):
        """One forward pass in eval mode that also returns each named
        submodule's output, captured by forward hooks (the reference's
        per-layer activation dumps, poseregnettrainer.py setupDebugFunctions).
        Returns (output, {module name: activation}) as numpy arrays."""
        model = state.model
        model.eval()
        acts = {}

        def keep(name):
            return lambda mod, args, out: acts.__setitem__(name, out.detach())

        hooks = [mod.register_forward_hook(keep(name))
                 for name, mod in model.named_modules() if name]
        try:
            with self._precision(), torch.no_grad():
                x = torch.as_tensor(crops, dtype=torch.float32).to(self.device)
                out = model(x[:, None])
        finally:
            for h in hooks:
                h.remove()
        return out.cpu().numpy(), {k: v.float().cpu().numpy() for k, v in acts.items()}

    # ------------------------------------------------------------------
    def check_nans(self, state: TrainState):
        """Names of the parameters with non-finite values (reference
        checkNaNs, nettrainer.py:909-917)."""
        return [name for name, p in state.model.named_parameters()
                if not bool(torch.isfinite(p).all())]

    def _opt_tree(self, state: TrainState):
        """The optimizer's state by parameter name, and its step count."""
        opt = state.optimizer
        if len(opt.param_groups) != 1:
            raise ValueError("snapshots hold one optimizer parameter group")
        names = {id(p): n for n, p in state.model.named_parameters()}
        tree = {"state": {names[id(p)]: dict(opt.state[p])
                          for p in opt.param_groups[0]["params"]}}
        if "count" in opt.param_groups[0]:
            tree["count"] = opt.param_groups[0]["count"]
        return tree

    def _train_tree(self, state: TrainState, epoch: int, best, sharded: bool):
        """The snapshot's tree, each parameter-shaped tensor through
        ``_leaf_out``."""
        def out(sd):
            return {k: self._leaf_out(k, v, sharded) for k, v in sd.items()}

        opt = self._opt_tree(state)
        opt["state"] = {name: {k: self._leaf_out(name, t, sharded) for k, t in slots.items()}
                        for name, slots in opt["state"].items()}
        tree = {
            "params": out(state.model.state_dict()),
            "opt_state": opt,
            "step": int(state.step),
            "epoch": int(epoch),
        }
        if best is not None and best[1] is not None:
            tree["best"] = {"val": float(best[0]), "params": out(best[1]),
                            "epoch": int(best[2])}
        return tree

    def save_train_state(self, path, state: TrainState, epoch: int, best=None):
        """A resumable snapshot: the state dict (BatchNorm statistics
        included), the optimizer's moments and count, the step and the
        epoch, fingerprinted with the TrainConfig.  ``best`` is fit's
        early-stopping tracker (val error, state dict, epoch); kept in the
        snapshot, a resumed run restores the pre-interruption best.  With
        ``sharded_snapshots`` the snapshot is a sharded directory written
        asynchronously (every rank its shards); ``fit`` drains it at its
        end."""
        config = self.cfg._asdict()
        if self.sharded_snapshots:
            tree = self._train_tree(state, epoch, best, sharded=True)
            self._snapshot_ckptr().save(path, tree, config=config)
            return
        from deepprior_tpu_torch.parallel.multihost import barrier, is_writer

        tree = self._train_tree(state, epoch, best, sharded=False)
        if is_writer():
            save_checkpoint(path, tree, config=config)
        barrier()

    def _snapshot_ckptr(self):
        """The trainer's async sharded checkpointer, made on first use (saves
        overlap the training and serialize with each other)."""
        if self._sharded_ckptr is None:
            from deepprior_tpu_torch.train.checkpoint_sharded import ShardedCheckpointer

            self._sharded_ckptr = ShardedCheckpointer(async_save=True)
        return self._sharded_ckptr

    def _drain_snapshots(self):
        """Block until an async sharded snapshot in flight is committed:
        fit and fit_streamed call it at their end, so the rolling snapshot
        is whole before the caller writes its results or exits."""
        if self._sharded_ckptr is not None:
            self._sharded_ckptr.wait_until_finished()

    def load_train_state(self, path, state: TrainState):
        """Restore a snapshot, a file or a sharded directory, into an
        initialized state, on the state's device whichever device wrote it.
        Returns (state, next epoch); the snapshot's best tracker waits on
        the trainer for the next resumed ``fit``/``fit_streamed``
        (start_epoch > 0).  A sharded snapshot is read straight into the
        live tensors; a config mismatch warns with the unified diff."""
        from deepprior_tpu_torch.train.checkpoint_sharded import is_sharded_checkpoint

        sharded = is_sharded_checkpoint(path)
        model = state.model
        if sharded:
            ck = self._snapshot_ckptr()
            self._drain_snapshots()
            has_best = "best" in ck.metadata_keys(path)
        else:
            has_best = "best" in checkpoint_keys(path)
        # the target: the live tensors (read in place by a sharded restore)
        # and, for the best tracker, copies
        best = (0.0, self._best_copy(state), 0) if has_best else None
        target = self._train_tree(state, 0, best, sharded)
        if sharded:
            tree, _ = ck.restore(path, target, config=self.cfg._asdict(),
                                 allow_mismatch=True)
        else:
            tree, _ = load_checkpoint(path, target, config=self.cfg._asdict())

        def into(sd):
            return {k: self._leaf_in(k, v) for k, v in sd.items()}

        live = self._opt_tree(state)
        model.load_state_dict(into(tree["params"]))
        with torch.no_grad():
            for name, slots in live["state"].items():
                for k, t in slots.items():
                    t.copy_(self._leaf_in(name, tree["opt_state"]["state"][name][k]))
            if "count" in live:
                live["count"].copy_(tree["opt_state"]["count"])
        state.step = int(tree["step"])
        self._resumed_best = None
        if has_best:
            b = tree["best"]
            self._resumed_best = (float(b["val"]), into(b["params"]), int(b["epoch"]))
        return state, int(tree["epoch"]) + 1

    def _take_resumed_best(self):
        """The tracker load_train_state left (once), else a fresh one."""
        best = getattr(self, "_resumed_best", None)
        self._resumed_best = None
        return best if best is not None else (np.inf, None, -1)

    def _best_copy(self, state: TrainState):
        """The state dict, BatchNorm statistics included, off the live model."""
        return {k: v.detach().clone() for k, v in state.model.state_dict().items()}

    def _epoch_generators(self, epoch: int):
        """The augmentation and dropout generators, seeded for ``epoch``."""
        seeds = np.random.SeedSequence([self.cfg.seed, epoch]).generate_state(2, np.uint64)
        return tuple(torch.Generator(device=self.device).manual_seed(int(s))
                     for s in seeds)

    def _observe(self, state, val, epoch, best):
        """The validation observers, recorded in the history, and the
        best-weights tracker.  Returns (observers, best)."""
        obs = self.evaluate(state, val)
        self.history["val_error_mm"].append(obs["error_mm_avg"])
        if self.cfg.use_early_stopping and obs["error_mm_avg"] < best[0]:
            best = (obs["error_mm_avg"], self._best_copy(state), epoch)
        return obs, best

    def _end_epoch(self, state, epoch, lr, losses, val, sub_obs, best, t_per_epoch,
                   log, on_epoch_end, snapshot_path):
        """One fetch of the epoch's losses, the NaN guard, the epoch-end
        observers (unless sub-epoch ones ran), the log line, the hook and
        the rolling snapshot.  Returns the best tracker."""
        cfg = self.cfg
        costs = self._epoch_costs(losses)
        self.history["train_cost"].extend(costs.tolist())
        if not np.isfinite(costs).all():
            bad = self.check_nans(state)
            raise FloatingPointError(
                f"non-finite training cost at epoch {epoch}; "
                f"NaN params: {bad or 'none (cost-only)'}"
            )
        msg = f"epoch {epoch}: lr {lr:.2e} cost {costs.mean():.5f} ({t_per_epoch:.2f}s/epoch)"
        if sub_obs is not None:
            msg += f" val_mm {sub_obs['error_mm_avg']:.3f}"
        elif val is not None and (epoch % cfg.eval_every) == 0:
            obs, best = self._observe(state, val, epoch, best)
            msg += f" val_mm {obs['error_mm_avg']:.3f}"
        log(msg)
        if on_epoch_end is not None:
            on_epoch_end(epoch, state, costs)
        if snapshot_path and (epoch % cfg.snapshot_every) == 0:
            self.save_train_state(f"{snapshot_path}_last.ckpt", state, epoch, best=best)
        return best

    def _restore_best(self, state, best, log):
        if self.cfg.use_early_stopping and best[1] is not None:
            log(f"best params at epoch {best[2]} (val {best[0]:.3f}mm)")
            state.model.load_state_dict(best[1])
        return state

    def fit(
        self,
        state: TrainState,
        train_data: TrainData,
        val_data: Optional[TrainData] = None,
        n_epochs: Optional[int] = None,
        snapshot_path: Optional[str] = None,
        log: Callable[[str], None] = print,
        on_epoch_start: Optional[Callable] = None,
        on_epoch_end: Optional[Callable] = None,
        start_epoch: int = 0,
    ) -> Tuple[TrainState, Dict[str, list]]:
        """The training loop (reference NetTrainer.train, nettrainer.py:
        778-907): per-epoch LR schedule, the alignData-padded epoch order,
        sub-epoch observers every ``validation_frequency`` steps, the NaN
        guard, best-weights early stopping, ``history``, and a rolling
        snapshot ``<snapshot_path>_last.ckpt`` every ``snapshot_every``
        epochs.  start_epoch > 0 resumes a state from ``load_train_state``:
        the run then draws what the uninterrupted run would have drawn."""
        cfg = self.cfg
        sched = lr_of_ep(cfg.learning_rate)
        n_epochs = n_epochs or cfg.n_epochs
        rng = np.random.default_rng(cfg.seed)
        data = train_data.to(self.device)
        val = val_data.to(self.device) if val_data is not None else None

        n = data.n
        if n < cfg.batch_size:
            raise ValueError("training set smaller than one batch")
        # ceil: the n % batch_size tail trains every epoch in a final batch
        # padded with seeded-random repeats (nettrainer.py:365-413)
        steps = -(-n // cfg.batch_size)
        seg = int(cfg.validation_frequency or 0) if val is not None else 0
        for _ in range(start_epoch):  # the epochs already trained
            rng.permutation(n)

        best = self._take_resumed_best() if start_epoch else (np.inf, None, -1)
        t0 = time.time()
        for epoch in range(start_epoch, n_epochs):
            if on_epoch_start is not None:
                on_epoch_start(epoch, state)
            lr = float(sched(epoch))
            aug_gen, drop_gen = self._epoch_generators(epoch)
            perm = aligned_epoch_indices(rng, n, cfg.batch_size)
            idxs = torch.from_numpy(perm.reshape(steps, cfg.batch_size)).to(self.device)
            sub_obs = None
            losses = []
            for s in range(steps):
                state, loss = self.train_step(
                    state, self._take(data, idxs[s]), aug_gen, drop_gen, lr)
                losses.append(loss)
                if seg and ((s + 1) % seg == 0 or s + 1 == steps):
                    # sub-epoch observers (nettrainer.py:859-889)
                    sub_obs, best = self._observe(state, val, epoch, best)
            best = self._end_epoch(state, epoch, lr, losses, val, sub_obs, best,
                                   (time.time() - t0) / (epoch - start_epoch + 1),
                                   log, on_epoch_end, snapshot_path)
        self._drain_snapshots()
        return self._restore_best(state, best, log), self.history

    def fit_streamed(
        self,
        state: TrainState,
        arrays: Dict[str, np.ndarray],
        val_data: Optional[TrainData] = None,
        n_epochs: Optional[int] = None,
        prefetch_depth: int = 2,
        chunk_steps: int = 8,
        snapshot_path: Optional[str] = None,
        log: Callable[[str], None] = print,
        start_epoch: int = 0,
        on_epoch_start: Optional[Callable] = None,
        on_epoch_end: Optional[Callable] = None,
    ) -> Tuple[TrainState, Dict[str, list]]:
        """``fit`` for a training set that stays in host memory (the
        reference's para_load training, nettrainer.py:701-723): the epochs'
        minibatches go to the device in ``macro_chunks``' chunks of
        ``chunk_steps`` (``index_chunks``) through a ``DevicePrefetcher`` of
        ``prefetch_depth``, which gathers each chunk's rows straight into
        its pinned staging buffer; the steps run one minibatch at a time.  The
        batches and the draws are ``fit``'s, so the loss trace equals
        ``fit``'s and does not depend on chunk_steps or prefetch_depth;
        observers, early stopping, snapshots, resume and ``history`` are
        ``fit``'s too.  Chunks never straddle a validation boundary.

        arrays: co-indexed host arrays crops, gt3d_crop, com, cube, m.
        The prefetcher stays on ``self.prefetcher`` (its ``stage_s``)."""
        cfg = self.cfg
        n_epochs = n_epochs or cfg.n_epochs
        sched = lr_of_ep(cfg.learning_rate)
        n = arrays["crops"].shape[0]
        if n < cfg.batch_size:
            raise ValueError("training set smaller than one batch")
        steps = -(-n // cfg.batch_size)
        chunk_steps = max(1, min(int(chunk_steps), steps))
        val = val_data.to(self.device) if val_data is not None else None
        seg = int(cfg.validation_frequency or 0) if val is not None else 0
        best = self._take_resumed_best() if start_epoch else (np.inf, None, -1)
        source = {k: torch.from_numpy(np.ascontiguousarray(arrays[k], np.float32))
                  for k in TrainData._fields}
        it = self.prefetcher = DevicePrefetcher(
            self._stream_indices(index_chunks(
                n, cfg.batch_size, n_epochs, chunk_steps, seed=cfg.seed,
                start_epoch=start_epoch, segment_steps=seg)),
            source, depth=prefetch_depth, device=self.device)
        t0 = time.time()
        done = 0
        try:
            for chunk in it:
                epoch, pos = start_epoch + done // steps, done % steps
                if pos == 0:
                    if on_epoch_start is not None:
                        on_epoch_start(epoch, state)
                    lr = float(sched(epoch))
                    aug_gen, drop_gen = self._epoch_generators(epoch)
                    losses, sub_obs = [], None
                for s in range(chunk["crops"].shape[0]):
                    state, loss = self.train_step(
                        state, {k: v[s] for k, v in chunk.items()}, aug_gen, drop_gen, lr)
                    losses.append(loss)
                done += chunk["crops"].shape[0]
                pos = done % steps
                if seg and (pos % seg == 0 or pos == 0):
                    # chunks are segment-aligned: the observers land every
                    # seg minibatches and at the epoch's end, as in fit
                    sub_obs, best = self._observe(state, val, epoch, best)
                if pos == 0:
                    best = self._end_epoch(state, epoch, lr, losses, val, sub_obs, best,
                                           (time.time() - t0) / (epoch - start_epoch + 1),
                                           log, on_epoch_end, snapshot_path)
        finally:
            # an abandoned iteration (an exception above) must not leave
            # the worker holding staged chunks
            it.close()
        self._drain_snapshots()
        return self._restore_best(state, best, log), self.history
