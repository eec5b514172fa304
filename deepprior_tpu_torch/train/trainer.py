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

Random draws: one ``torch.Generator`` on the device for the augmentation
and one for the dropout masks, both seeded from ``TrainConfig.seed``.
They give other numbers than the JAX package's keys; the parity tests feed
both packages the same augmentation draws through ``_train_step_core``.
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
from deepprior_tpu_torch.ops.augment import augment_batch
from deepprior_tpu_torch.prior import PCAPrior
from deepprior_tpu_torch.train.optimizer import lr_of_ep, make_optimizer
from deepprior_tpu_torch.train.prefetch import aligned_epoch_indices

# the ROADMAP entries of what the port's trainer does not have yet
_CHECKPOINT_TODO = (
    "training snapshots and resume are not ported yet (ROADMAP.md Queue 1 "
    "item 13)"
)
_STREAMED_TODO = (
    "streamed training (fit_streamed, DevicePrefetcher) is not ported yet "
    "(ROADMAP.md Queue 1 item 13)"
)


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


def _loss_from_targets(out, y):
    if y.dim() == 2:
        per_sample = torch.sum(torch.square(out - y), dim=1)
    else:
        out3 = out.reshape(y.shape)
        per_sample = torch.mean(torch.sum(torch.square(out3 - y), dim=2), dim=1)
    return torch.mean(per_sample)


def _l2_penalty(model: nn.Module):
    """Sum of squares of the conv and dense weights, never biases,
    activation slopes or BatchNorm parameters (convpoollayer.py:288,
    hiddenlayer.py:159, batchnormlayer.py:146), as the JAX package's
    "kernel" leaves."""
    total = 0.0
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            total = total + torch.sum(torch.square(mod.weight))
    return total


def _tf32_switches():
    """The process's TF32 switches for cuDNN's convs and cuBLAS's matmuls,
    and the value that turns each off.  torch >= 2.9 keeps one TF32 state
    per backend and lets two APIs write it: ``fp32_precision`` and the
    legacy ``allow_tf32``.  Once the new API holds a value the legacy flag
    cannot express, reading the legacy flag raises, so the switches are
    read and written through ``fp32_precision`` wherever this torch has it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(cudnn, "conv", None)
    if hasattr(matmul, "fp32_precision") and hasattr(conv, "fp32_precision"):
        return ((conv, "fp32_precision"), (matmul, "fp32_precision")), "ieee"
    return ((cudnn, "allow_tf32"), (matmul, "allow_tf32")), False


@contextlib.contextmanager
def float32_compute():
    """float32 means float32 on the card too: inside the block cuDNN's convs
    and cuBLAS's matmuls do not round their inputs to TF32 (cuDNN does by
    default), and the caller's settings come back after it, whichever of
    PyTorch's two TF32 APIs the caller set them through."""
    switches, off = _tf32_switches()
    saved = [getattr(obj, attr) for obj, attr in switches]
    for obj, attr in switches:
        setattr(obj, attr, off)
    try:
        yield
    finally:
        for (obj, attr), value in zip(switches, saved):
            setattr(obj, attr, value)


class Trainer:
    """Drives one model over device-resident TrainData on ``device``
    (default: the model's).  A float32 model computes in float32 within the
    trainer's steps, evaluation and prediction (``float32_compute``)."""

    def __init__(
        self,
        model: nn.Module,
        cfg: TrainConfig,
        camera: Camera,
        prior: Optional[PCAPrior] = None,
        device=None,
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
                             lr=self.cfg.learning_rate, momentum=self.cfg.momentum)
        return TrainState(self.model, opt, 0)

    # ------------------------------------------------------------------
    def _targets(self, labels_norm):
        """labels_norm (B, J, 3), cube-normalized -> PCA embeddings when a
        prior is attached (poseregnettrainer.py:252-259)."""
        if self.prior is not None:
            return self.prior.transform(labels_norm.reshape(labels_norm.shape[0], -1))
        return labels_norm

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
        with self._precision():
            with torch.no_grad():
                crops, gt3d, cube = batch["crops"], batch["gt3d_crop"], batch["cube"]
                if cfg.aug_modes:
                    params = aug if isinstance(aug, (tuple, list)) else None
                    crops, labels_norm, _, cube, _ = augment_batch(
                        None if params is not None else aug,
                        crops, gt3d, batch["com"], cube, batch["m"], self.camera,
                        aug_modes=tuple(cfg.aug_modes),
                        sigma_com=cfg.sigma_com, sigma_sc=cfg.sigma_sc,
                        rot_range=cfg.rot_range, norm_zero_one=cfg.norm_zero_one,
                        fuse_norm=cfg.aug_fuse_norm, block_k=cfg.aug_block_k,
                        resize=cfg.aug_resize, params=params,
                    )
                else:
                    labels_norm = gt3d / (cube[:, 2] / 2.0)[:, None, None]
                y = self._targets(labels_norm)

            model, opt = state.model, state.optimizer
            model.train()
            for group in opt.param_groups:
                group["lr"] = lr
            opt.zero_grad(set_to_none=True)
            out = model(crops[:, None], generator=drop_generator)
            loss = _loss_from_targets(out, y)
            if cfg.weightreg_factor > 0.0 and not cfg.model_has_dropout:
                loss = loss + cfg.weightreg_factor * _l2_penalty(model)
            loss.backward()
            opt.step()
        state.step += 1
        return state, loss.detach()

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
        with self._precision(), torch.no_grad():
            for s in range(n_steps):
                sl = slice(s * b, (s + 1) * b)
                batch = data.take(idx[sl])
                mk = mask[sl]
                gt3d, half = batch["gt3d_crop"], batch["cube"][:, 2] / 2.0
                y = self._targets(gt3d / half[:, None, None])
                out = model(batch["crops"][:, None])
                if y.dim() == 2:
                    cost_ps = torch.sum(torch.square(out - y), dim=1)
                    err_ps = torch.sqrt(cost_ps)
                else:
                    sq = torch.sum(torch.square(out.reshape(y.shape) - y), dim=2)
                    cost_ps = torch.mean(sq, dim=1)
                    err_ps = torch.mean(torch.sqrt(sq), dim=1)
                if self.prior is not None:
                    d3 = self.prior.inverse_transform(out).reshape(gt3d.shape)
                else:
                    d3 = out.reshape(gt3d.shape)
                dist = torch.sqrt(torch.sum(
                    torch.square(d3 * half[:, None, None] - gt3d), dim=2))
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
                out = model(chunk[:, None])
                outs.append(out[: b - pad] if pad else out)
        return torch.cat(outs).cpu().numpy()

    # ------------------------------------------------------------------
    def check_nans(self, state: TrainState):
        """Names of the parameters with non-finite values (reference
        checkNaNs, nettrainer.py:909-917)."""
        return [name for name, p in state.model.named_parameters()
                if not bool(torch.isfinite(p).all())]

    def save_train_state(self, path, state, epoch, best=None):
        raise NotImplementedError(_CHECKPOINT_TODO)

    def load_train_state(self, path, state):
        raise NotImplementedError(_CHECKPOINT_TODO)

    def fit_streamed(self, *args, **kwargs):
        raise NotImplementedError(_STREAMED_TODO)

    def _best_copy(self, state: TrainState):
        """The state dict, BatchNorm statistics included, off the live model."""
        return {k: v.detach().clone() for k, v in state.model.state_dict().items()}

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
        778-907): per-epoch LR schedule, the alignData-padded epoch order
        from ``np.random.default_rng(cfg.seed)``, sub-epoch observers every
        ``validation_frequency`` steps, the NaN guard, best-weights early
        stopping and ``history``.  Snapshots and resume are not ported."""
        if snapshot_path is not None or start_epoch:
            raise NotImplementedError(_CHECKPOINT_TODO)
        cfg = self.cfg
        sched = lr_of_ep(cfg.learning_rate)
        n_epochs = n_epochs or cfg.n_epochs
        rng = np.random.default_rng(cfg.seed)
        aug_gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        drop_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        data = train_data.to(self.device)
        val = val_data.to(self.device) if val_data is not None else None

        n = data.n
        if n < cfg.batch_size:
            raise ValueError("training set smaller than one batch")
        # ceil: the n % batch_size tail trains every epoch in a final batch
        # padded with seeded-random repeats (nettrainer.py:365-413)
        steps = -(-n // cfg.batch_size)
        seg = int(cfg.validation_frequency or 0) if val is not None else 0

        best = (np.inf, None, -1)  # (val error, weights, epoch)
        t0 = time.time()
        for epoch in range(n_epochs):
            if on_epoch_start is not None:
                on_epoch_start(epoch, state)
            lr = float(sched(epoch))
            perm = aligned_epoch_indices(rng, n, cfg.batch_size)
            idxs = torch.from_numpy(perm.reshape(steps, cfg.batch_size)).to(self.device)
            sub_obs = None
            losses = []
            for s in range(steps):
                state, loss = self._train_step_core(
                    state, data.take(idxs[s]), aug_gen, drop_gen, lr)
                losses.append(loss)
                if seg and ((s + 1) % seg == 0 or s + 1 == steps):
                    # sub-epoch observers (nettrainer.py:859-889)
                    sub_obs = self.evaluate(state, val)
                    self.history["val_error_mm"].append(sub_obs["error_mm_avg"])
                    if cfg.use_early_stopping and sub_obs["error_mm_avg"] < best[0]:
                        best = (sub_obs["error_mm_avg"], self._best_copy(state), epoch)
            costs = torch.stack(losses).cpu().numpy()  # one fetch per epoch
            self.history["train_cost"].extend(costs.tolist())
            if not np.isfinite(costs).all():
                bad = self.check_nans(state)
                raise FloatingPointError(
                    f"non-finite training cost at epoch {epoch}; "
                    f"NaN params: {bad or 'none (cost-only)'}"
                )
            msg = (
                f"epoch {epoch}: lr {lr:.2e} cost {costs.mean():.5f} "
                f"({(time.time() - t0) / (epoch + 1):.2f}s/epoch)"
            )
            if sub_obs is not None:
                msg += f" val_mm {sub_obs['error_mm_avg']:.3f}"
            elif val is not None and (epoch % cfg.eval_every) == 0:
                obs = self.evaluate(state, val)
                self.history["val_error_mm"].append(obs["error_mm_avg"])
                msg += f" val_mm {obs['error_mm_avg']:.3f}"
                if cfg.use_early_stopping and obs["error_mm_avg"] < best[0]:
                    best = (obs["error_mm_avg"], self._best_copy(state), epoch)
            log(msg)
            if on_epoch_end is not None:
                on_epoch_end(epoch, state, costs)

        if cfg.use_early_stopping and best[1] is not None:
            log(f"best params at epoch {best[2]} (val {best[0]:.3f}mm)")
            state.model.load_state_dict(best[1])
        return state, self.history
