"""Shared pieces of the port's entry points (counterpart of mains/common.py).

``run_posereg_embedding`` is the flagship recipe (reference
main_nyu_posereg_embedding.py:38-205): import (or synthesize) -> PCA prior
from sampled poses -> PoseRegNet (or, with --model resnet, ResNet-47)
30-D embedding training with augmentation -> network_prior.ckpt -> decode
-> metrics -> results.json.  ``run_com_refine`` is the CoM-refinement
recipe (reference main_nyu_com_refine.py): ScaleNet over docom crops ->
net_<prefix>.ckpt, which an importer's ``load_refine_net_lazy`` reads.
Both train resident (``Trainer.fit``) or, with --streamed, from host
memory (``Trainer.fit_streamed``), write a rolling snapshot
<out>/<prefix>/net_last.ckpt, and continue from it with --resume.
``load_serving_net`` gives the serving entry points their model and
prior: random weights, the trained ones from a network_prior.ckpt, or a
reference-trained pickle.

Under torchrun (``torchrun --nproc-per-node N -m <main> --dp D --tp T``)
every rank runs the main: ``make_trainer`` builds a ``DistributedTrainer``
over the ('dp', 'tp') mesh, each rank trains its rows of every batch on its
card, and only rank 0 logs and writes results.json and network_prior.ckpt
(whole tensors under tp); --sharded-snapshots makes the rolling snapshot a
directory every rank writes its shards into.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# the ROADMAP entries of the flags the port does not have yet
_TODO = {
    "accept": "--accept needs the baseline loaders' plumbing and the plots "
              "(ROADMAP.md Queue 1 item 20)",
}

# poses the PCA prior samples from imported and from synthetic frames, the
# JAX mains' recipe constants
PRIOR_POSES = 1_000_000
PRIOR_POSES_SYNTHETIC = 50_000


def default_device() -> torch.device:
    """The entry points' default device: the CUDA card.  Raises
    RuntimeError when there is none; the CPU is only ever asked for
    (``--device cpu``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "--device cpu to run on the CPU"
        )
    return torch.device("cuda")


def base_parser(desc: str) -> argparse.ArgumentParser:
    """The JAX mains' flags.  Those the port does not have yet are parsed
    and raise NotImplementedError naming their ROADMAP entry."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--data", default=None,
                   help="dataset base path (without it, or with --synthetic, "
                        "synthetic frames)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic data (no dataset required)")
    p.add_argument("--cache-dir", default=None,
                   help="the importers' .npz cache (default <out>/cache; the "
                        "JAX package's caches load here and back)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=23455)
    p.add_argument("--nmax", type=float, default=float("inf"),
                   help="cap on frames")
    p.add_argument("--eval-prefix", default=None)
    p.add_argument("--out", default="./eval")
    p.add_argument("--aug-modes", nargs="*", default=["com", "rot", "none"])
    p.add_argument("--aug-resize", choices=["nearest", "linear"],
                   default="nearest",
                   help="augmentation warp interpolation (handdetector.py:"
                        "731-737, 785-791); linear runs the gather warp")
    p.add_argument("--aug-fuse-norm", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the augmentation through the fused warp kernel K5 "
                        "(--aug-fuse-norm) or through K4 (--no-aug-fuse-norm); "
                        "unset, K5 on a CUDA device (TrainConfig.aug_fuse_norm)")
    p.add_argument("--weightreg", type=float, default=0.0,
                   help="L2 weight-decay factor; > 0 forces decay on even "
                        "for dropout models")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (float32 parameters, optimizer "
                        "state, losses and metrics)")
    p.add_argument("--model", default="poseregnet",
                   choices=["poseregnet", "resnet"],
                   help="regressor family: PoseRegNet, or ResNet-47 (the "
                        "reference's best results and realtime demo)")
    p.add_argument("--resnet-type", type=int, default=2,
                   help="reference ResNet head type 0-4 (resnet.py:119-195); "
                        "2 = dropout head (default), 1 = plain head (pair "
                        "with --weightreg, the reference's recipe for "
                        "dropout-less nets)")
    p.add_argument("--validation-frequency", type=int, default=None,
                   help="run the validation observers every N minibatches")
    p.add_argument("--resume", action="store_true",
                   help="continue from <out>/<prefix>/net_last.ckpt if present "
                        "(parameters, BatchNorm statistics, optimizer state, "
                        "step, epoch, best tracker); the resumed run draws what "
                        "an uninterrupted one would")
    p.add_argument("--streamed", action="store_true",
                   help="train with fit_streamed: the data stays in host memory "
                        "and goes to the device in chunks through a pinned "
                        "DevicePrefetcher (loss trace equal to the resident run's)")
    p.add_argument("--chunk-steps", type=int, default=8,
                   help="minibatches per streamed chunk")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, under torchrun the card "
                        "LOCAL_RANK; cpu only when asked for)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks (default: the process group's world "
                        "over --tp); more than one needs torchrun")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: the wide FC layers split over them")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial ranks (not ported: > 1 raises)")
    p.add_argument("--sharded-snapshots", action="store_true",
                   help="write the rolling snapshot as a sharded directory "
                        "(torch.distributed.checkpoint, async, every rank its "
                        "shards); --resume reads either format")
    # not ported yet: parsed so that asking for it fails loudly
    p.add_argument("--accept", action="store_true")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag the port does not have yet."""
    if args.sp != 1:
        from deepprior_tpu_torch.parallel.mesh import SP_TODO

        raise NotImplementedError(SP_TODO)
    if args.accept:
        raise NotImplementedError(_TODO["accept"])


def main_device(args) -> torch.device:
    """The main's device and, under torchrun (WORLD_SIZE in the
    environment), its process group: ``multihost.initialize`` takes the card
    LOCAL_RANK (NCCL), or the CPU with --device cpu (gloo)."""
    import torch.distributed as dist

    device = torch.device(args.device) if args.device else default_device()
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        from deepprior_tpu_torch.parallel import multihost

        multihost.initialize(device=device.type)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_trainer(model, cfg, camera, prior=None, dp=None, tp=1, sp=1, device=None):
    """A ``Trainer`` on one rank, or a ``DistributedTrainer`` over the
    ('dp', 'tp') mesh of the process group (counterpart of the JAX
    ``make_trainer``).  Nothing falls back quietly: dp or tp above 1 without
    a process group, or a group whose world is not dp x tp, raises and names
    the launcher."""
    from deepprior_tpu_torch.train.trainer import Trainer

    if not check_world(dp, tp, sp):
        return Trainer(model, cfg, camera, prior=prior, device=device)
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh

    return DistributedTrainer(model, cfg, camera, make_mesh(dp=dp, tp=tp or 1),
                              prior=prior, device=device)


def check_world(dp=None, tp=1, sp=1) -> bool:
    """Whether the run is distributed (a process group exists); raises when
    the flags and the process group disagree: --sp > 1, dp or tp above 1
    without a group, or a group whose world is not dp x tp."""
    import torch.distributed as dist

    from deepprior_tpu_torch.parallel.multihost import LAUNCHER

    if sp not in (None, 1):
        from deepprior_tpu_torch.parallel.mesh import SP_TODO

        raise NotImplementedError(SP_TODO)
    tp = tp or 1
    if not dist.is_initialized():
        if (dp or 1) * tp > 1:
            raise RuntimeError(
                f"--dp {dp or 1} --tp {tp} needs one process per device under a "
                f"process group; launch with {LAUNCHER}")
        return False
    world = dist.get_world_size()
    if world % tp or (dp is not None and dp * tp != world):
        raise RuntimeError(
            f"the process group has {world} ranks, but --dp {dp} x --tp {tp} "
            f"asks for {(dp or world // tp) * tp}; launch with {LAUNCHER} where "
            "N = dp x tp")
    return True


def rank_log(log):
    """``log`` on the rank that writes the run's files, silence elsewhere."""
    from deepprior_tpu_torch.parallel.multihost import is_writer

    return log if is_writer() else (lambda msg: None)


def serving_state_dict(trainer, state):
    """The trained state dict with every tensor whole (a collective under a
    DistributedTrainer: every rank calls it)."""
    full = getattr(trainer, "full_state_dict", None)
    return full(state) if full is not None else state.model.state_dict()


def load_or_synthesize(args, importer_cls, camera, train_seq, test_seqs, num_joints,
                       docom=False):
    """(train ImageSequence, [test ImageSequences]).

    With --data: ``importer_cls(args.data, cache_dir=, device=)`` loads the
    train sequence shuffled by ``RandomState(args.seed)`` and the test
    sequences in order, each capped at --nmax and cropped on the host, as
    the JAX mains load them.  Without it (or with --synthetic): 256
    synthetic train frames unless --nmax, and test sequences of
    max(32, n // 8) frames, seeded as the JAX mains seed them."""
    if args.data is None and not args.synthetic:
        print("note: --data not given; running on synthetic fixtures (as if "
              "--synthetic)", flush=True)
        args.synthetic = True
    if args.synthetic:
        from deepprior_tpu_torch.data.synthetic import make_sequence

        n_train = 256 if np.isinf(args.nmax) else int(args.nmax)
        train = make_sequence(camera, n_train, num_joints=num_joints, seed=args.seed,
                              name=train_seq, docom=docom)
        tests = [
            make_sequence(camera, max(32, n_train // 8), num_joints=num_joints,
                          seed=args.seed + 1 + i, name=name, docom=docom)
            for i, name in enumerate(test_seqs)
        ]
        return train, tests
    imp = importer_cls(args.data, cache_dir=args.cache_dir or os.path.join(args.out, "cache"),
                       device=args.device)
    kw = dict(Nmax=args.nmax, docom=docom)
    train = imp.loadSequence(train_seq, shuffle=True, rng=np.random.RandomState(args.seed),
                             **kw)
    tests = [imp.loadSequence(s, **kw) for s in test_seqs]
    return train, tests


def _maybe_resume(args, trainer, state, outdir, log=print):
    """With --resume and a rolling snapshot in ``outdir``, the restored state
    and the epoch to start at; else (state, 0)."""
    from deepprior_tpu_torch.train.checkpoint_sharded import is_sharded_checkpoint

    snap = os.path.join(outdir, "net_last.ckpt")
    if args.resume and (os.path.isfile(snap) or is_sharded_checkpoint(snap)):
        state, start_epoch = trainer.load_train_state(snap, state)
        log(f"resuming from {snap} at epoch {start_epoch}")
        return state, start_epoch
    return state, 0


def _train(args, trainer, state, data, val, outdir, log):
    """--resume, then ``fit`` on the device-resident data or, with
    --streamed, ``fit_streamed`` from host arrays; the rolling snapshot is
    <outdir>/net_last.ckpt.  Returns (state, history)."""
    from deepprior_tpu_torch.train.trainer import TrainData

    state, start_epoch = _maybe_resume(args, trainer, state, outdir, log)
    kw = dict(val_data=val, snapshot_path=os.path.join(outdir, "net"), log=log,
              start_epoch=start_epoch)
    t0 = time.time()
    if args.streamed:
        arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
        state, hist = trainer.fit_streamed(state, arrays, chunk_steps=args.chunk_steps, **kw)
    else:
        state, hist = trainer.fit(state, data, **kw)
    log(f"training took {time.time() - t0:.1f}s")
    return state, hist


def _model_dtype(args):
    return torch.bfloat16 if args.bf16 else torch.float32


def run_posereg_embedding(args, importer_cls, camera, train_seq, test_seqs, num_joints,
                          eval_cls=None, n_pca: int = 30, log=print):
    """The flagship recipe.

    ``--model resnet`` trains ResNet-47 of head type ``--resnet-type``
    (default 2, the dropout head); weight decay applies iff the net has no
    dropout or --weightreg > 0 asks for it.  The PCA prior samples
    ``PRIOR_POSES`` poses from imported data, ``PRIOR_POSES_SYNTHETIC``
    from synthetic.  Returns (state, {seq name: evaluation}, training
    history) and writes
    <out>/<prefix>/network_prior.ckpt (the trained weights, a ResNet's
    BatchNorm statistics and the PCA prior, fingerprinted with the
    TrainConfig and the family; ``load_serving_net`` reads it),
    <out>/<prefix>/net_last.ckpt (the rolling snapshot) and
    <out>/<prefix>/results.json with the JAX main's metrics."""
    from deepprior_tpu_torch.eval.metrics import HandposeEvaluation
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.parallel.multihost import is_writer
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData

    check_ported(args)
    eval_cls = eval_cls or HandposeEvaluation
    device = main_device(args)
    check_world(args.dp, args.tp, args.sp)
    log = rank_log(log)
    prefix = args.eval_prefix or f"{train_seq}_EMB_PCA{n_pca}"
    outdir = os.path.join(args.out, prefix)
    os.makedirs(outdir, exist_ok=True)

    def stamp(msg):
        log(f"[{time.strftime('%H:%M:%S')}] {msg}")

    stamp(f"device={device} loading data...")
    train, tests = load_or_synthesize(args, importer_cls, camera, train_seq, test_seqs,
                                      num_joints)
    data = TrainData.from_sequence(train)
    val = TrainData.from_sequence(tests[0]) if tests else None

    stamp(f"{data.n} train frames; fitting pose prior...")
    prior = fit_pose_prior(
        camera, np.random.default_rng(args.seed), data.gt3d_crop, data.com, data.cube,
        n_components=n_pca,
        num_poses=PRIOR_POSES_SYNTHETIC if args.synthetic else PRIOR_POSES,
        aug_modes=tuple(args.aug_modes),
    )
    stamp("prior ready; training...")

    dtype = _model_dtype(args)
    has_dropout = True
    if args.model == "resnet":
        has_dropout = args.resnet_type in (2, 3, 4)
        model = ResNet(ResNetConfig(num_joints=1, n_dims=n_pca, dropout=has_dropout,
                                    dtype=dtype))
    else:
        model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=n_pca, dtype=dtype))
    wr = args.weightreg
    cfg = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.lr,
        n_epochs=args.epochs, aug_modes=tuple(args.aug_modes), seed=args.seed,
        weightreg_factor=wr, model_has_dropout=has_dropout and wr <= 0.0,
        validation_frequency=args.validation_frequency,
        aug_fuse_norm=args.aug_fuse_norm, aug_resize=args.aug_resize,
    )
    trainer = make_trainer(model, cfg, camera, prior=prior, dp=args.dp, tp=args.tp,
                           sp=args.sp, device=device)
    trainer.sharded_snapshots = args.sharded_snapshots
    state, hist = _train(args, trainer, trainer.init_state(), data, val, outdir, log)

    # save the final net (a ResNet's BatchNorm statistics with it) + prior
    # (the reference appends the PCA decode layer and saves
    # network_prior.pkl, main:148-158); the fingerprint names the family
    family = {"model": args.model}
    if args.model == "resnet":
        family["resnet_type"] = args.resnet_type
    params = serving_state_dict(trainer, state)
    if is_writer():
        save_checkpoint(
            os.path.join(outdir, "network_prior.ckpt"),
            {
                "params": params,
                "pca_components": prior.components,
                "pca_mean": prior.mean,
            },
            config=dict(cfg._asdict(), **family),
        )

    # test: decode to mm and the metric suite (main:161-205)
    metrics, results = {}, {}
    for seq in tests:
        tdata = TrainData.from_sequence(seq)
        emb = torch.from_numpy(trainer.predict(state, tdata.crops))
        decoded = prior.to("cpu").inverse_transform(emb).numpy().reshape(
            emb.shape[0], -1, 3)
        cube_z = np.asarray(tdata.cube)[:, 2][:, None, None]
        com3d = camera.img_to_3d_np(np.asarray(tdata.com))
        joints = decoded * (cube_z / 2.0) + com3d[:, None, :]
        gt3d = np.stack([f.gt3Dorig for f in seq.data])
        hpe = eval_cls(gt3d, joints)
        log(f"{seq.name}: mean {hpe.getMeanError():.3f}mm "
            f"max {hpe.getMaxError():.3f}mm")
        results[seq.name] = hpe
        metrics[seq.name] = {
            "mean_mm": hpe.getMeanError(),
            "max_mm": hpe.getMaxError(),
            "median_mm": float(np.median(hpe.getMeanErrorOverSeq())),
            "joint_median_mm": [float(m) for m in hpe.getMedianError()],
            "frames_within_40mm": hpe.getFractionWithinMaxDist(40.0),
            "per_joint_mean_mm": [
                hpe.getJointMeanError(j) for j in range(joints.shape[1])
            ],
        }
    if is_writer():
        with open(os.path.join(outdir, "results.json"), "w") as fh:
            json.dump(metrics, fh, indent=1)
    return state, results, hist


def run_com_refine(args, importer_cls, camera, train_seq, test_seqs, num_joints,
                   crop_joint_idx, eval_cls, log=print):
    """CoM-refinement training (reference main_nyu_com_refine.py): ScaleNet
    over docom crops, at batch min(--batch-size, 64) (main:164), with the
    augmentation (K5 on a CUDA device) and without early stopping
    (main:170); the labels are the crop joint's offset from the detected
    CoM.  Writes <out>/<prefix>/net_<prefix>.ckpt ({"params": the state
    dict}, fingerprinted with the TrainConfig; an importer's
    ``load_refine_net_lazy`` reads it), the rolling snapshot, and, with
    test sequences, result_<prefix>.npy (the refined CoMs as 1-joint poses,
    mm) and results.json: the refined and the raw CoM against the crop
    joint (main:215-250; the shipped baselines wait for --accept).
    Returns (state, {"refined": evaluation, "com": evaluation}, history)."""
    from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.parallel.multihost import is_writer
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData

    check_ported(args)
    device = main_device(args)
    check_world(args.dp, args.tp, args.sp)
    log = rank_log(log)
    prefix = args.eval_prefix or f"{train_seq}_COM"
    outdir = os.path.join(args.out, prefix)
    os.makedirs(outdir, exist_ok=True)
    train, tests = load_or_synthesize(args, importer_cls, camera, train_seq, test_seqs,
                                      num_joints, docom=True)

    def to_refine_data(seq):
        data = TrainData.from_sequence(seq)
        return data._replace(gt3d_crop=data.gt3d_crop[:, crop_joint_idx:crop_joint_idx + 1])

    data = to_refine_data(train)
    val = to_refine_data(tests[0]) if tests else None
    model = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3, dtype=_model_dtype(args)))
    wr = args.weightreg
    cfg = TrainConfig(
        batch_size=min(args.batch_size, 64), learning_rate=args.lr,
        n_epochs=args.epochs, aug_modes=tuple(args.aug_modes), seed=args.seed,
        weightreg_factor=wr, model_has_dropout=wr <= 0.0, use_early_stopping=False,
        validation_frequency=args.validation_frequency,
        aug_fuse_norm=args.aug_fuse_norm, aug_resize=args.aug_resize,
    )
    trainer = make_trainer(model, cfg, camera, dp=args.dp, tp=args.tp, sp=args.sp,
                           device=device)
    trainer.sharded_snapshots = args.sharded_snapshots
    state, hist = _train(args, trainer, trainer.init_state(), data, val, outdir, log)
    params = serving_state_dict(trainer, state)
    if is_writer():
        save_checkpoint(os.path.join(outdir, f"net_{prefix}.ckpt"), {"params": params},
                        config=cfg._asdict())
    if not tests:
        return state, {}, hist

    # refined CoM = offset * cube_z / 2 + the detected CoM (mm), as a
    # 1-joint pose against gt3Dorig[crop_joint] (main:215-233)
    gt1, refined, com3d = [], [], []
    for seq in tests:
        tdata = to_refine_data(seq)
        pred = trainer.predict(state, tdata.crops)  # (N, 3)
        c3 = camera.img_to_3d_np(np.asarray(tdata.com))
        refined.append(c3 + pred * (np.asarray(tdata.cube)[:, 2][:, None] / 2.0))
        com3d.append(c3)
        gt1.append(np.stack([f.gt3Dorig[crop_joint_idx] for f in seq.data]))
    gt1 = np.concatenate(gt1).astype(np.float32)[:, None, :]
    refined = np.concatenate(refined).astype(np.float32)[:, None, :]
    com3d = np.concatenate(com3d).astype(np.float32)[:, None, :]
    results = {"refined": eval_cls(gt1, refined), "com": eval_cls(gt1, com3d)}
    log(f"Refined CoM mean error: {results['refined'].getMeanError():.3f}mm, "
        f"max error: {results['refined'].getMaxError():.3f}mm")
    log(f"Raw CoM mean error: {results['com'].getMeanError():.3f}mm")
    metrics = {k: {"mean_mm": v.getMeanError(), "max_mm": v.getMaxError()}
               for k, v in results.items()}
    metrics["refined"]["n_test_frames"] = int(gt1.shape[0])
    if is_writer():
        np.save(os.path.join(outdir, f"result_{prefix}.npy"), refined)
        with open(os.path.join(outdir, "results.json"), "w") as fh:
            json.dump(metrics, fh, indent=1)
    return state, results, hist


def load_serving_net(model_name="poseregnet", ref_pickle=None, checkpoint=None,
                     device=None):
    """Model and prior for the serving entry points (demo_realtime,
    serve_http), resolved as the JAX ``load_serving_net`` resolves them:

    - ``ref_pickle``: a reference-trained .pkl[.gz] of family ``model_name``
      (``utils.refweights.model_from_reference_pickle``); it must carry its
      appended PCA decode layer (the network_prior.pkl the reference mains
      save), and then no prior is returned; a pickle that emits the bare
      embedding raises SystemExit;
    - else ``model_name``'s serving net, PoseRegNet type 0 or ResNet-47
      type 0 with a 30-D output (hidden 1024, float32): with
      ``checkpoint`` (a network_prior.ckpt of ``run_posereg_embedding``) its
      trained weights, BatchNorm statistics and PCA prior (a missing file
      raises FileNotFoundError, a checkpoint of the other family
      ValueError); without, weights from ``torch.Generator`` seed 0 and a
      random (30, 42) PCA prior from numpy seed 0 (pipeline smoke mode).

    Returns (model on ``device``, prior or None)."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.train.checkpoint import checkpoint_config, load_checkpoint

    device = torch.device(device) if device else default_device()
    if ref_pickle:
        from deepprior_tpu_torch.utils.refweights import model_from_reference_pickle

        model, needs_prior = model_from_reference_pickle(ref_pickle, model_name)
        if needs_prior:
            raise SystemExit(
                "this pickle emits the PCA embedding without the decode layer; use "
                "the network_prior.pkl form the reference main saved (decode "
                "appended), or a --checkpoint that carries the prior")
        return model.to(device), None  # the appended decode layer decodes
    gen = torch.Generator().manual_seed(0)
    if model_name == "resnet":
        model = ResNet(ResNetConfig(num_joints=1, n_dims=30), generator=gen)
    elif model_name == "poseregnet":
        model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30), generator=gen)
    else:
        raise ValueError(f"unknown model {model_name!r}")
    if checkpoint:
        stored = checkpoint_config(checkpoint)
        # checkpoints written before the family was recorded hold PoseRegNets
        family = (stored.get("model", "poseregnet") if isinstance(stored, dict)
                  else "poseregnet")
        if family != model_name:
            raise ValueError(f"{checkpoint} holds a {family} (its config says so), not a "
                             f"{model_name}: pass --model {family}")
        tree = {
            "params": model.state_dict(),
            "pca_components": np.zeros((30, 42), np.float32),
            "pca_mean": np.zeros(42, np.float32),
        }
        tree, _ = load_checkpoint(checkpoint, tree)
        model.load_state_dict(tree["params"])
        prior = PCAPrior(tree["pca_components"], tree["pca_mean"])
    else:
        rng = np.random.default_rng(0)
        prior = PCAPrior(
            components=rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
            mean=np.zeros(42, np.float32),
        )
    return model.to(device), prior
