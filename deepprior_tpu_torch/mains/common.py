"""Shared pieces of the port's entry points (counterpart of mains/common.py).

``run_posereg_embedding`` is the flagship recipe (reference
main_nyu_posereg_embedding.py:38-205) on synthetic data: frames -> PCA
prior from sampled poses -> PoseRegNet (or, with --model resnet,
ResNet-47) 30-D embedding training with augmentation -> network_prior.ckpt
-> decode -> metrics -> results.json.  ``load_serving_net`` gives the
serving entry points their model and prior: random weights, the trained
ones from a network_prior.ckpt, or a reference-trained pickle.
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
    "data": "real datasets need the importers (ROADMAP.md Queue 1 item 17); "
            "use --synthetic",
    "parallel": "--dp/--tp/--sp and --sharded-snapshots need the scale-out "
                "port (ROADMAP.md Queue 1 item 19)",
    "resume": "--resume needs training snapshots (ROADMAP.md Queue 1 item 13)",
    "streamed": "--streamed needs fit_streamed (ROADMAP.md Queue 1 item 13)",
    "accept": "--accept needs the baseline loaders and plots (ROADMAP.md "
              "Queue 1 item 20)",
}


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
    p.add_argument("--data", default=None, help="dataset base path (not ported)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on synthetic data (no dataset required)")
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
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu only when asked for)")
    # not ported yet: parsed so that asking for them fails loudly
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--streamed", action="store_true")
    p.add_argument("--accept", action="store_true")
    p.add_argument("--sharded-snapshots", action="store_true")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag the port does not have yet."""
    if args.data is not None:
        raise NotImplementedError(_TODO["data"])
    if args.dp is not None or args.tp != 1 or args.sp != 1 or args.sharded_snapshots:
        raise NotImplementedError(_TODO["parallel"])
    for flag in ("resume", "streamed", "accept"):
        if getattr(args, flag):
            raise NotImplementedError(_TODO[flag])


def load_or_synthesize(args, camera, train_seq, test_seqs, num_joints):
    """Synthetic (train ImageSequence, [test ImageSequences]): 256 train
    frames unless --nmax, and test sequences of max(32, n // 8) frames,
    seeded as the JAX mains seed them."""
    from deepprior_tpu_torch.data.synthetic import make_sequence

    n_train = 256 if np.isinf(args.nmax) else int(args.nmax)
    train = make_sequence(camera, n_train, num_joints=num_joints,
                          seed=args.seed, name=train_seq)
    tests = [
        make_sequence(camera, max(32, n_train // 8), num_joints=num_joints,
                      seed=args.seed + 1 + i, name=name)
        for i, name in enumerate(test_seqs)
    ]
    return train, tests


def run_posereg_embedding(args, camera, train_seq, test_seqs, num_joints,
                          n_pca: int = 30, log=print):
    """The flagship recipe on synthetic data.

    ``--model resnet`` trains ResNet-47 of head type ``--resnet-type``
    (default 2, the dropout head); weight decay applies iff the net has no
    dropout or --weightreg > 0 asks for it.  Returns (state, {seq name:
    HandposeEvaluation}, training history) and writes
    <out>/<prefix>/network_prior.ckpt (the trained weights, a ResNet's
    BatchNorm statistics and the PCA prior, fingerprinted with the
    TrainConfig and the family; ``load_serving_net`` reads it) and
    <out>/<prefix>/results.json with the JAX main's metrics."""
    from deepprior_tpu_torch.eval.metrics import HandposeEvaluation
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    check_ported(args)
    device = torch.device(args.device) if args.device else default_device()
    prefix = args.eval_prefix or f"{train_seq}_EMB_PCA{n_pca}"
    outdir = os.path.join(args.out, prefix)
    os.makedirs(outdir, exist_ok=True)

    def stamp(msg):
        log(f"[{time.strftime('%H:%M:%S')}] {msg}")

    stamp(f"device={device} making synthetic data...")
    train, tests = load_or_synthesize(args, camera, train_seq, test_seqs,
                                      num_joints)
    data = TrainData.from_sequence(train)
    val = TrainData.from_sequence(tests[0]) if tests else None

    stamp(f"{data.n} train frames; fitting pose prior...")
    rng = np.random.default_rng(args.seed)
    prior = fit_pose_prior(
        camera, rng, data.gt3d_crop, data.com, data.cube,
        n_components=n_pca, num_poses=50_000, aug_modes=tuple(args.aug_modes),
    )
    stamp("prior ready; training...")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
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
    trainer = Trainer(model, cfg, camera, prior=prior, device=device)
    state = trainer.init_state()
    t0 = time.time()
    state, hist = trainer.fit(state, data, val_data=val, log=log)
    log(f"training took {time.time() - t0:.1f}s")

    # save the final net (a ResNet's BatchNorm statistics with it) + prior
    # (the reference appends the PCA decode layer and saves
    # network_prior.pkl, main:148-158); the fingerprint names the family
    family = {"model": args.model}
    if args.model == "resnet":
        family["resnet_type"] = args.resnet_type
    save_checkpoint(
        os.path.join(outdir, "network_prior.ckpt"),
        {
            "params": state.model.state_dict(),
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
        hpe = HandposeEvaluation(gt3d, joints)
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
