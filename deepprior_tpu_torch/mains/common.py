"""Shared pieces of the port's entry points (counterpart of mains/common.py).

``run_posereg_embedding`` is the flagship recipe (reference
main_nyu_posereg_embedding.py:38-205): import (or synthesize) -> PCA prior
from sampled poses -> PoseRegNet (or, with --model resnet, ResNet-47)
30-D embedding training with augmentation -> network_prior.ckpt -> decode
-> metrics -> results.json.  With --model v2v it trains V2V-PoseNet
(models/v2v.py) on occupancy grids of the same crops, with V2V's recipe
(RMSProp, --lr 2.5e-4 and --batch-size 8 unless given), no PCA prior, and
decodes its heatmaps to mm.  ``run_com_refine`` is the CoM-refinement
recipe (reference main_nyu_com_refine.py): ScaleNet over docom crops ->
net_<prefix>.ckpt, which an importer's ``load_refine_net_lazy`` reads.
Both train resident (``Trainer.fit``) or, with --streamed, from host
memory (``Trainer.fit_streamed``), write a rolling snapshot
<out>/<prefix>/net_last.ckpt, and continue from it with --resume.
``load_serving_net`` gives the serving entry points their model and
prior: random weights, the trained ones from a network_prior.ckpt, or a
reference-trained pickle.

Every run writes the reference's plots beside results.json: the training
curves, each test sequence's threshold curve and per-joint bars, and the
skeleton overlays of every 20th frame of the first test sequence.
--accept adds the acceptance gate (``_acceptance``): the combined test
set against the dataset's shipped baseline predictions and a mean-error
threshold, recorded in results.json, with a non-zero exit on a miss.
Plots are files and no part of the device path: where matplotlib is
missing, the main logs one line for each plot file it could not write and
goes on.

Under torchrun (``torchrun --nproc-per-node N -m <main> --dp D --sp S --tp
T``) every rank runs the main: ``make_trainer`` builds a
``DistributedTrainer`` over the ('dp', 'sp', 'tp') mesh, each rank trains
its rows of every batch on its card (under sp, its block of rows of the
crops' maps), and only rank 0 logs and writes results.json and
network_prior.ckpt (whole tensors under tp); --sharded-snapshots makes the
rolling snapshot a directory every rank writes its shards into.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from deepprior_tpu_torch.device import default_device

# the shipped baseline predictions --accept compares with (the JAX mains'
# specs): Tompson et al.'s on NYU, Tang et al.'s LRF on ICVL; MSRA15 ships none
NYU_BASELINE = {"label": "Tompson et al.",
                "relpath": os.path.join("test", "test_predictions.mat"), "kind": "mat"}
ICVL_BASELINE = {"label": "Tang et al.", "relpath": "LRF_Results_seq_1.txt", "kind": "txt"}

# poses the PCA prior samples from imported and from synthetic frames, the
# JAX mains' recipe constants
PRIOR_POSES = 1_000_000
PRIOR_POSES_SYNTHETIC = 50_000

# --lr and --batch-size when not given: the flagship recipe's, and V2V's
# (the paper's RMSProp at 2.5e-4, batch 8)
RECIPE_DEFAULTS = {"lr": 0.001, "batch_size": 128}
V2V_DEFAULTS = {"lr": 2.5e-4, "batch_size": 8}


def base_parser(desc: str) -> argparse.ArgumentParser:
    """The JAX mains' flags."""
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
    p.add_argument("--batch-size", type=int, default=None,
                   help="default 128; 8 with --model v2v")
    p.add_argument("--lr", type=float, default=None,
                   help="default 0.001; 2.5e-4 with --model v2v")
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
                   choices=["poseregnet", "resnet", "v2v"],
                   help="regressor family: PoseRegNet, ResNet-47 (the "
                        "reference's best results and realtime demo), or "
                        "V2V-PoseNet (3D heatmaps from voxelized crops; "
                        "training only, RMSProp)")
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
                   help="spatial ranks: the crop height splits over them, with "
                        "halo exchanges around the convolutions; more than one "
                        "needs torchrun")
    p.add_argument("--sharded-snapshots", action="store_true",
                   help="write the rolling snapshot as a sharded directory "
                        "(torch.distributed.checkpoint, async, every rank its "
                        "shards); --resume reads either format")
    p.add_argument("--accept", action="store_true",
                   help="acceptance mode: evaluate the combined test set against "
                        "the shipped baseline predictions, write the paper's "
                        "curves, and exit non-zero unless the mean error beats "
                        "the threshold")
    p.add_argument("--accept-mm", type=float, default=None,
                   help="acceptance threshold in mm (default: the dataset's "
                        "BASELINE.md rebuild target)")
    p.add_argument("--baseline-file", default=None,
                   help="baseline predictions file (default: the dataset's "
                        "shipped file under --data, e.g. NYU "
                        "test/test_predictions.mat or ICVL LRF_Results_seq_1.txt)")
    return p


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
    ('dp', 'sp', 'tp') mesh of the process group (counterpart of the JAX
    ``make_trainer``).  Nothing falls back quietly: dp, sp or tp above 1
    without a process group, or a group whose world is not dp x sp x tp,
    raises and names the launcher."""
    from deepprior_tpu_torch.train.trainer import Trainer

    if not check_world(dp, tp, sp):
        return Trainer(model, cfg, camera, prior=prior, device=device)
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh

    return DistributedTrainer(model, cfg, camera,
                              make_mesh(dp=dp, tp=tp or 1, sp=sp or 1),
                              prior=prior, device=device)


def check_world(dp=None, tp=1, sp=1) -> bool:
    """Whether the run is distributed (a process group exists); raises when
    the flags and the process group disagree: dp, sp or tp above 1 without
    a group, or a group whose world is not dp x sp x tp."""
    import torch.distributed as dist

    from deepprior_tpu_torch.parallel.multihost import LAUNCHER

    tp, sp = tp or 1, sp or 1
    if not dist.is_initialized():
        if (dp or 1) * sp * tp > 1:
            raise RuntimeError(
                f"--dp {dp or 1} --sp {sp} --tp {tp} needs one process per device "
                f"under a process group; launch with {LAUNCHER}")
        return False
    world = dist.get_world_size()
    if world % (sp * tp) or (dp is not None and dp * sp * tp != world):
        raise RuntimeError(
            f"the process group has {world} ranks, but --dp {dp} x --sp {sp} x --tp "
            f"{tp} asks for {(dp or world // (sp * tp)) * sp * tp}; launch with "
            f"{LAUNCHER} where N = dp x sp x tp")
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


# ---------------------------------------------------------------------------
# the epilogue: plots, baselines, the acceptance gate
# ---------------------------------------------------------------------------
def _plots(log, paths, draw):
    """``draw()``, which writes the plot files ``paths``; where matplotlib
    is missing, one line for each file it could not write instead."""
    try:
        return draw()
    except ImportError as exc:
        if "matplotlib" not in str(exc):
            raise
        for path in paths:
            log(f"plot not written ({exc}): {path}")
        return []


def _evaluation_files(outdir, name):
    return [os.path.join(outdir, f"{name}_{kind}.pdf")
            for kind in ("frameswithin", "meanerror", "maxerror")]


def _load_baseline_predictions(args, importer_cls, baseline_spec, gt_full):
    """The shipped baseline predictions (reference main_nyu_posereg_embedding.py:
    192, main_icvl:184): --baseline-file, else the spec's ``relpath`` under
    --data; a Tompson .mat through ``loadBaseline`` with the ground truth's
    depths, an LRF .txt as it is.  Returns (predictions cut to gt_full's
    frames, path), or (None, None) without a spec or a file.  The importer
    only parses the file here, on the host."""
    bl_path = args.baseline_file
    if bl_path is None and args.data and baseline_spec:
        cand = os.path.join(args.data, baseline_spec["relpath"])
        bl_path = cand if os.path.isfile(cand) else None
    if not (bl_path and baseline_spec):
        return None, None
    imp = importer_cls(args.data or os.path.dirname(bl_path) or ".", device="cpu")
    if baseline_spec["kind"] == "mat":
        preds = imp.loadBaseline(bl_path, gt=gt_full)
    else:
        preds = imp.loadBaseline(bl_path)
    return np.asarray(preds[: gt_full.shape[0]], np.float32), bl_path


def _plot_training_curves(hist, outdir, prefix, log=print):
    """The semilogy cost and validation-error curves, written after every
    run (main_nyu_posereg_embedding.py:133-142, main_nyu_com_refine.py:
    198-207).  Returns the files written."""
    series = [(hist.get(key), os.path.join(outdir, f"{prefix}_{tag}.png"))
              for key, tag in (("train_cost", "cost"), ("val_error_mm", "errs"))]
    series = [(values, path) for values, path in series if values]

    def draw():
        from deepprior_tpu_torch.eval.plots import pyplot

        plt = pyplot()
        for values, path in series:
            fig = plt.figure()
            plt.semilogy(np.asarray(values))
            fig.savefig(path)
            plt.close(fig)
        return [path for _, path in series]

    return _plots(log, [path for _, path in series], draw)


def _plot_overlays(hpe, camera, seq, joints, prefix, stride=20, log=print):
    """The 2D skeleton overlays of every ``stride``-th frame of one test
    sequence (main_nyu_posereg_embedding.py:199-205); ``joints`` are the
    predicted (N, J, 3) mm poses of ``seq.data``.  Returns the files."""
    from deepprior_tpu_torch.geometry import transform_points_2d_np

    inds = range(0, len(seq.data), stride)

    def draw():
        written = []
        for ind in inds:
            fr = seq.data[ind]
            jt2d = transform_points_2d_np(camera.three_d_to_img_np(joints[ind]), fr.T)
            written.append(hpe.plotResult(fr.dpt, fr.gtcrop, jt2d, name=f"{prefix}_{ind}"))
        return written

    return _plots(log, [os.path.join(hpe.subfolder, f"{prefix}_{i}.png") for i in inds],
                  draw)


def _verdict(rec, what, log):
    status = "PASS" if rec["pass"] else "FAIL"
    if rec["synthetic"]:
        status += " (synthetic smoke)"
    log(f"acceptance [{status}]: {what} {rec['mean_mm']:.3f}mm vs threshold "
        f"{rec['threshold_mm']:.3f}mm over {rec['n_test_frames']} frames")


def _acceptance(args, importer_cls, camera, eval_cls, tests, all_gt3d, all_joints,
                outdir, prefix, baseline_spec, accept_mm, log=print):
    """The acceptance gate: the reference's baseline comparison
    (main_nyu_posereg_embedding.py:161-205) as one command.  One evaluation
    over the combined test set (main:163-166), the shipped baseline
    predictions (``_load_baseline_predictions``), the threshold curve and
    per-joint bars with the baseline overlaid (main:197), and the
    threshold: --accept-mm, else ``accept_mm``.

    Returns the record for results.json (mean_mm, max_mm, threshold_mm,
    n_test_frames, synthetic, baseline, pass); the caller exits non-zero
    when it did not pass."""
    thr = args.accept_mm if args.accept_mm is not None else accept_mm
    gt = np.concatenate(all_gt3d, axis=0)
    joints = np.concatenate(all_joints, axis=0)
    hpe = eval_cls(gt, joints)
    hpe.subfolder = outdir
    rec = {"mean_mm": float(hpe.getMeanError()),
           "max_mm": float(hpe.getMaxError()),
           "threshold_mm": float(thr),
           "n_test_frames": int(gt.shape[0]),
           # a synthetic run tests the harness; it is no evidence against
           # the real dataset's target
           "synthetic": bool(getattr(args, "synthetic", False))}
    baseline = []
    preds, bl_path = _load_baseline_predictions(args, importer_cls, baseline_spec, gt)
    if preds is not None:
        hpe_base = eval_cls(gt[: preds.shape[0]], preds)
        hpe_base.subfolder = outdir
        baseline = [(baseline_spec["label"], hpe_base)]
        rec["baseline"] = {"label": baseline_spec["label"],
                           "mean_mm": float(hpe_base.getMeanError()),
                           "file": bl_path}
        log(f"baseline {baseline_spec['label']}: mean {hpe_base.getMeanError():.3f}mm")
    name = f"{prefix}_accept"
    _plots(log, _evaluation_files(outdir, name),
           lambda: hpe.plotEvaluation(name, methodName="Our regr", baseline=baseline))
    rec["pass"] = bool(rec["mean_mm"] < thr)
    _verdict(rec, "mean", log)
    return rec


def _fail_unless_passed(rec):
    if rec is not None and not rec["pass"]:
        raise SystemExit(f"acceptance FAILED: {rec['mean_mm']:.3f}mm >= "
                         f"{rec['threshold_mm']:.3f}mm")


def _model_dtype(args):
    return torch.bfloat16 if args.bf16 else torch.float32


def recipe_value(args, key: str, defaults=RECIPE_DEFAULTS):
    """--lr or --batch-size as given, else ``defaults``'s."""
    given = getattr(args, key)
    return defaults[key] if given is None else given


def _refuse_one_device_family(family: str, where: str):
    """Raise ValueError where a serving path is handed the v2v family, which
    trains on one device only."""
    if family == "v2v":
        raise ValueError(f"{where} does not take v2v: V2V-PoseNet trains on one device "
                         f"only; serving it is not supported")


def run_posereg_embedding(args, importer_cls, camera, train_seq, test_seqs, num_joints,
                          eval_cls=None, n_pca: int = 30, baseline_spec=None,
                          accept_mm: float = 10.0, log=print, v2v=None):
    """The flagship recipe.

    baseline_spec ({"label", "relpath", "kind": "mat" or "txt"}) and
    accept_mm (the BASELINE.md mean-error target) configure --accept.

    ``--model resnet`` trains ResNet-47 of head type ``--resnet-type``
    (default 2, the dropout head); weight decay applies iff the net has no
    dropout or --weightreg > 0 asks for it.  ``--model v2v`` trains
    V2V-PoseNet (its published grid, or ``v2v``'s ``V2VConfig`` fields)
    with RMSProp and no PCA prior into <out>/<train_seq>_V2V; its test
    joints are its heatmaps decoded to mm.  The PCA prior samples
    ``PRIOR_POSES`` poses from imported data, ``PRIOR_POSES_SYNTHETIC``
    from synthetic.  Returns (state, {seq name: evaluation}, training
    history) and writes
    <out>/<prefix>/network_prior.ckpt (the trained weights, a ResNet's
    BatchNorm statistics and the PCA prior, fingerprinted with the
    TrainConfig and the family; ``load_serving_net`` reads it),
    <out>/<prefix>/net_last.ckpt (the rolling snapshot),
    <out>/<prefix>/results.json with the JAX main's metrics (and with
    --accept its acceptance record; a miss then raises SystemExit after the
    file is written) and the plots."""
    from deepprior_tpu_torch.eval.metrics import HandposeEvaluation
    from deepprior_tpu_torch.models import (PoseRegNet, PoseRegNetConfig, ResNet,
                                            ResNetConfig, V2VConfig, V2VPoseNet)
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.parallel.multihost import is_writer
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData

    eval_cls = eval_cls or HandposeEvaluation
    device = main_device(args)
    check_world(args.dp, args.tp, args.sp)
    log = rank_log(log)
    voxel = args.model == "v2v"
    prefix = args.eval_prefix or (f"{train_seq}_V2V" if voxel else f"{train_seq}_EMB_PCA{n_pca}")
    outdir = os.path.join(args.out, prefix)
    os.makedirs(outdir, exist_ok=True)

    def stamp(msg):
        log(f"[{time.strftime('%H:%M:%S')}] {msg}")

    stamp(f"device={device} loading data...")
    train, tests = load_or_synthesize(args, importer_cls, camera, train_seq, test_seqs,
                                      num_joints)
    data = TrainData.from_sequence(train)
    val = TrainData.from_sequence(tests[0]) if tests else None

    prior = None
    if not voxel:
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
    if voxel:
        has_dropout = False
        model = V2VPoseNet(V2VConfig(num_joints=num_joints, dtype=dtype, **(v2v or {})))
    elif args.model == "resnet":
        has_dropout = args.resnet_type in (2, 3, 4)
        model = ResNet(ResNetConfig(num_joints=1, n_dims=n_pca, dropout=has_dropout,
                                    dtype=dtype))
    else:
        model = PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=n_pca, dtype=dtype))
    wr = args.weightreg
    recipe = V2V_DEFAULTS if voxel else RECIPE_DEFAULTS
    cfg = TrainConfig(
        batch_size=recipe_value(args, "batch_size", recipe),
        learning_rate=recipe_value(args, "lr", recipe),
        optimizer="rmsprop" if voxel else "adam",
        n_epochs=args.epochs, aug_modes=tuple(args.aug_modes), seed=args.seed,
        weightreg_factor=wr, model_has_dropout=has_dropout and wr <= 0.0,
        validation_frequency=args.validation_frequency,
        aug_fuse_norm=args.aug_fuse_norm, aug_resize=args.aug_resize,
    )
    trainer = make_trainer(model, cfg, camera, prior=prior, dp=args.dp, tp=args.tp,
                           sp=args.sp, device=device)
    trainer.sharded_snapshots = args.sharded_snapshots
    state, hist = _train(args, trainer, trainer.init_state(), data, val, outdir, log)
    if is_writer():
        _plot_training_curves(hist, outdir, prefix, log)

    # save the final net (BatchNorm statistics with it) + prior (the
    # reference appends the PCA decode layer and saves network_prior.pkl,
    # main:148-158); the fingerprint names the family
    family = {"model": args.model}
    if args.model == "resnet":
        family["resnet_type"] = args.resnet_type
    params = serving_state_dict(trainer, state)
    if is_writer():
        tree = {"params": params}
        if prior is not None:
            tree.update(pca_components=prior.components, pca_mean=prior.mean)
        save_checkpoint(os.path.join(outdir, "network_prior.ckpt"), tree,
                        config=dict(cfg._asdict(), **family))

    # test: decode to mm and the metric suite (main:161-205)
    metrics, results = {}, {}
    all_gt3d, all_joints = [], []
    for seq in tests:
        joints = trainer.predict_joints(state, TrainData.from_sequence(seq))
        gt3d = np.stack([f.gt3Dorig for f in seq.data])
        all_gt3d.append(gt3d)
        all_joints.append(joints)
        hpe = eval_cls(gt3d, joints)
        hpe.subfolder = outdir
        log(f"{seq.name}: mean {hpe.getMeanError():.3f}mm "
            f"max {hpe.getMaxError():.3f}mm")
        if is_writer():
            name = f"{prefix}_{seq.name}"
            _plots(log, _evaluation_files(outdir, name), lambda: hpe.plotEvaluation(name))
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
    accept_rec = None
    if is_writer() and tests:
        # the overlays of the first test sequence, on every run (main:199-205)
        _plot_overlays(results[tests[0].name], camera, tests[0], all_joints[0], prefix,
                       log=log)
        if args.accept:
            accept_rec = metrics["acceptance"] = _acceptance(
                args, importer_cls, camera, eval_cls, tests, all_gt3d, all_joints, outdir,
                prefix, baseline_spec, accept_mm, log)
    if is_writer():
        with open(os.path.join(outdir, "results.json"), "w") as fh:
            json.dump(metrics, fh, indent=1)
    _fail_unless_passed(accept_rec)
    return state, results, hist


def run_com_refine(args, importer_cls, camera, train_seq, test_seqs, num_joints,
                   crop_joint_idx, eval_cls, baseline_spec=None, accept_mm=None,
                   log=print):
    """CoM-refinement training (reference main_nyu_com_refine.py): ScaleNet
    over docom crops, at batch min(--batch-size, 64) (main:164), with the
    augmentation (K5 on a CUDA device) and without early stopping
    (main:170); the labels are the crop joint's offset from the detected
    CoM.  Writes <out>/<prefix>/net_<prefix>.ckpt ({"params": the state
    dict}, fingerprinted with the TrainConfig; an importer's
    ``load_refine_net_lazy`` reads it), the rolling snapshot, and, with
    test sequences, result_<prefix>.npy (the refined CoMs as 1-joint poses,
    mm), results.json and the plots: the refined CoM, the shipped
    baseline's crop joint (``baseline_spec``; MSRA15 ships none) and the raw
    CoM against the crop joint, and the threshold curve with both baselines
    overlaid (main:198-257).  --accept gates the refined mean error on
    --accept-mm, else ``accept_mm``, else the raw CoM's mean (the refiner
    must beat the detector it refines).
    Returns (state, {"refined": evaluation, "com": evaluation}, history)."""
    from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.parallel.multihost import is_writer
    from deepprior_tpu_torch.train.checkpoint import save_checkpoint
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData

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
        batch_size=min(recipe_value(args, "batch_size"), 64),
        learning_rate=recipe_value(args, "lr"),
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
        _plot_training_curves(hist, outdir, prefix, log)
    if not tests:
        return state, {}, hist

    # refined CoM = offset * cube_z / 2 + the detected CoM (mm), as a
    # 1-joint pose against gt3Dorig[crop_joint] (main:215-233)
    gt_full, refined, com3d = [], [], []
    for seq in tests:
        tdata = to_refine_data(seq)
        pred = trainer.predict(state, tdata.crops)  # (N, 3)
        c3 = camera.img_to_3d_np(np.asarray(tdata.com))
        refined.append(c3 + pred * (np.asarray(tdata.cube)[:, 2][:, None] / 2.0))
        com3d.append(c3)
        gt_full.append(np.stack([f.gt3Dorig for f in seq.data]))
    gt_full = np.concatenate(gt_full).astype(np.float32)
    gt1 = gt_full[:, crop_joint_idx:crop_joint_idx + 1]
    refined = np.concatenate(refined).astype(np.float32)[:, None, :]
    com3d = np.concatenate(com3d).astype(np.float32)[:, None, :]
    results = {"refined": eval_cls(gt1, refined), "com": eval_cls(gt1, com3d)}
    for ev in results.values():
        ev.subfolder = outdir
    hpe, hpe_com = results["refined"], results["com"]
    log(f"Refined CoM mean error: {hpe.getMeanError():.3f}mm, "
        f"max error: {hpe.getMaxError():.3f}mm")
    metrics = {"refined": {"mean_mm": hpe.getMeanError(), "max_mm": hpe.getMaxError(),
                           "n_test_frames": int(gt1.shape[0])}}
    # baseline 1: the shipped predictions' crop joint (main:240-244)
    baseline = []
    preds, bl_path = _load_baseline_predictions(args, importer_cls, baseline_spec, gt_full)
    if preds is not None:
        preds1 = preds[:, crop_joint_idx:crop_joint_idx + 1]
        hpe_base = eval_cls(gt1[: preds1.shape[0]], preds1)
        hpe_base.subfolder = outdir
        log(f"Baseline {baseline_spec['label']} crop-joint mean error: "
            f"{hpe_base.getMeanError():.3f}mm")
        baseline.append((baseline_spec["label"], hpe_base))
        metrics["baseline"] = {"label": baseline_spec["label"],
                               "mean_mm": hpe_base.getMeanError(), "file": bl_path}
    # baseline 2: the raw detected CoM (main:246-250)
    log(f"Raw CoM mean error: {hpe_com.getMeanError():.3f}mm")
    metrics["com"] = {"mean_mm": hpe_com.getMeanError(), "max_mm": hpe_com.getMaxError()}
    baseline.append(("CoM", hpe_com))
    accept_rec = None
    if args.accept:
        thr = args.accept_mm if args.accept_mm is not None else accept_mm
        if thr is None:
            thr = hpe_com.getMeanError()
        accept_rec = metrics["acceptance"] = {
            "mean_mm": float(hpe.getMeanError()),
            "com_mean_mm": float(hpe_com.getMeanError()),
            "threshold_mm": float(thr),
            "n_test_frames": int(gt1.shape[0]),
            "synthetic": bool(args.synthetic),
        }
        accept_rec["pass"] = bool(accept_rec["mean_mm"] < thr)
        _verdict(accept_rec, "refined", log)
    if is_writer():
        np.save(os.path.join(outdir, f"result_{prefix}.npy"), refined)
        # the threshold curve and bars with the baselines overlaid
        # (main_msra15_com_refine.py:257)
        _plots(log, _evaluation_files(outdir, prefix),
               lambda: hpe.plotEvaluation(prefix, methodName="Refined CoM",
                                          baseline=baseline))
        with open(os.path.join(outdir, "results.json"), "w") as fh:
            json.dump(metrics, fh, indent=1)
    _fail_unless_passed(accept_rec)
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
      ``checkpoint`` (a network_prior.ckpt of ``run_posereg_embedding``, or
      one the JAX package's training main wrote) its trained weights,
      BatchNorm statistics and PCA prior (a missing file raises
      FileNotFoundError, a checkpoint of the other family ValueError: the
      port's config names the family, a JAX checkpoint's flax tree shows
      it); without, weights from ``torch.Generator`` seed 0 and a random
      (30, 42) PCA prior from numpy seed 0 (pipeline smoke mode).

    The v2v family (V2V-PoseNet, by name or as a checkpoint's family) is
    refused with ValueError: it trains on one device only.

    Returns (model on ``device``, prior or None)."""
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
    from deepprior_tpu_torch.prior import PCAPrior
    from deepprior_tpu_torch.train.checkpoint import load_checkpoint, read_checkpoint

    _refuse_one_device_family(model_name, "load_serving_net")
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
        stored = read_checkpoint(checkpoint)  # a JAX file is decoded once
        # checkpoints written before the family was recorded hold PoseRegNets
        family = stored[2] or "poseregnet"
        _refuse_one_device_family(family, f"load_serving_net ({checkpoint})")
        if family != model_name:
            raise ValueError(f"{checkpoint} holds a {family}, not a {model_name}: pass "
                             f"--model {family}")
        tree = {
            "params": model.state_dict(),
            "pca_components": np.zeros((30, 42), np.float32),
            "pca_mean": np.zeros(42, np.float32),
        }
        tree, _ = load_checkpoint(checkpoint, tree, stored=stored)
        model.load_state_dict(tree["params"])
        prior = PCAPrior(tree["pca_components"], tree["pca_mean"])
    else:
        rng = np.random.default_rng(0)
        prior = PCAPrior(
            components=rng.standard_normal((30, 42)).astype(np.float32) * 0.05,
            mean=np.zeros(42, np.float32),
        )
    return model.to(device), prior
