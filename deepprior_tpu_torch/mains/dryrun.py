"""The scale-out dry run: the distributed training path end to end on small
shapes (counterpart of __graft_entry__.py::dryrun_multichip).

    torchrun --nproc-per-node N -m deepprior_tpu_torch.mains.dryrun [--device cpu]
    python -m deepprior_tpu_torch.mains.dryrun --device cpu
    python -m deepprior_tpu_torch.mains.dryrun            # one card, a world of 1

Under torchrun every rank runs the legs over the launched group (NCCL on
the cards, gloo with --device cpu).  Without torchrun it spawns 4 gloo
ranks itself on the CPU, or runs a world of one rank on the card.  On CUDA
the process runs deterministic algorithms: the resume leg is bit-identical
only with them.  The
legs, each over the ('dp', 'tp') mesh of the group (tp 2 where the world
is even):

- PoseRegNet (hidden 1024, PCA 30) at a global batch of 2 per rank, the
  augmentation on (K5 on the card), the data split over dp
  (``place_data(shard=True)``);
- a depth-11 ResNet: BatchNorm's statistics over the global batch;
- with 4k ranks, the ('dp', 'sp', 'tp') mesh of sp 2 and tp 2 (the crop
  height split over two ranks, halo exchanges around the convolutions),
  the PoseRegNet leg again on the whole data;
- with 4k ranks, the ('dcn', 'dp', 'tp') mesh of 2 slices;
- a sharded snapshot after epoch 0, resumed by a fresh trainer: the
  parameters bit-equal to an uninterrupted run's;
- fit_streamed over the mesh against a single-device fit_streamed: the loss
  trace within rtol 1e-3 (the JAX dry run's bound).

Rank 0 prints ``dryrun_multichip OK ...``; any failure raises.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def dryrun(rank: int, world: int, device: str = "cpu") -> str:
    """The legs on this rank of an initialized group of ``world`` ranks.
    Returns the summary line."""
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.data.synthetic import make_sequence
    from deepprior_tpu_torch.models import PoseRegNet, PoseRegNetConfig, ResNet, ResNetConfig
    from deepprior_tpu_torch.parallel import DistributedTrainer, make_mesh
    from deepprior_tpu_torch.prior import fit_pose_prior
    from deepprior_tpu_torch.train.trainer import TrainConfig, TrainData, Trainer

    dev = torch.device("cpu")
    if device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(tp=tp)
    cam = NYU_CAMERA
    n = 2 * world
    data = TrainData.from_sequence(make_sequence(cam, 2 * n, num_joints=14, seed=1))
    prior = fit_pose_prior(cam, np.random.default_rng(23455), data.gt3d_crop, data.com,
                           data.cube, 30, num_poses=2000)

    def pose():
        return PoseRegNet(PoseRegNetConfig(num_joints=1, n_dims=30))

    def trainer(model, cfg, m=mesh):
        return DistributedTrainer(model, cfg, cam, m, prior=prior, device=dev)

    quiet = dict(log=lambda msg: None)
    cfg = TrainConfig(batch_size=n, learning_rate=0.003, n_epochs=1,
                      aug_modes=("com", "rot", "none"))
    tr = trainer(pose(), cfg)
    _, hist = tr.fit(tr.init_state(), tr.place_data(data, shard=True), **quiet)
    cost = np.asarray(hist["train_cost"])
    assert np.isfinite(cost).all(), "non-finite cost in the dry run"

    rcfg = cfg._replace(model_has_dropout=False)
    tr = trainer(ResNet(ResNetConfig(num_joints=1, n_dims=30, depth=11,
                                     stages=(8, 16, 16, 16, 16))), rcfg)
    _, hist = tr.fit(tr.init_state(), tr.place_data(data), **quiet)
    rcost = np.asarray(hist["train_cost"])
    assert np.isfinite(rcost).all(), "non-finite ResNet cost in the dry run"

    # the spatial leg: the crop height split over 'sp' (parallel/spatial.py)
    sp_msg = "sp skipped (needs a multiple of 4 ranks)"
    if world % 4 == 0:
        smesh = make_mesh(sp=2, tp=tp)
        tr = trainer(pose(), cfg, smesh)
        _, hist = tr.fit(tr.init_state(), tr.place_data(data), **quiet)
        scost = np.asarray(hist["train_cost"])
        assert np.isfinite(scost).all(), "non-finite cost in the sp dry run"
        sp_msg = (f"sp mesh {dict(zip(smesh.mesh_dim_names, smesh.shape))} "
                  f"cost {scost.mean():.4f}")

    dcn_msg = "dcn skipped (needs a multiple of 4 ranks)"
    if world % 4 == 0:
        dmesh = make_mesh(slices=2, tp=tp)
        tr = trainer(pose(), cfg, dmesh)
        _, hist = tr.fit(tr.init_state(), tr.place_data(data, shard=True), **quiet)
        dcost = np.asarray(hist["train_cost"])
        assert np.isfinite(dcost).all(), "non-finite cost in the dcn dry run"
        dcn_msg = (f"dcn mesh {dict(zip(dmesh.mesh_dim_names, dmesh.shape))} "
                   f"cost {dcost.mean():.4f}")

    # a sharded snapshot after epoch 0, resumed bit for bit
    cfg2 = cfg._replace(n_epochs=2, aug_modes=None, use_early_stopping=False,
                        snapshot_every=1)
    t1 = trainer(pose(), cfg2)
    s1, _ = t1.fit(t1.init_state(), data, **quiet)
    tmp = tempfile.mkdtemp(prefix="dryrun_ckpt_") if rank == 0 else None
    if world > 1:
        box = [tmp]
        dist.broadcast_object_list(box, src=0)
        tmp = box[0]
    try:
        t2 = trainer(pose(), cfg2)
        t2.sharded_snapshots = True
        t2.fit(t2.init_state(), data, n_epochs=1, snapshot_path=f"{tmp}/snap", **quiet)
        t3 = trainer(pose(), cfg2)
        s3, start = t3.load_train_state(f"{tmp}/snap_last.ckpt", t3.init_state())
        assert start == 1, f"resume epoch {start} != 1"
        s3, _ = t3.fit(s3, data, start_epoch=start, **quiet)
        want, got = t1.full_state_dict(s1), t3.full_state_dict(s3)
        assert all(torch.equal(got[k], v) for k, v in want.items()), \
            "the sharded-snapshot resume diverged from the uninterrupted run"
    finally:
        if world > 1:
            dist.barrier()
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)

    arrays = {k: np.asarray(getattr(data, k)) for k in TrainData._fields}
    single = Trainer(pose(), cfg2, cam, prior=prior, device=dev)
    _, hs = single.fit_streamed(single.init_state(), arrays, **quiet)
    tr = trainer(pose(), cfg2)
    _, hd = tr.fit_streamed(tr.init_state(), arrays, **quiet)
    c_s, c_d = np.asarray(hs["train_cost"]), np.asarray(hd["train_cost"])
    assert np.isfinite(c_d).all(), "non-finite cost in the streamed dry run"
    assert np.allclose(c_s, c_d, rtol=1e-3), f"streamed mesh trace diverged: {c_s} vs {c_d}"
    return (f"dryrun_multichip OK on {world} devices ({dev.type}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}), poseregnet cost "
            f"{cost.mean():.4f}, resnet cost {rcost.mean():.4f}, {sp_msg}, {dcn_msg}, "
            f"sharded-ckpt resume bit-identical, fit_streamed mesh trace ok ({c_d.mean():.4f})")


def _rank_main(rank, world):
    line = dryrun(rank, world, "cpu")
    if rank == 0:
        print(line, flush=True)


def main(argv=None):
    from deepprior_tpu_torch.device import default_device
    from deepprior_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the ranks' device")
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    if "WORLD_SIZE" in os.environ:  # under torchrun
        multihost.initialize(device=device.type)
        rank = dist.get_rank()
        try:
            line = dryrun(rank, dist.get_world_size(), device.type)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            print(line, flush=True)
        return line
    if device.type == "cpu":
        multihost.spawn_cpu(_rank_main, 4)
        return None
    # one card: a world of one rank
    tmp = tempfile.mkdtemp(prefix="dryrun_store_")
    try:
        multihost.initialize(store=dist.FileStore(os.path.join(tmp, "store"), 1),
                             num_processes=1, process_id=0, device="cuda")
        try:
            line = dryrun(0, 1, "cuda")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
