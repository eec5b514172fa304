"""Realtime pipeline demo on the port (counterpart of mains/demo_realtime.py;
reference src/test_realtimepipeline.py): drives the fused estimator from a
synthetic camera, detecting the hand on the device, and reports fps.

    python -m deepprior_tpu_torch.mains.demo_realtime --frames 100 [--threaded] [--comref]

Random weights (PoseRegNet type 0, 30-D PCA prior; with --comref a
full-width ScaleNet CoM refiner).  --device is the torch device, cuda by
default; without a card the demo raises unless given --device cpu.  The
camera is the synthetic one; the JAX demo's camera spellings are accepted:
--device synthetic means the default torch device, and --device capture is
not ported.
"""

import argparse

import torch

from deepprior_tpu_torch.mains.common import _TODO, default_device, load_serving_net

_CAPTURE_TODO = ("the native capture device needs cpp/capture.cpp and "
                 "CaptureDevice (ROADMAP.md Queue 1 item 22)")
_SAVE_VIEW_TODO = ("--save-view needs the pipeline's drawing (ROADMAP.md Queue 1 "
                   "item 21)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu only when asked for)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--threaded", action="store_true")
    p.add_argument("--comref", action="store_true",
                   help="ScaleNet CNN CoM refinement in the detect path")
    # not ported yet: parsed so that asking for them fails loudly
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--ref-pickle", default=None)
    p.add_argument("--comref-pickle", default=None)
    p.add_argument("--model", default="poseregnet", choices=["poseregnet", "resnet"])
    p.add_argument("--save-view", default=None)
    return p


def main(argv=None, log=print):
    """Runs the demo; returns (pipeline, results)."""
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
    from deepprior_tpu_torch.realtime.camera import SyntheticDevice
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.realtime.pipeline import RealtimeHandposePipeline

    args = build_parser().parse_args(argv)
    if args.device == "capture":  # the JAX demo's camera flag
        raise NotImplementedError(_CAPTURE_TODO)
    if args.device == "synthetic":
        args.device = None
    if args.comref_pickle:
        raise NotImplementedError(_TODO["ref_pickle"])
    if args.save_view:
        raise NotImplementedError(_SAVE_VIEW_TODO)
    device = torch.device(args.device) if args.device else default_device()

    cam = NYU_CAMERA
    model, prior = load_serving_net(args.model, ref_pickle=args.ref_pickle,
                                    checkpoint=args.checkpoint, device=device)
    est = FusedEstimator(model, cam, prior=prior, device=device)
    com_refiner = None
    if args.comref:
        refine_model = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3),
                                generator=torch.Generator().manual_seed(1))
        com_refiner = CNNComRefiner(refine_model.to(device), cam)
    pipe = RealtimeHandposePipeline(
        est, {"fx": cam.fx, "fy": cam.fy, "cube": (250.0, 250.0, 250.0)},
        com_refiner=com_refiner,
    )
    runner = pipe.process_video_threaded if args.threaded else pipe.process_video
    results = runner(SyntheticDevice(cam, seed=0), max_frames=args.frames)
    if results:
        log(f"processed {len(results)} frames on {device}, "
            f"fps={results[-1]['fps']:.1f} (detect {pipe.times['detect'] * 1000:.1f}ms, "
            f"pose {pipe.times['pose'] * 1000:.1f}ms)")
    else:
        log("no frames processed")
    return pipe, results


if __name__ == "__main__":
    main()
