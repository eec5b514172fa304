"""Realtime pipeline demo on the port (counterpart of mains/demo_realtime.py;
reference src/test_realtimepipeline.py): drives the fused estimator from a
camera (synthetic, or the native capture shim), detecting the hand on the
device, and reports fps.

    python -m deepprior_tpu_torch.mains.demo_realtime --frames 100 [--threaded] [--comref]
    python -m deepprior_tpu_torch.mains.demo_realtime --device capture --frames 100 \
        --save-view view.png

Random weights (PoseRegNet type 0, or with --model resnet ResNet-47 type 0,
30-D PCA prior; with --comref a full-width ScaleNet CoM refiner), or with
--checkpoint the trained net and prior of a network_prior.ckpt written by
the training main, or with --ref-pickle a reference-trained
network_prior.pkl (its PCA decode appended); --comref-pickle loads a
reference-trained ScaleNet refiner (and implies --comref).  --device is
the torch device, cuda by default; without a card the demo raises unless
given --device cpu.  --camera capture runs on the native capture shim
(cpp/capture.cpp, built with g++ at first use) at 60 fps with its own
intrinsics; the JAX demo's spellings are accepted: --device synthetic and
--device capture choose the camera and run on the default torch device.
--save-view writes the last frame's front view under the status bar beside
the rotated side view as a PNG (matplotlib's imsave, as the JAX demo; where
matplotlib is missing the demo says that no PNG was written).
"""

import argparse
import os

import numpy as np
import torch

from deepprior_tpu_torch.device import default_device
from deepprior_tpu_torch.mains.common import load_serving_net


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu only when asked for)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--threaded", action="store_true")
    p.add_argument("--comref", action="store_true",
                   help="ScaleNet CNN CoM refinement in the detect path")
    p.add_argument("--checkpoint", default=None,
                   help="trained network_prior.ckpt (random weights if absent)")
    p.add_argument("--ref-pickle", default=None,
                   help="a reference-trained .pkl[.gz] net of --model's family, its "
                        "PCA decode appended (network_prior.pkl)")
    p.add_argument("--comref-pickle", default=None,
                   help="a reference-trained ScaleNet CoM refiner .pkl[.gz] "
                        "(implies --comref)")
    p.add_argument("--model", default="poseregnet", choices=["poseregnet", "resnet"],
                   help="resnet: ResNet-47, the reference realtime demo's net")
    p.add_argument("--camera", default="synthetic", choices=["synthetic", "capture"],
                   help="camera source: synthetic scenes, or the native capture shim")
    p.add_argument("--save-view", default=None,
                   help="save the last annotated frame (front view + status bar | "
                        "rotated side view) as a PNG")
    return p


def view_canvas(pipe, result) -> np.ndarray:
    """The demo's view of one result: the front view under the status bar,
    beside the rotated side view (realtimehandposepipeline.py:372-492)."""
    front = pipe.add_status_bar(pipe.show(result))
    side = pipe.show_side(result)
    canvas = np.zeros((max(front.shape[0], side.shape[0]), front.shape[1] + side.shape[1], 3),
                      np.uint8)
    canvas[: front.shape[0], : front.shape[1]] = front
    canvas[: side.shape[0], front.shape[1]:] = side
    return canvas


def save_view(canvas: np.ndarray, path: str, log=print) -> bool:
    """Write ``canvas`` as a PNG with matplotlib; where matplotlib is
    missing, say that no PNG was written.  Returns whether one was."""
    from deepprior_tpu_torch.eval.plots import pyplot

    try:
        plt = pyplot()
    except ImportError as exc:
        log(f"no PNG written to {path}: {exc}")
        return False
    plt.imsave(path, canvas)
    log(f"saved view to {path}")
    return True


def main(argv=None, log=print):
    """Runs the demo; returns (pipeline, results)."""
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
    from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
    from deepprior_tpu_torch.realtime.camera import CaptureDevice, SyntheticDevice
    from deepprior_tpu_torch.realtime.fused import FusedEstimator
    from deepprior_tpu_torch.realtime.pipeline import RealtimeHandposePipeline
    from deepprior_tpu_torch.utils.refweights import (load_reference_pickle,
                                                      scalenet_state_dict_from_reference)

    args = build_parser().parse_args(argv)
    if args.device in ("synthetic", "capture"):  # the JAX demo's camera flag
        args.camera, args.device = args.device, None
    device = torch.device(args.device) if args.device else default_device()

    cam = NYU_CAMERA
    if args.camera == "capture":
        camera = CaptureDevice(mode="synthetic", fps=60.0)
        # the shim's camera is not NYU's: run with its intrinsics (the
        # reference's getDepthIntrinsics surface)
        camera.start()
        try:
            cam = camera.getDepthIntrinsics()
        finally:
            camera.stop()  # process_video starts it again
    else:
        camera = SyntheticDevice(cam, seed=0)
    model, prior = load_serving_net(args.model, ref_pickle=args.ref_pickle,
                                    checkpoint=args.checkpoint, device=device)
    est = FusedEstimator(model, cam, prior=prior, device=device)
    com_refiner = None
    if args.comref or args.comref_pickle:
        refine_model = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3),
                                generator=torch.Generator().manual_seed(1))
        if args.comref_pickle:
            # the reference demo loads a trained comrefNet pickle
            # (test_realtimepipeline.py:71-77)
            refine_model.load_state_dict(scalenet_state_dict_from_reference(
                load_reference_pickle(args.comref_pickle)))
        com_refiner = CNNComRefiner(refine_model.to(device), cam)
    pipe = RealtimeHandposePipeline(
        est, {"fx": cam.fx, "fy": cam.fy, "cube": (250.0, 250.0, 250.0)},
        com_refiner=com_refiner,
    )
    runner = pipe.process_video_threaded if args.threaded else pipe.process_video
    results = runner(camera, max_frames=args.frames)
    if results:
        log(f"processed {len(results)} frames on {device}, "
            f"fps={results[-1]['fps']:.1f} (detect {pipe.times['detect'] * 1000:.1f}ms, "
            f"pose {pipe.times['pose'] * 1000:.1f}ms)")
        last = results[-1]
        if "frame" not in last:  # threaded results carry no frame: fetch one
            ok, frame = camera.getDepth()
            if ok:
                last = dict(last, frame=frame)
        if "frame" in last and args.save_view:
            save_view(view_canvas(pipe, last), os.path.abspath(args.save_view), log)
    else:
        log("no frames processed")
    return pipe, results


if __name__ == "__main__":
    main()
