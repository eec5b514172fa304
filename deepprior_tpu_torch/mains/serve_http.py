"""HTTP pose-estimation service over the micro-batching server, on the port
(counterpart of mains/serve_http.py).

Concurrent POSTs are micro-batched into single pipeline runs on the card
(realtime/batcher.py; on a CUDA device one replay of a CUDA graph per
batch).

API:
  GET  /healthz          -> {"ok": true, "stats": {...}, "occupancy": f}
                           stats: the server's frames, batches, errors, and
                           queue_wait_s (requests' summed wait from submit
                           to their batch's staging) and stage_s (batches'
                           summed host staging), in seconds
  POST /predict          body: npz with
                           depth (H, W) float32 raw mm   [required]
                           com   (3,)  float32 image uvd [required]
                           cube  (3,)  float32 mm        [optional]
                           mirror ()   bool              [optional]
                         -> {"joints": [[x, y, z] mm, ...],
                             "batch": realized device batch when served}

Run:  python -m deepprior_tpu_torch.mains.serve_http --port 8000 \\
          --max-batch 64 [--model resnet] \\
          [--checkpoint eval/train_EMB_PCA30/network_prior.ckpt | --ref-pickle net.pkl]
--model picks PoseRegNet (default) or ResNet-47; --checkpoint serves a
network_prior.ckpt of the training main, --ref-pickle a reference-trained
network_prior.pkl (its PCA decode appended), random weights otherwise.
--device is the torch device, cuda by default; without a card the server
raises unless given --device cpu.  --dp D serves each batch over D
estimator replicas (parallel/serve.py::ShardedEstimator), one per card in
turn: on a node of D cards one each, on one card D replicas that overlap;
--max-batch must be a multiple of D.
"""

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from deepprior_tpu_torch.device import default_device
from deepprior_tpu_torch.mains.common import load_serving_net


def _device(args) -> torch.device:
    return torch.device(args.device) if getattr(args, "device", None) else default_device()


def build_server(args):
    """Model + estimator + micro-batcher from the parsed flags; None after
    --export-artifact wrote its artifact."""
    from deepprior_tpu_torch.camera import NYU_CAMERA
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer
    from deepprior_tpu_torch.realtime.fused import FusedEstimator

    dp = getattr(args, "dp", 1)
    if dp > 1 and args.max_batch % dp:
        raise SystemExit(f"--max-batch {args.max_batch} must be a multiple of --dp {dp}")
    if dp > 1 and (getattr(args, "artifact", None) or getattr(args, "export_artifact", None)):
        raise SystemExit("--dp serves the estimator; an artifact is one program on "
                         "one device")
    if getattr(args, "artifact", None):
        # frozen serving artifact (realtime/export.py): weights + geometry
        # baked into one program; no model class or camera table loads.
        # Its config is fixed, so per-request cube/mirror are rejected, and
        # the exported batch is the micro-batch.  It serves on --device as
        # the estimator does: an exported program moves there, a compiled
        # one made for another device raises.
        from deepprior_tpu_torch.realtime.export import ArtifactEstimator

        est = ArtifactEstimator(args.artifact, device=_device(args))
        return MicroBatchServer(est, max_batch=est.batch,
                                max_wait_ms=args.max_wait_ms, frame_shape=est.hw)
    device = _device(args)
    model, prior = load_serving_net(
        args.model, ref_pickle=getattr(args, "ref_pickle", None),
        checkpoint=args.checkpoint, device=device,
    )
    est = FusedEstimator(model, NYU_CAMERA, prior=prior, device=device)
    if getattr(args, "export_artifact", None):
        from deepprior_tpu_torch.realtime import export as xp

        hw = (NYU_CAMERA.height, NYU_CAMERA.width)
        write = (xp.precompile_serving if args.artifact_kind == "compiled"
                 else xp.export_serving)
        meta = write(est, args.max_batch, hw, args.export_artifact)
        print(f"exported {meta['kind']} artifact (batch {meta['batch']}, hw "
              f"{meta['hw']}, {meta['device']}) -> {args.export_artifact}", flush=True)
        return None
    return _wrap_server(args, est)


def replica_devices(device: torch.device, dp: int):
    """--dp's device list: the cards of the node in turn (dp replicas on one
    card when it has one), or ``device`` dp times off CUDA."""
    if device.type != "cuda":
        return [device] * dp
    n = torch.cuda.device_count()
    first = device.index or 0
    return [torch.device("cuda", (first + i) % n) for i in range(dp)]


def _wrap_server(args, est):
    """Micro-batcher around the estimator; --dp > 1 splits each batch over
    that many replicas (ShardedEstimator)."""
    from deepprior_tpu_torch.realtime.batcher import MicroBatchServer

    dp = getattr(args, "dp", 1)
    if dp > 1:
        from deepprior_tpu_torch.parallel.serve import ShardedEstimator

        est = ShardedEstimator(est, devices=replica_devices(est.device, dp))
    return MicroBatchServer(est, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)


def make_handler(server):
    class Handler(BaseHTTPRequestHandler):
        # silence per-request stderr lines (stats live in /healthz)
        def log_message(self, fmt, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "stats": dict(server.stats),
                    "occupancy": server.occupancy(),
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(n)))
                depth = np.asarray(data["depth"], np.float32)
                com = np.asarray(data["com"], np.float32)
                if depth.ndim != 2 or com.shape != (3,):
                    raise ValueError(
                        f"bad shapes: depth {depth.shape}, com {com.shape}"
                    )
                cube = (
                    np.asarray(data["cube"], np.float32)
                    if "cube" in data else None
                )
                mirror = bool(data["mirror"]) if "mirror" in data else False
            except Exception as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                fut = server.submit(depth, com, cube=cube, mirror=mirror)
            except ValueError as e:
                # request invalid for this deployment (shape mismatch,
                # per-request cube/mirror on a fixed-config server): client
                # error, not a 5xx that pages on server health
                self._json(400, {"error": f"bad request: {e}"})
                return
            except RuntimeError as e:  # submit raced shutdown
                self._json(503, {"error": str(e)})
                return
            try:
                joints = fut.result(timeout=60.0)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            self._json(200, {
                "joints": np.asarray(joints, np.float64).tolist(),
                "batch": server.max_batch,
            })

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; cpu only when asked for)")
    p.add_argument("--model", default="poseregnet", choices=["poseregnet", "resnet"])
    p.add_argument("--checkpoint", default=None,
                   help="trained network_prior.ckpt (random weights if absent)")
    p.add_argument("--ref-pickle", default=None,
                   help="a reference-trained .pkl[.gz] net of --model's family, "
                        "its PCA decode appended (network_prior.pkl)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--dp", type=int, default=1,
                   help="split each batch over this many estimator replicas, one per "
                        "card in turn (several on one card); a divisor of --max-batch")
    p.add_argument("--artifact", default=None,
                   help="serve from a frozen artifact (realtime/export.py: weights "
                        "+ geometry baked into one program; fixed config)")
    p.add_argument("--export-artifact", default=None,
                   help="write a frozen serving artifact for the current "
                        "model/checkpoint at batch --max-batch, then exit")
    p.add_argument("--artifact-kind", default="stablehlo",
                   choices=["stablehlo", "compiled"],
                   help="stablehlo: a torch.export exported program (the JAX "
                        "package's spelling of the portable kind), bound to "
                        "the device it was exported on; compiled: the same "
                        "program pinned to this card's name, served by "
                        "replaying a CUDA graph")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = build_server(args)
    if server is None:  # --export-artifact wrote the artifact and exits
        return
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    graph = getattr(server.est, "graph", server.graph)
    replicas = ", ".join(str(d) for d in getattr(server.est, "devices", []))
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(max_batch {server.max_batch}, max_wait {args.max_wait_ms}ms, "
          f"graph {graph}" + (f", replicas {replicas}" if replicas else "") + ")",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
