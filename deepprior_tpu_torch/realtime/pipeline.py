"""Realtime hand-pose pipeline: capture -> detect -> regress.

Counterpart of deepprior_tpu/realtime/pipeline.py (reference
src/util/realtimehandposepipeline.py:49-534).  The compute path is the
eager ``FusedEstimator``; detection and tracking run as batched tensor ops
on the estimator's device (ops/com.py), or on the host through the numpy
``HandCropper``.  The host side keeps the reference's state machine
(IDLE/INIT/RUN), tracking vs detection, the INIT hand-size calibration and
the producer/consumer split (threads over a lock-protected slot, like the
reference's sync dict).

While spans record (utils/profiling.py) ``detect`` and ``estimate_pose``
record ``pipeline.detect`` and ``pipeline.pose``, each with the frame's
number as its ``id``; inside ``pipeline.detect``, device detection records
``detect.scan`` (``ops.com.detect`` through its CoM's copy to the host,
with the labeling's ``passes``: 1 on a card, where the union-find kernel
K8 labels with no host sync, else the plain scan's count, one host sync
each; not when tracking) and
``detect.refine`` (the CoM refiner through its copy to the host).
``times['detect']`` and ``times['pose']`` are the durations of
``pipeline.detect`` and ``pipeline.pose``, timed whether or not spans
record.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepprior_tpu_torch.camera import Camera
from deepprior_tpu_torch.data.detector_np import HandCropper
from deepprior_tpu_torch.ops.com import detect as device_detect
from deepprior_tpu_torch.ops.com import refine_com_iterative
from deepprior_tpu_torch.ops.crop import clamp_depth
from deepprior_tpu_torch.realtime.fused import FusedEstimator
from deepprior_tpu_torch.utils.profiling import span, timed

STATE_IDLE = 0
STATE_INIT = 1
STATE_RUN = 2

HAND_LEFT = 0
HAND_RIGHT = 1

# the status bar's state light: a disc of radius 5 at (7, 9) of the bar
STATE_COLORS = {STATE_IDLE: (255, 0, 0), STATE_INIT: (255, 255, 0), STATE_RUN: (0, 255, 0)}
STATUS_LIGHT = np.add.outer((np.arange(20) - 9) ** 2, (np.arange(14) - 7) ** 2) <= 25


class RealtimeHandposePipeline:
    def __init__(
        self,
        estimator: FusedEstimator,
        config: Dict[str, Any],
        camera: Optional[Camera] = None,
        verbose: bool = False,
        com_refiner=None,
        use_device_detect: bool = True,
    ):
        """config mirrors the reference dict: {'fx', 'fy', 'cube'
        [, 'invX', 'invY', 'upsample', 'crop_joint_idx']}
        (test_realtimepipeline.py:65-67).  The estimator holds its weights.

        com_refiner: optional ops.refine_cnn.CNNComRefiner, the CNN CoM
        refinement of the reference's track() path (handdetector.py:518-521).
        use_device_detect: detect and track on the estimator's device
        (ops.com.detect, refine_com_iterative) instead of the host numpy
        ``HandCropper``; the same semantics.
        """
        self.estimator = estimator
        self.config = dict(config)
        self.camera = camera or estimator.camera
        self.device = estimator.device
        self.verbose = verbose
        self.com_refiner = com_refiner
        self.use_device_detect = use_device_detect

        # state machine (realtimehandposepipeline.py:54-109)
        self.state = STATE_IDLE
        self.hand = HAND_LEFT  # reference default (realtimehandpose:96)
        self.tracking = False
        self.lastcom = np.zeros(3, np.float32)
        self.hand_sizes: list = []
        self.num_init_frames = 50
        self.stop_flag = threading.Event()

        # producer/consumer shared slot (the Manager-dict equivalent)
        self._lock = threading.Lock()
        self._slot: Optional[Dict[str, Any]] = None
        self._fid = 0
        # the number of the newest frame handed to detect, the spans' id
        self._frame = 0

        # instrumentation (reference per-stage ms + running fps,
        # realtimehandposepipeline.py:160-166, 199-214, 447-462)
        self.times: Dict[str, float] = {"detect": 0.0, "pose": 0.0}
        self._fps_hist: list = []

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _detect_on_device(self, frame: np.ndarray, cube) -> np.ndarray:
        """Full slice-scan detection, or tracking around the last CoM, then
        the optional CNN refinement, as tensor ops on the device."""
        cam, dev = self.camera, self.device
        fr = torch.as_tensor(frame, dtype=torch.float32, device=dev)[None]
        cb = torch.as_tensor(cube, dtype=torch.float32, device=dev)
        if self.tracking and not np.allclose(self.lastcom, 0.0):
            d, dmin, dmax = clamp_depth(fr)
            com = refine_com_iterative(
                d, torch.as_tensor(self.lastcom, device=dev)[None], cb,
                cam.fx, cam.fy, num_iter=3, min_depth=dmin, max_depth=dmax)[0]
            com = com.cpu().numpy()
        else:
            with span("detect.scan", id=self._frame):
                com = device_detect(fr, cb, cam.fx, cam.fy)[0].cpu().numpy()
        if self.com_refiner is not None and not np.allclose(com, 0.0):
            with span("detect.refine", id=self._frame):
                d, _, _ = clamp_depth(fr)
                com = self.com_refiner(d, torch.as_tensor(com, device=dev)[None],
                                       cb)[0].cpu().numpy()
        return com

    def detect(self, frame: np.ndarray) -> Tuple[np.ndarray, tuple]:
        """Detection/tracking -> (com, cube).

        Mirrors realtimehandposepipeline.py:296-337: track around the last
        CoM when tracking is on, otherwise full detection; the INIT state
        calibrates the cube from the median hand size over
        ``num_init_frames`` frames."""
        self._frame += 1
        with timed("pipeline.detect", id=self._frame) as took:
            com, cube = self._detect(frame)
        self.times["detect"] = took.seconds
        return com, cube

    def _detect(self, frame: np.ndarray) -> Tuple[np.ndarray, tuple]:
        cube = tuple(self.config["cube"])
        if self.use_device_detect:
            com = self._detect_on_device(frame, cube)
        else:
            hc = HandCropper(frame, self.camera)
            if self.tracking and not np.allclose(self.lastcom, 0.0):
                com = hc.refine_com_iterative(self.lastcom, 3, cube)
            else:
                com = hc.detect(cube)
            if self.com_refiner is not None and not np.allclose(com, 0.0):
                com = self.com_refiner(
                    hc.dpt[None], com[None].astype(np.float32), cube
                )[0].cpu().numpy()
        self.lastcom = com

        if self.state == STATE_INIT and not np.allclose(com, 0.0):
            hc = HandCropper(frame, self.camera)
            self.hand_sizes.append(hc.estimate_hand_size(com, cube))
            if len(self.hand_sizes) >= self.num_init_frames:
                med = tuple(np.median(np.asarray(self.hand_sizes), axis=0))
                self.config["cube"] = med
                self.hand_sizes = []
                self.state = STATE_RUN
        return com, cube

    # ------------------------------------------------------------------
    def estimate_pose(self, frame: np.ndarray, com: np.ndarray) -> np.ndarray:
        """Crop + regress + decode at batch 1 (realtimehandposepipeline.py:
        339-370 estimatePose + denormalize), with the reference's
        conventions: RIGHT hands mirror the crop before regression and flip
        the relative pose's x back after it (:346-351, 366-369); invX/invY
        flip the relative pose's y/x (the reference's swapped-index quirk,
        :353-363).  The live config cube is passed per call, so the INIT
        calibration and +/- resizing reach the crop and the
        denormalization (:330-336)."""
        with timed("pipeline.pose", id=self._frame) as took:
            joints, _, _ = self.estimator(
                frame[None],
                np.asarray(com, np.float32)[None],
                cube=np.asarray(self.config["cube"], np.float32),
                mirror=np.asarray([self.hand == HAND_RIGHT]),
                invx=bool(self.config.get("invX", False)),
                invy=bool(self.config.get("invY", False)),
            )
            joints = joints[0].cpu().numpy()
        self.times["pose"] = took.seconds
        return joints

    # ------------------------------------------------------------------
    def _record_fps(self):
        self._fps_hist.append(time.perf_counter())
        self._fps_hist = self._fps_hist[-100:]

    def process_frame(self, frame: np.ndarray) -> Optional[Dict[str, Any]]:
        """One producer + consumer iteration in one thread (processVideo,
        realtimehandposepipeline.py:262-294)."""
        com, cube = self.detect(frame)
        if np.allclose(com, 0.0):
            return None
        joints = self.estimate_pose(frame, com)
        self._record_fps()
        return {"frame": frame, "com": com, "joints3d": joints, "cube": cube,
                "fps": self.fps()}

    def fps(self) -> float:
        """100-frame running-average fps (realtimehandposepipeline.py:447-462)."""
        if len(self._fps_hist) < 2:
            return 0.0
        dt = self._fps_hist[-1] - self._fps_hist[0]
        return (len(self._fps_hist) - 1) / dt if dt > 0 else 0.0

    # ------------------------------------------------------------------
    def _producer(self, device, max_frames):
        n = 0
        try:
            while not self.stop_flag.is_set() and n < max_frames:
                ok, frame = device.getDepth()
                if not ok:
                    time.sleep(0.005)  # camera retry (reference :156-159)
                    continue
                com, cube = self.detect(frame)
                with self._lock:
                    self._fid += 1
                    self._slot = {"fid": self._fid, "frame": frame, "com": com,
                                  "cube": cube}
                n += 1
        finally:
            self.stop_flag.set()

    def _consumer(self, results, max_frames):
        seen = 0
        last_fid = -1
        try:
            while not self.stop_flag.is_set() or last_fid < self._fid:
                with self._lock:
                    slot = self._slot
                if slot is None or slot["fid"] == last_fid:
                    if self.stop_flag.is_set():
                        break
                    time.sleep(0.001)
                    continue
                last_fid = slot["fid"]
                if np.allclose(slot["com"], 0.0):
                    continue
                joints = self.estimate_pose(slot["frame"], slot["com"])
                self._record_fps()
                results.append({"fid": slot["fid"], "joints3d": joints,
                                "com": slot["com"], "fps": self.fps()})
                seen += 1
                if seen >= max_frames:
                    break
        finally:
            self.stop_flag.set()

    def process_video_threaded(self, device, max_frames: int = 100):
        """Producer/consumer threads over a shared slot
        (processVideoThreaded, realtimehandposepipeline.py:221-238).
        Returns the consumer's results; a thread's exception is raised
        here."""
        self.stop_flag.clear()
        results: list = []
        errors: list = []

        def run(fn, *args):
            try:
                fn(*args)
            except BaseException as e:  # re-raised in the caller's thread
                errors.append(e)

        device.start()
        threads = [threading.Thread(target=run, args=(self._producer, device, max_frames)),
                   threading.Thread(target=run, args=(self._consumer, results, max_frames))]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        finally:
            device.stop()
        if errors:
            raise errors[0]
        return results

    def process_video(self, device, max_frames: int = 100):
        """Single-loop variant (processVideo)."""
        device.start()
        results = []
        try:
            for _ in range(max_frames):
                ok, frame = device.getDepth()
                if not ok:
                    break
                out = self.process_frame(frame)
                if out is not None:
                    results.append(out)
        finally:
            device.stop()
        return results

    # ------------------------------------------------------------------
    def process_key(self, key: str) -> bool:
        """Keyboard control (processKey, realtimehandposepipeline.py:~490):
        q=quit, h=switch hand, +/-=cube size, r=reset, i=init-calibrate,
        t=toggle tracking.  Returns False to quit."""
        if key == "q":
            return False
        if key == "h":
            self.hand = HAND_LEFT if self.hand == HAND_RIGHT else HAND_RIGHT
        elif key == "+":
            self.config["cube"] = tuple(c + 10.0 for c in self.config["cube"])
        elif key == "-":
            self.config["cube"] = tuple(c - 10.0 for c in self.config["cube"])
        elif key == "r":
            self.reset()
        elif key == "i":
            self.state = STATE_INIT
            self.hand_sizes = []
        elif key == "t":
            self.tracking = not self.tracking
        return True

    def reset(self):
        self.state = STATE_IDLE
        self.lastcom = np.zeros(3, np.float32)
        self.tracking = False
        self.hand_sizes = []

    # ------------------------------------------------------------------
    # the views: host numpy, the JAX pipeline's pixels
    # ------------------------------------------------------------------
    @staticmethod
    def _draw_skeleton(img, uvd, connections, line_color=(0, 255, 0),
                       joint_color=(255, 0, 0)):
        h, w = img.shape[:2]
        for a, b in connections or []:
            pa, pb = uvd[a], uvd[b]
            n = int(max(abs(pb[0] - pa[0]), abs(pb[1] - pa[1])) + 1)
            us = np.linspace(pa[0], pb[0], n).astype(int)
            vs = np.linspace(pa[1], pb[1], n).astype(int)
            ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
            img[vs[ok], us[ok]] = line_color
        for u, v in uvd[:, :2]:
            ui, vi = int(u), int(v)
            if 0 <= ui < w and 0 <= vi < h:
                img[max(0, vi - 1): vi + 2, max(0, ui - 1): ui + 2] = joint_color
        return img

    def show(self, result: Dict[str, Any]) -> np.ndarray:
        """The skeleton overlay as an (H, W, 3) uint8 RGB array: the frame
        in gray, the skeleton, and the CoM marker (the reference draws with
        cv2.imshow, realtimehandposepipeline.py:372-446; the caller chooses
        the sink)."""
        from deepprior_tpu_torch.eval.datasets import evaluation_for

        frame = result["frame"]
        joints3d = result["joints3d"]
        uvd = self.camera.three_d_to_img_np(joints3d)
        ev_cls = evaluation_for(joints3d.shape[0])
        lo = frame[frame > 0].min() if (frame > 0).any() else 0.0
        hi = max(frame.max(), 1.0)
        norm = np.clip((frame - lo) / max(hi - lo, 1e-6), 0, 1)
        img = np.stack([norm * 255] * 3, axis=-1).astype(np.uint8)
        self._draw_skeleton(img, uvd, ev_cls.joint_connections)
        # the CoM marker (the reference draws a green circle, :419-424)
        com = result.get("com")
        if com is not None:
            ui, vi = int(com[0]), int(com[1])
            h, w = frame.shape
            if 0 <= ui < w and 0 <= vi < h:
                img[max(0, vi - 2): vi + 3, max(0, ui - 2): ui + 3, 1] = 255
        return img

    def show_side(self, result: Dict[str, Any]) -> np.ndarray:
        """The 90-degree side view: the pose rotated by Euler (0, 90, 0)
        about config['crop_joint_idx'] when set (the reference's
        importer.crop_joint_idx), else the pose's mean, and projected into
        a blank canvas (the reference's ``poseimg``,
        realtimehandposepipeline.py:426-446)."""
        from deepprior_tpu_torch.eval.datasets import evaluation_for
        from deepprior_tpu_torch.geometry import rotate_points_3d_np

        frame = result["frame"]
        joints3d = np.asarray(result["joints3d"], np.float32)
        cj = self.config.get("crop_joint_idx")
        center = joints3d[int(cj)] if cj is not None else joints3d.mean(axis=0)
        rotated = np.asarray(rotate_points_3d_np(joints3d, center[None], 0.0, 90.0, 0.0),
                             np.float32)
        uvd = self.camera.three_d_to_img_np(rotated)
        ev_cls = evaluation_for(joints3d.shape[0])
        img = np.zeros((frame.shape[0], frame.shape[1], 3), np.uint8)
        self._draw_skeleton(img, uvd, ev_cls.joint_connections)
        return img

    def add_status_bar(self, img: np.ndarray) -> np.ndarray:
        """``img`` under the reference's 20-px status bar (addStatusBar,
        realtimehandposepipeline.py:449-492): fps, hand, cube size,
        tracking (T) or detection (D), the detector, and the state light
        (IDLE red, INIT yellow, RUN green)."""
        from deepprior_tpu_torch.utils.text import draw_text

        barsz = 20
        out = np.full((img.shape[0] + barsz, img.shape[1], 3), 255, np.uint8)
        out[barsz:] = img
        draw_text(out, f"FPS {self.fps():2.1f}", 20, 6)
        draw_text(out, "LEFT" if self.hand == HAND_LEFT else "RIGHT", 80, 6)
        draw_text(out, f"HC-{int(self.config['cube'][0])}", 130, 6)
        draw_text(out, "T" if self.tracking else "D", 200, 6)
        draw_text(out, "COM", 220, 6)
        out[0:barsz, 0:14][STATUS_LIGHT] = STATE_COLORS.get(self.state, STATE_COLORS[STATE_IDLE])
        return out
