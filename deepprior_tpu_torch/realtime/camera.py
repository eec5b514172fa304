"""Camera devices for the realtime pipeline.

Counterpart of deepprior_tpu/realtime/camera.py, with the reference
``CameraDevice`` interface (src/util/cameradevice.py:43-161:
start/stop/getDepth/getRGB/getDepthIntrinsics/...):

- ``FileDevice``       replays depth frames (cameradevice.py:348-457)
- ``SyntheticDevice``  streams generated hand scenes; from the same seed
                       it yields the JAX package's frames bit for bit

The native capture shim (``CaptureDevice``, cpp/capture.cpp) is not ported
yet (ROADMAP.md Queue 1 item 22).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from deepprior_tpu_torch.camera import NYU_CAMERA, Camera


class CameraDevice:
    """Abstract device (reference cameradevice.py:43-161)."""

    def __init__(self, mirror: bool = False):
        self.mirror = mirror

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def getDepth(self) -> Tuple[bool, Optional[np.ndarray]]:
        """Returns (ok, depth mm float32 (H, W))."""
        raise NotImplementedError

    def getRGB(self) -> Tuple[bool, Optional[np.ndarray]]:
        return False, None

    def getRGBD(self):
        ok_d, d = self.getDepth()
        ok_c, c = self.getRGB()
        return ok_d and ok_c, d, c

    def getDepthIntrinsics(self) -> Camera:
        raise NotImplementedError

    def getLastDepthNum(self) -> int:
        return -1


class FileDevice(CameraDevice):
    """Replays a list of depth frames through the device interface
    (reference FileDevice, cameradevice.py:348-457)."""

    def __init__(self, frames, camera: Camera, mirror: bool = False, loop=True):
        """frames: (N, H, W) array, a list of 2D arrays, or a .npz path
        with a 'depth' array."""
        super().__init__(mirror)
        if isinstance(frames, (str, os.PathLike)):
            frames = np.load(frames)["depth"]
        self.frames = [np.asarray(f, np.float32) for f in frames]
        self.camera = camera
        self.loop = loop
        self._i = 0
        self._running = False

    def start(self):
        self._running = True
        self._i = 0

    def stop(self):
        self._running = False

    def getDepth(self):
        if not self._running or not self.frames:
            return False, None
        if self._i >= len(self.frames):
            if not self.loop:
                return False, None
            self._i = 0
        frame = self.frames[self._i]
        self._i += 1
        if self.mirror:
            frame = frame[:, ::-1]
        return True, frame.copy()

    def getDepthIntrinsics(self):
        return self.camera

    def getLastDepthNum(self):
        return self._i - 1


class SyntheticDevice(CameraDevice):
    """Streams synthetic hand scenes with a slowly moving CoM."""

    def __init__(self, camera: Camera = NYU_CAMERA, seed: int = 0, mirror=False):
        super().__init__(mirror)
        self.camera = camera
        self.rng = np.random.default_rng(seed)
        self._t = 0
        self._running = False

    def start(self):
        self._running = True

    def stop(self):
        self._running = False

    def getDepth(self):
        from deepprior_tpu_torch.data.synthetic import render_depth, synthetic_hand_pose

        if not self._running:
            return False, None
        cam = self.camera
        t = self._t
        self._t += 1
        com = np.array(
            [
                cam.ux + 60 * np.sin(t / 20.0),
                cam.uy + 40 * np.cos(t / 25.0),
                700.0 + 80 * np.sin(t / 30.0),
            ],
            np.float32,
        )
        pose = synthetic_hand_pose(self.rng, 14, spread_mm=60.0)
        dpt = render_depth(cam, cam.img_to_3d_np(com), pose)
        if self.mirror:
            dpt = dpt[:, ::-1]
        return True, dpt

    def getDepthIntrinsics(self):
        return self.camera

    def getLastDepthNum(self):
        return self._t - 1
