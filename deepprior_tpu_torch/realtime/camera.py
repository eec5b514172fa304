"""Camera devices for the realtime pipeline.

Counterpart of deepprior_tpu/realtime/camera.py, with the reference
``CameraDevice`` interface (src/util/cameradevice.py:43-161:
start/stop/getDepth/getRGB/getDepthIntrinsics/...):

- ``FileDevice``       replays depth frames (cameradevice.py:348-457)
- ``SyntheticDevice``  streams generated hand scenes; from the same seed
                       it yields the JAX package's frames bit for bit
- ``CaptureDevice``    binds the native capture shim (cpp/capture.cpp, the
                       reference's lib_dscapture equivalent, built with g++
                       at first use) through ctypes

The shim publishes each frame through a seqlock of two slots, depth and
colour together, so ``getDepth`` never observes a torn frame.
"""

from __future__ import annotations

import ctypes
import os
import time
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


def _ptr(buf: np.ndarray, ctype):
    return buf.ctypes.data_as(ctypes.POINTER(ctype))


class CaptureDevice(CameraDevice):
    """The native capture shim through ctypes: the reference's
    lib_dscapture module surface (depthsense.cxx:203-223), a depth stream
    of 320x240 float32 mm and a 640x480 RGB colour stream.

    lib_path: a built shim (default: ``cpp/capture.cpp`` built with g++
    into ``deepprior_tpu_torch/_build/`` at first use; a failed build
    raises).  mode: 'synthetic' (a moving hand-like scene at ``fps``) or
    'file' (``source``: int32 h, w, n, then n float32 frames)."""

    def __init__(self, lib_path: Optional[str] = None, mode: str = "synthetic",
                 source: str = "", fps: float = 30.0, mirror: bool = False):
        super().__init__(mirror)
        if lib_path is None:
            from deepprior_tpu_torch.ops._build import host_library_path

            lib_path = host_library_path("capture.cpp")
        lib = self.lib = ctypes.CDLL(os.path.abspath(lib_path))
        f32, u8, i16 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_uint8,
                                                     ctypes.c_int16))
        sigs = {
            "ds_start": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double], ctypes.c_int),
            "ds_stop": ([], None),
            "ds_get_depth": ([f32, ctypes.c_int], ctypes.c_int),
            "ds_depth_width": ([], ctypes.c_int),
            "ds_depth_height": ([], ctypes.c_int),
            "ds_frame_counter": ([], ctypes.c_longlong),
            "ds_get_intrinsics": ([f32], None),
            "ds_get_accel": ([f32], None),
            # the colour / vertex / UV / sync surface
            "ds_colour_width": ([], ctypes.c_int),
            "ds_colour_height": ([], ctypes.c_int),
            "ds_colour_frame_counter": ([], ctypes.c_longlong),
            "ds_get_colour": ([u8, ctypes.c_int], ctypes.c_int),
            "ds_get_vertices": ([i16, ctypes.c_int], ctypes.c_int),
            "ds_get_vertices_fp": ([f32, ctypes.c_int], ctypes.c_int),
            "ds_get_uv": ([f32, ctypes.c_int], ctypes.c_int),
            "ds_get_sync": ([u8, ctypes.c_int], ctypes.c_int),
            "ds_get_color_intrinsics": ([f32], None),
            "ds_get_extrinsics": ([f32], None),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        self.mode = mode
        self.source = source
        self.fps = fps
        self._shape = None

    def start(self):
        """Start the capture thread and wait (up to 5 s) for its first
        frame, as a camera's start does."""
        rc = self.lib.ds_start(self.mode.encode(), self.source.encode(),
                               ctypes.c_double(self.fps))
        if rc != 0:
            raise RuntimeError(f"capture shim failed to start (rc={rc})")
        self._shape = (self.lib.ds_depth_height(), self.lib.ds_depth_width())
        deadline = time.monotonic() + 5.0
        while self.lib.ds_frame_counter() == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        if self.lib.ds_frame_counter() == 0:
            raise RuntimeError("capture shim produced no frame within 5 s")

    def stop(self):
        self.lib.ds_stop()

    def _read(self, fn, shape, dtype, ctype, mirror=True):
        """(ok, buffer) from one of the shim's getters; mirrored with the
        depth frame."""
        buf = np.empty(shape, dtype)
        if not fn(_ptr(buf, ctype), buf.size):
            return False, None
        if self.mirror and mirror:
            buf = buf[:, ::-1]
        return True, buf

    def getDepth(self):
        if self._shape is None:
            return False, None
        return self._read(self.lib.ds_get_depth, self._shape, np.float32, ctypes.c_float)

    def getDepthIntrinsics(self) -> Camera:
        vals = (ctypes.c_float * 4)()
        self.lib.ds_get_intrinsics(vals)
        h, w = self._shape if self._shape else (240, 320)
        return Camera(fx=vals[0], fy=vals[1], ux=vals[2], uy=vals[3], width=w, height=h)

    def getAcceleration(self) -> np.ndarray:
        vals = (ctypes.c_float * 3)()
        self.lib.ds_get_accel(vals)
        return np.array(vals[:], np.float32)

    def getLastDepthNum(self) -> int:
        return int(self.lib.ds_frame_counter())

    # ---- the colour / vertex / UV / sync surface (reference depthsense.cxx
    # getColourMap / getVertices(FP) / getUVMap / getSyncMap, :203-223) ----
    def getRGB(self):
        """(ok, (cH, cW, 3) uint8) from the colour stream."""
        h, w = self.lib.ds_colour_height(), self.lib.ds_colour_width()
        if h == 0 or w == 0:
            return False, None
        return self._read(self.lib.ds_get_colour, (h, w, 3), np.uint8, ctypes.c_uint8)

    def getVertices(self, fp: bool = False):
        """(ok, (dH, dW, 3) vertex map in depth-camera mm): fp=False the
        reference's saturating int16 map, fp=True exact float32.  mirror
        flips the pixel layout, so that the map stays aligned with
        getDepth(); the x values keep the physical camera's sign."""
        if self._shape is None:
            return False, None
        if fp:
            return self._read(self.lib.ds_get_vertices_fp, (*self._shape, 3), np.float32,
                              ctypes.c_float)
        return self._read(self.lib.ds_get_vertices, (*self._shape, 3), np.int16,
                          ctypes.c_int16)

    def getUVMap(self):
        """(ok, (dH, dW, 2) normalized colour coordinates; invalid pixels
        (-1, -1)); the values index the unmirrored colour stream."""
        if self._shape is None:
            return False, None
        return self._read(self.lib.ds_get_uv, (*self._shape, 2), np.float32, ctypes.c_float)

    def getSyncMap(self):
        """(ok, (dH, dW, 3) uint8 colour remapped onto the depth pixels)."""
        if self._shape is None:
            return False, None
        return self._read(self.lib.ds_get_sync, (*self._shape, 3), np.uint8, ctypes.c_uint8)

    def getColorIntrinsics(self) -> Camera:
        vals = (ctypes.c_float * 4)()
        self.lib.ds_get_color_intrinsics(vals)
        return Camera(fx=vals[0], fy=vals[1], ux=vals[2], uy=vals[3],
                      width=self.lib.ds_colour_width(), height=self.lib.ds_colour_height())

    def getExtrinsics(self) -> np.ndarray:
        """Row-major (3, 4) [R|t]: a colour-camera point is R @ X + t (mm)."""
        vals = (ctypes.c_float * 12)()
        self.lib.ds_get_extrinsics(vals)
        return np.array(vals[:], np.float32).reshape(3, 4)

    def getLastColorNum(self) -> int:
        return int(self.lib.ds_colour_frame_counter())
