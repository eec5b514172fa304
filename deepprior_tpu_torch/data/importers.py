"""Dataset importers: ICVL, NYU and MSRA15 depth-hand datasets.

Counterpart of deepprior_tpu/data/importers.py (reference
src/data/importers.py:187-1310), with the same file formats, numerics and
cache:

- ICVL:   16-bit grayscale PNG depth (320x240), line-format labels
          ("<relpath> u v d" x 16), crop joint 0, cube 250^3, sub-sequence
          filtering (importers.py:339-356);
- NYU:    640x480 PNG with the depth packed G<<8 | B (importers.py:917-934),
          labels from joint_data.mat (joint_uvd / joint_xyz), 36 joints
          with the 14-joint eval subset, per-sequence cubes;
- MSRA15: .bin depth patches (header w, h, left, top, right, bottom, then
          float32; importers.py:570-588), 21 joints, crop joint 5,
          per-subject cubes, the labels' z negated (importers.py:688),
          left/right mirroring (importers.py:693-699).

Each sequence is cached as a compressed .npz of stacked arrays under the
JAX package's file name and keys, so a cache written by either package
loads in the other.  The host crop (default) is the numpy oracle
``data/detector_np.HandCropper``, frame by frame; ``device_crop=True``
crops in batches of 256 frames with the port's ``ops/crop.py`` and
``ops/com.py`` on ``device``.  With ``docom`` and a ``refine_net``
attached ('comref'), both paths move the detected CoM by the CNN and crop
again about it; ``load_refine_net_lazy`` attaches a ScaleNet from a port
checkpoint as an ``ops/refine_cnn.py::CNNComRefiner``, whose crop is the
kernel K1 on a CUDA device.

PNG decoding needs Pillow, imported when an ICVL or NYU frame is read;
MSRA15 needs none.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepprior_tpu_torch.camera import Camera, ICVL_CAMERA, MSRA15_CAMERA, NYU_CAMERA
from deepprior_tpu_torch.data.basetypes import DepthFrame, ImageSequence
from deepprior_tpu_torch.data.detector_np import HandCropper
from deepprior_tpu_torch.device import default_device
from deepprior_tpu_torch.geometry import transform_points_2d_np


def _detection_mode(docom: bool, refine: bool) -> str:
    """Cache key component (handdetector.py:71-89)."""
    if not docom and not refine:
        return "gt"
    if docom and not refine:
        return "com"
    if docom and refine:
        return "comref"
    raise NotImplementedError(f"docom={docom} refine={refine}")


def _pil_image():
    """PIL.Image, or an ImportError that names Pillow."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding ICVL and NYU depth PNGs needs Pillow (the PIL "
                          "package), which is not installed") from exc
    return Image


def _numpy(x) -> np.ndarray:
    """A refiner's answer (a tensor on any device, or an array) as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class DepthImporter:
    """Shared import machinery; subclasses decode frames and parse labels.

    device: where ``device_crop=True`` crops and the refiner runs (default:
    the CUDA card, and RuntimeError without one; the CPU only when asked
    for)."""

    camera: Camera = ICVL_CAMERA
    num_joints: int = 16
    crop_joint_idx: int = 0
    default_cubes = {}
    sides = {}

    def __init__(self, basepath: str, use_cache: bool = True, cache_dir: str = "./cache/",
                 refine_net=None, hand: Optional[str] = None,
                 resize_method: str = "nearest", device=None):
        self.basepath = basepath
        self.use_cache = use_cache
        self.cache_dir = cache_dir
        self.refine_net = refine_net
        self.hand = hand
        # the reference HandDetector's resize switch (handdetector.py:57-69),
        # applied by the host crop and the batched device crop alike
        self.resize_method = resize_method
        self.device = torch.device(device) if device is not None else default_device()

    # camera passthroughs (the reference exposes these on the importer)
    @property
    def fx(self):
        return self.camera.fx

    @property
    def fy(self):
        return self.camera.fy

    def jointImgTo3D(self, uvd):
        return self.camera.img_to_3d_np(uvd)

    def jointsImgTo3D(self, uvd):
        return self.jointImgTo3D(uvd)

    def joint3DToImg(self, xyz):
        return self.camera.three_d_to_img_np(xyz)

    def joints3DToImg(self, xyz):
        return self.joint3DToImg(xyz)

    def depthToPCL(self, dpt, T, background_val=0.0):
        """(N, 3) metric points of a depth map; ``T`` maps the full frame to
        ``dpt`` when it is a crop (``Camera.depth_to_pcl``)."""
        return self.camera.depth_to_pcl(dpt, T, background_val)

    def getDepthMapNV(self):
        return 32001

    # ------------------------------------------------------------------
    def _cache_path(self, seq_name, docom, cube, extra=""):
        tag = _detection_mode(docom, self.refine_net is not None)
        if self.resize_method != "nearest":  # crops differ per method
            tag += f"_{self.resize_method}"
        return os.path.join(
            self.cache_dir,
            f"{type(self).__name__}_{seq_name}{extra}_{self.hand}_{tag}_"
            f"{int(cube[0])}_cache.npz",
        )

    def _load_cache(self, path, seq_name, config, shuffle, rng, Nmax):
        """The cached sequence, shuffled and truncated as a fresh load
        would be, or None."""
        if not (self.use_cache and os.path.isfile(path)):
            return None
        with np.load(path, allow_pickle=False) as z:
            a = {k: z[k] for k in z.files}  # decompress each member once
        frames = [
            DepthFrame(
                dpt=a["dpt"][i], gtorig=a["gtorig"][i], gtcrop=a["gtcrop"][i],
                T=a["T"][i], gt3Dorig=a["gt3Dorig"][i], gt3Dcrop=a["gt3Dcrop"][i],
                com=a["com"][i], fileName=str(a["fileName"][i]),
                subSeqName=str(a["subSeqName"][i]), side=str(a["side"][i]),
            )
            for i in range(a["dpt"].shape[0])
        ]
        if shuffle and rng is not None:
            rng.shuffle(frames)
        if not np.isinf(Nmax):
            frames = frames[: int(Nmax)]
        return ImageSequence(seq_name, frames, config)

    def _save_cache(self, path, frames: List[DepthFrame], complete: bool = True):
        # an Nmax-truncated load must not write the cache: the key does not
        # hold Nmax, so a later full load would get the truncated sequence
        # back (the reference's pickle cache has this bug,
        # importers.py:410-414); cache hits truncate on read instead
        if not self.use_cache or not frames or not complete:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a temporary file replaces the cache in one os.replace: the ranks
        # of a distributed run load and cache the same sequence at once,
        # and none may read another's half-written file.  The name is unique
        # per writer, thread or process (spawn_cpu runs a rank a thread).
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                                   suffix=".tmp", dir=os.path.dirname(os.path.abspath(path)))
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(
                fh,
                dpt=np.stack([f.dpt for f in frames]),
                gtorig=np.stack([f.gtorig for f in frames]),
                gtcrop=np.stack([f.gtcrop for f in frames]),
                T=np.stack([f.T for f in frames]),
                gt3Dorig=np.stack([f.gt3Dorig for f in frames]),
                gt3Dcrop=np.stack([f.gt3Dcrop for f in frames]),
                com=np.stack([f.com for f in frames]),
                fileName=np.array([f.fileName for f in frames]),
                subSeqName=np.array([f.subSeqName for f in frames]),
                side=np.array([f.side for f in frames]),
            )
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    def load_refine_net_lazy(self, net, dsize=(128, 128)):
        """Attach a CoM-refinement CNN (the reference's loadRefineNetLazy,
        importers.py:175-184): ``net`` is a checkpoint path holding a
        ScaleNet(num_joints=1, n_dims=3) under "params" (the
        net_<prefix>.ckpt that ``run_com_refine`` writes, or that the JAX
        package's com-refine main writes), loaded onto the importer's
        device; or a refiner already made (used as it is); or None (keeps
        the current one)."""
        if net is None or not isinstance(net, (str, os.PathLike)):
            if net is not None:
                self.refine_net = net
            return self.refine_net
        from deepprior_tpu_torch.models import ScaleNet, ScaleNetConfig
        from deepprior_tpu_torch.ops.refine_cnn import CNNComRefiner
        from deepprior_tpu_torch.train.checkpoint import load_checkpoint

        model = ScaleNet(ScaleNetConfig(num_joints=1, n_dims=3))
        tree, _ = load_checkpoint(str(net), {"params": model.state_dict()})
        model.load_state_dict(tree["params"])
        self.refine_net = CNNComRefiner(model.to(self.device), self.camera, dsize)
        return self.refine_net

    def crop_frames_batched(self, raws: List[dict], cube, docom: bool, dsize=(128, 128),
                            chunk: int = 256) -> List[DepthFrame]:
        """The batched crop on ``self.device``: per chunk of frames, clamp
        -> content check -> (docom: one masked-CoM pass, cropArea3D's
        in-cube recompute with its 300 mm fallback, handdetector.py:413-427)
        -> (comref: the CNN refinement, handdetector.py:430-441) -> the
        cube crop, the plain gather of ``ops/crop.py``.

        raws: dicts of dpt (full frame), gtorig, gt3Dorig, fileName,
        subSeqName, side; every frame of one shape."""
        from deepprior_tpu_torch.ops.com import check_image, refine_com_iterative
        from deepprior_tpu_torch.ops.crop import clamp_depth, crop3d

        cam, dev = self.camera, self.device
        out: List[DepthFrame] = []
        cube_arr = torch.as_tensor(np.asarray(cube, np.float32), device=dev)
        for s in range(0, len(raws), chunk):
            part = raws[s : s + chunk]
            dpt = torch.from_numpy(np.stack([r["dpt"] for r in part]).astype(np.float32)).to(dev)
            gtorig = np.stack([r["gtorig"] for r in part]).astype(np.float32)
            com = torch.from_numpy(gtorig[:, self.crop_joint_idx, :]).to(dev)
            dptc, dmin, dmax = clamp_depth(dpt)
            keep = check_image(dptc, 1.0).cpu().numpy()
            if docom:
                com = refine_com_iterative(dptc, com, cube_arr, cam.fx, cam.fy, num_iter=1,
                                           empty_z=300.0, min_depth=dmin, max_depth=dmax)
                if self.refine_net is not None:
                    com = torch.as_tensor(self.refine_net(dptc, com, cube_arr),
                                          dtype=torch.float32, device=dev)
            crop, m = crop3d(dptc, com, cube_arr, cam.fx, cam.fy, dsize,
                             resize=self.resize_method)
            crop, m_np, com_np = crop.cpu().numpy(), m.cpu().numpy(), com.cpu().numpy()
            com3d = cam.img_to_3d_np(com_np)
            for i, r in enumerate(part):
                if not keep[i]:
                    continue
                out.append(DepthFrame(
                    dpt=crop[i],
                    gtorig=gtorig[i],
                    gtcrop=np.asarray(transform_points_2d_np(gtorig[i], m_np[i]), np.float32),
                    T=m_np[i],
                    gt3Dorig=np.asarray(r["gt3Dorig"], np.float32),
                    gt3Dcrop=np.asarray(r["gt3Dorig"] - com3d[i], np.float32),
                    com=com_np[i],
                    fileName=r.get("fileName", ""),
                    subSeqName=r.get("subSeqName", ""),
                    side=r.get("side", "right"),
                ))
        return out

    def _crop_frame(self, dpt, gtorig, gt3Dorig, cube, docom, dsize, file_name, sub_seq,
                    side) -> Optional[DepthFrame]:
        """One frame on the host: content check -> crop -> annotate (the body
        of every reference loadSequence loop, e.g. importers.py:383-407)."""
        hc = HandCropper(dpt, self.camera, resize_method=self.resize_method)
        if not hc.check_image(1.0):
            return None
        crop, m, com = hc.crop_area_3d(com=gtorig[self.crop_joint_idx], size=cube,
                                       dsize=dsize, docom=docom)
        if docom and self.refine_net is not None:
            # 'comref': the refinement after the docom recompute, then a
            # crop about the refined CoM (handdetector.py:429-441), as the
            # batched path does; the refiner crops the clamped full frame
            com = _numpy(self.refine_net(hc.dpt[None], np.asarray(com, np.float32)[None],
                                         np.asarray(cube, np.float32)))[0]
            crop, m, com = hc.crop_area_3d(com=com, size=cube, dsize=dsize, docom=False)
        com3d = self.jointImgTo3D(com)
        return DepthFrame(
            dpt=crop.astype(np.float32),
            gtorig=np.asarray(gtorig, np.float32),
            gtcrop=np.asarray(transform_points_2d_np(gtorig, m), np.float32),
            T=np.asarray(m, np.float32),
            gt3Dorig=np.asarray(gt3Dorig, np.float32),
            gt3Dcrop=np.asarray(gt3Dorig - com3d, np.float32),
            com=np.asarray(com, np.float32),
            fileName=file_name,
            subSeqName=sub_seq,
            side=side,
        )

    def _take(self, frames, raws, dpt, gtorig, gt3Dorig, config, docom, dsize, path,
              sub_seq, side, device_crop):
        """Crop one decoded frame now (host), or queue it for the batch."""
        if device_crop:
            raws.append(dict(dpt=dpt, gtorig=gtorig, gt3Dorig=gt3Dorig, fileName=path,
                             subSeqName=sub_seq, side=side))
            return
        frame = self._crop_frame(dpt, gtorig, gt3Dorig, config["cube"], docom, dsize, path,
                                 sub_seq, side)
        if frame is not None:
            frames.append(frame)

    def _finish(self, seq_name, frames, raws, config, docom, dsize, cache, Nmax, shuffle,
                rng):
        """Crop the queued frames, write the cache, shuffle."""
        if raws:
            frames.extend(self.crop_frames_batched(raws, config["cube"], docom, dsize))
        self._save_cache(cache, frames, complete=np.isinf(Nmax))
        if shuffle and rng is not None:
            rng.shuffle(frames)
        return ImageSequence(seq_name, frames, config)


class ICVLImporter(DepthImporter):
    """reference importers.py:187-527."""

    camera = ICVL_CAMERA
    num_joints = 16
    crop_joint_idx = 0
    default_cubes = {"train": (250, 250, 250), "test_seq_1": (250, 250, 250),
                     "test_seq_2": (250, 250, 250)}
    sides = {"train": "right", "test_seq_1": "right", "test_seq_2": "right"}

    def loadDepthMap(self, filename) -> np.ndarray:
        img = _pil_image().open(filename)
        assert len(img.getbands()) == 1, "ICVL depth must be single-channel"
        return np.asarray(img, np.float32)

    def loadSequence(self, seq_name: str, subSeq: Optional[Sequence[str]] = None,
                     Nmax: float = float("inf"), shuffle: bool = False, rng=None,
                     docom: bool = False, cube: Optional[Tuple[float, float, float]] = None,
                     dsize=(128, 128), device_crop: bool = False) -> ImageSequence:
        if self.hand is not None and self.hand != self.sides[seq_name]:
            # the reference has no ICVL mirroring path (importers.py:366-367)
            raise NotImplementedError(f"ICVL sequences are {self.sides[seq_name]}-hand only")
        config = {"cube": cube if cube is not None else self.default_cubes[seq_name]}
        extra = "_" + "".join(subSeq) if subSeq else ""
        cache = self._cache_path(seq_name, docom, config["cube"], extra)
        hit = self._load_cache(cache, seq_name, config, shuffle, rng, Nmax)
        if hit is not None:
            return hit

        objdir = os.path.join(self.basepath, "Depth")
        frames: List[DepthFrame] = []
        raws: List[dict] = []
        with open(os.path.join(self.basepath, f"{seq_name}.txt")) as fh:
            for line in fh:
                if len(frames) + len(raws) >= Nmax:
                    break
                part = line.split(" ")
                sub_name = ""
                if subSeq is not None:
                    # the first path component tags the subsequence; plain
                    # paths (> 6 chars) belong to the raw '0' subsequence
                    p0 = part[0].split("/")[0]
                    sub_name = "0" if len(p0) > 6 else p0
                    if sub_name not in subSeq:
                        continue
                path = os.path.join(objdir, part[0])
                if not os.path.isfile(path):
                    print(f"File {path} does not exist!")
                    continue
                gtorig = np.array(part[1 : 1 + self.num_joints * 3],
                                  np.float32).reshape(self.num_joints, 3)
                self._take(frames, raws, self.loadDepthMap(path), gtorig,
                           self.jointsImgTo3D(gtorig), config, docom, dsize, path, sub_name,
                           "left", device_crop)
        return self._finish(seq_name, frames, raws, config, docom, dsize, cache, Nmax,
                            shuffle, rng)

    def loadBaseline(self, filename, first_name=False):
        """Line-format predictions in image coordinates -> list of (J, 3)
        metric poses (importers.py:422-456)."""
        off = 1 if first_name else 0
        out = []
        with open(filename) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                part = line.split(" ")
                ev = np.array(part[off : off + self.num_joints * 3],
                              np.float32).reshape(self.num_joints, 3)
                out.append(self.jointsImgTo3D(ev))
        return out

    def loadBaseline2D(self, filename, first_name=False):
        off = 1 if first_name else 0
        out = []
        with open(filename) as fh:
            for line in fh:
                part = line.split(" ")
                ev = np.zeros((self.num_joints, 2), np.float32)
                for j in range(self.num_joints):
                    ev[j] = [part[j * 3 + off], part[j * 3 + 1 + off]]
                out.append(ev)
        return out


class NYUImporter(DepthImporter):
    """reference importers.py:878-1310."""

    camera = NYU_CAMERA
    num_joints = 36
    restricted_joints = [0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27, 30, 31, 32]
    default_cubes = {
        "train": (300, 300, 300), "test_1": (300, 300, 300), "test_2": (250, 250, 250),
        "test": (300, 300, 300), "train_synth": (300, 300, 300),
        "test_synth_1": (300, 300, 300), "test_synth_2": (250, 250, 250),
        "test_synth": (300, 300, 300),
    }
    sides = {k: "right" for k in default_cubes}

    def __init__(self, basepath, use_cache=True, cache_dir="./cache/", refine_net=None,
                 hand=None, all_joints=False, resize_method="nearest", device=None):
        super().__init__(basepath, use_cache, cache_dir, refine_net, hand,
                         resize_method=resize_method, device=device)
        self.all_joints = all_joints
        self.eval_idxs = np.arange(36) if all_joints else np.asarray(self.restricted_joints)
        self.num_joints = len(self.eval_idxs)
        self.crop_joint_idx = 32 if all_joints else 13

    def loadDepthMap(self, filename) -> np.ndarray:
        img = _pil_image().open(filename)
        assert len(img.getbands()) == 3, "NYU depth is packed in an RGB PNG"
        arr = np.asarray(img, np.int32)
        g, b = arr[..., 1], arr[..., 2]
        return ((g << 8) | b).astype(np.float32)

    def loadSequence(self, seq_name: str, Nmax: float = float("inf"), shuffle: bool = False,
                     rng=None, docom: bool = False, cube=None, dsize=(128, 128),
                     device_crop: bool = False) -> ImageSequence:
        import scipy.io

        if self.hand is not None and self.hand != self.sides[seq_name]:
            # the reference has no NYU mirroring path (importers.py:1007-1008)
            raise NotImplementedError(f"NYU sequences are {self.sides[seq_name]}-hand only")
        config = {"cube": cube if cube is not None else self.default_cubes[seq_name]}
        cache = self._cache_path(seq_name, docom, config["cube"], extra=f"_{self.all_joints}")
        hit = self._load_cache(cache, seq_name, config, shuffle, rng, Nmax)
        if hit is not None:
            return hit

        objdir = os.path.join(self.basepath, seq_name)
        mat = scipy.io.loadmat(os.path.join(objdir, "joint_data.mat"))
        joints3D, joints2D = mat["joint_xyz"][0], mat["joint_uvd"][0]
        side = self.sides[seq_name]
        frames: List[DepthFrame] = []
        raws: List[dict] = []
        for line in range(joints3D.shape[0]):
            if len(frames) + len(raws) >= Nmax:
                break
            path = os.path.join(objdir, f"depth_1_{line + 1:07d}.png")
            if not os.path.isfile(path):
                print(f"File {path} does not exist!")
                continue
            self._take(frames, raws, self.loadDepthMap(path),
                       joints2D[line][self.eval_idxs].astype(np.float32),
                       joints3D[line][self.eval_idxs].astype(np.float32), config, docom,
                       dsize, path, "", side, device_crop)
        return self._finish(seq_name, frames, raws, config, docom, dsize, cache, Nmax,
                            shuffle, rng)

    def loadBaseline(self, filename, gt: Optional[np.ndarray] = None):
        """Tompson et al. predictions from test_predictions.mat, with the
        ground-truth depth fix-up (importers.py:1079-1118); or a text file
        whose first line sets the joint count."""
        import scipy.io

        if gt is not None:
            mat = scipy.io.loadmat(filename)
            joints = mat["pred_joint_uvconf"][0]
            nj = mat["conv_joint_names"][0].shape[0]
            self.num_joints = nj  # the reference's side effect (importers.py:1091)
            base = os.path.split(filename)[0]
            out = []
            for dat in range(min(joints.shape[0], gt.shape[0])):
                fname = os.path.join(base, f"depth_1_{dat + 1:07d}.png")
                if not os.path.isfile(fname):
                    continue
                dm = self.loadDepthMap(fname)
                ev = np.zeros((nj, 3), np.float32)
                jt = 0
                for i in range(joints.shape[1]):
                    if np.count_nonzero(joints[dat, i, :]) == 0:
                        continue
                    ev[jt, :2] = joints[dat, i, :2]
                    ev[jt, 2] = dm[int(ev[jt, 1]), int(ev[jt, 0])]
                    jt += 1
                # unknown depth -> ground truth (importers.py:1110-1113)
                bad = np.abs(ev[:, 2] - gt[dat, 13, 2]) > 150.0
                ev[bad, 2] = gt[dat, bad, 2]
                out.append(self.jointsImgTo3D(ev))
            return out
        with open(filename) as fh:
            nj = len(fh.readline().split(" ")) // 3
            fh.seek(0)
            out = []
            for line in fh:
                line = line.rstrip()
                if not line:
                    continue
                ev = np.array(line.split(" ")[: nj * 3], np.float32).reshape(nj, 3)
                out.append(self.jointsImgTo3D(ev))
        return out

    def loadBaseline2D(self, filename):
        """Tompson et al. 2D (u, v) predictions from test_predictions.mat
        (importers.py:1147-1174): zero-confidence joints dropped, the rest
        moved to the front of each row."""
        import scipy.io

        mat = scipy.io.loadmat(filename)
        joints = mat["pred_joint_uvconf"][0]
        nj = mat["conv_joint_names"][0].shape[0]
        self.num_joints = nj  # the reference's side effect (importers.py:1158)
        out = []
        for dat in range(joints.shape[0]):
            ev = np.zeros((nj, 2), np.float32)
            keep = np.count_nonzero(joints[dat], axis=1) != 0
            uv = joints[dat, keep, :2].astype(np.float32)
            ev[: uv.shape[0]] = uv
            out.append(ev)
        return out


class MSRA15Importer(DepthImporter):
    """reference importers.py:529-876 (inverted-Y camera, per-subject cubes)."""

    camera = MSRA15_CAMERA
    num_joints = 21
    crop_joint_idx = 5
    default_cubes = {
        "P0": (200, 200, 200), "P1": (200, 200, 200), "P2": (200, 200, 200),
        "P3": (180, 180, 180), "P4": (180, 180, 180), "P5": (180, 180, 180),
        "P6": (170, 170, 170), "P7": (160, 160, 160), "P8": (150, 150, 150),
    }
    sides = {f"P{i}": "right" for i in range(9)}

    def loadDepthMap(self, filename) -> np.ndarray:
        """The .bin patch format (importers.py:570-588)."""
        with open(filename, "rb") as f:
            w, h, left, top, right, bottom = struct.unpack("<6i", f.read(24))
            patch = np.fromfile(f, dtype=np.float32)
        out = np.zeros((h, w), np.float32)
        out[top:bottom, left:right] = patch.reshape(bottom - top, right - left)
        return out

    def loadSequence(self, seq_name: str, subSeq: Optional[Sequence[str]] = None,
                     Nmax: float = float("inf"), shuffle: bool = False, rng=None,
                     docom: bool = False, cube=None, dsize=(128, 128),
                     device_crop: bool = False) -> ImageSequence:
        config = {"cube": cube if cube is not None else self.default_cubes[seq_name]}
        extra = "_" + "".join(subSeq) if subSeq else ""
        cache = self._cache_path(seq_name, docom, config["cube"], extra)
        hit = self._load_cache(cache, seq_name, config, shuffle, rng, Nmax)
        if hit is not None:
            return hit

        objdir = os.path.join(self.basepath, seq_name)
        subdirs = sorted(d for d in os.listdir(objdir)
                         if os.path.isdir(os.path.join(objdir, d)))
        side = self.sides[seq_name]
        frames: List[DepthFrame] = []
        raws: List[dict] = []
        for subdir in subdirs:
            if subSeq is not None and subdir not in subSeq:
                continue
            with open(os.path.join(objdir, subdir, "joint.txt")) as fh:
                for i in range(int(fh.readline())):
                    if len(frames) + len(raws) >= Nmax:
                        break
                    part = fh.readline().split(" ")
                    path = os.path.join(objdir, subdir, f"{i:06d}_depth.bin")
                    if not os.path.isfile(path):
                        print(f"File {path} does not exist!")
                        continue
                    dpt = self.loadDepthMap(path)
                    gt3Dorig = np.array(part[: self.num_joints * 3],
                                        np.float32).reshape(self.num_joints, 3)
                    gt3Dorig[:, 2] *= -1.0  # z negation (importers.py:688)
                    gtorig = self.joints3DToImg(gt3Dorig)
                    if self.hand is not None and self.hand != side:
                        # mirror left <-> right (importers.py:693-699)
                        gtorig[:, 0] = dpt.shape[1] / 2.0 - (gtorig[:, 0] - dpt.shape[1] / 2.0)
                        gt3Dorig = self.jointsImgTo3D(gtorig)
                        dpt = dpt[:, ::-1].copy()
                    self._take(frames, raws, dpt, gtorig, gt3Dorig, config, docom, dsize,
                               path, subdir, side, device_crop)
        return self._finish(seq_name, frames, raws, config, docom, dsize, cache, Nmax,
                            shuffle, rng)
