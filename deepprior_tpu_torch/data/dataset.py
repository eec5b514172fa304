"""Dataset stacking: sequences -> normalized training arrays (counterpart
of deepprior_tpu/data/dataset.py; reference src/data/dataset.py:39-148).

``Dataset.imgStackDepthOnly`` stacks a loaded ImageSequence into an
(N, 1, H, W) float32 image array (NCHW, like the reference; the trainer
uses ``train.trainer.TrainData`` instead) and an (N, J, 3) label array,
with the reference's normalization:

  [-1, 1]: background (0) -> com_z + cube/2; out = (d - com_z) / (cube/2)
  [0, 1]:  out = (d - (com_z - cube/2)) / cube
  labels:  gt3Dcrop / (cube_z/2)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class Dataset:
    def __init__(self, imgSeqs: Optional[list] = None, localCache: bool = True):
        self._imgSeqs = imgSeqs or []
        self.localCache = localCache
        self._imgStacks: Dict[str, np.ndarray] = {}
        self._labelStacks: Dict[str, np.ndarray] = {}

    @property
    def imgSeqs(self):
        return self._imgSeqs

    @imgSeqs.setter
    def imgSeqs(self, value):
        self._imgSeqs = value
        self._imgStacks = {}
        self._labelStacks = {}

    def imgSeq(self, seqName: str):
        for seq in self._imgSeqs:
            if seq.name == seqName:
                return seq
        return []

    def imgStackDepthOnly(self, seqName: str,
                          normZeroOne: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        seq = self.imgSeq(seqName)
        if not seq:
            return []
        key = f"{seqName}_{normZeroOne}"
        if key not in self._imgStacks:
            cube_z = float(seq.config["cube"][2])
            dpt = np.stack([f.dpt for f in seq.data]).astype(np.float32)
            com_z = np.array([f.com[2] for f in seq.data], np.float32)[:, None, None]
            dpt = np.where(dpt == 0.0, com_z + cube_z / 2.0, dpt)
            if normZeroOne:
                img = (dpt - (com_z - cube_z / 2.0)) / cube_z
            else:
                img = (dpt - com_z) / (cube_z / 2.0)
            imgs = img[:, None, :, :]  # NCHW like the reference
            labels = (np.stack([f.gt3Dcrop for f in seq.data]).astype(np.float32)
                      / (cube_z / 2.0))
            if not self.localCache:
                return imgs, labels
            self._imgStacks[key] = imgs
            self._labelStacks[key] = labels
        return self._imgStacks[key], self._labelStacks[key]


class ICVLDataset(Dataset):
    def __init__(self, imgSeqs=None, basepath=None, localCache=True, device=None):
        super().__init__(imgSeqs, localCache)
        from deepprior_tpu_torch.data.importers import ICVLImporter

        self.lmi = ICVLImporter(basepath or "../../data/ICVL/", device=device)


class NYUDataset(Dataset):
    def __init__(self, imgSeqs=None, basepath=None, localCache=True, device=None):
        super().__init__(imgSeqs, localCache)
        from deepprior_tpu_torch.data.importers import NYUImporter

        self.lmi = NYUImporter(basepath or "../../data/NYU/", device=device)


class MSRA15Dataset(Dataset):
    def __init__(self, imgSeqs=None, basepath=None, localCache=True, device=None):
        super().__init__(imgSeqs, localCache)
        from deepprior_tpu_torch.data.importers import MSRA15Importer

        self.lmi = MSRA15Importer(basepath or "../../data/MSRA15/", device=device)
