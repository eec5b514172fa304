"""MSRA15 leave-one-subject-out cross-validation with the PCA embedding, on
the port (counterpart of mains/main_msra15_posereg_embedding_crossval.py;
reference src/main_msra15_posereg_embedding_crossval.py): train on 8
subjects, test on the held-out one, for each of P0..P8 or the --holdout.

    python -m deepprior_tpu_torch.mains.main_msra15_posereg_embedding_crossval \\
        --data <MSRA15 root> --holdout P8 --epochs 100 --out ./eval [--streamed]
"""

import os

import numpy as np

from deepprior_tpu_torch.camera import MSRA15_CAMERA
from deepprior_tpu_torch.data.basetypes import ImageSequence
from deepprior_tpu_torch.data.importers import MSRA15Importer
from deepprior_tpu_torch.eval.datasets import MSRAHandposeEvaluation
from deepprior_tpu_torch.mains.common import base_parser, run_posereg_embedding

SUBJECTS = [f"P{i}" for i in range(9)]


class _MultiSubjectImporter:
    """Several MSRA15 subjects as one training sequence named 'train'."""

    def __init__(self, basepath, subjects, **kw):
        self.imp = MSRA15Importer(basepath, **kw)
        self.subjects = subjects

    def loadSequence(self, seq_name, **kw):
        if seq_name != "train":
            return self.imp.loadSequence(seq_name, **kw)
        frames, config = [], None
        for s in self.subjects:
            seq = self.imp.loadSequence(
                s, **{k: v for k, v in kw.items() if k not in ("shuffle", "rng")})
            frames.extend(seq.data)
            config = seq.config
        rng = kw.get("rng")
        if kw.get("shuffle") and rng is not None:
            rng.shuffle(frames)
        return ImageSequence("train", frames, config)


def main(argv=None):
    """Returns {held-out subject: (state, results, history)}."""
    p = base_parser(__doc__)
    p.add_argument("--holdout", default=None,
                   help="held-out subject (default: each of P0..P8 in turn)")
    args = p.parse_args(argv)
    # under torchrun only rank 0 prints (the group starts inside the fold)
    say = print if os.environ.get("RANK", "0") == "0" else (lambda *a, **k: None)
    folds, means = {}, []
    for held in [args.holdout] if args.holdout else SUBJECTS:
        say(f"=== crossval fold: holding out {held} ===", flush=True)
        train_subjects = [s for s in SUBJECTS if s != held]

        def importer_cls(basepath, _subj=train_subjects, **kw):
            return _MultiSubjectImporter(basepath, _subj, **kw)

        args.eval_prefix = f"MSRA_EMB_crossval_{held}"
        folds[held] = run_posereg_embedding(
            args, importer_cls, MSRA15_CAMERA, train_seq="train", test_seqs=[held],
            num_joints=21, eval_cls=MSRAHandposeEvaluation,
        )
        means.append(folds[held][1][held].getMeanError())
    say(f"crossval mean over folds: {float(np.mean(means)):.3f}mm", flush=True)
    return folds


if __name__ == "__main__":
    main()
