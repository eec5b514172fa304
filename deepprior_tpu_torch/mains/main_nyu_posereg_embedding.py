"""NYU flagship: PoseRegNet + 30-D PCA embedding + augmentation, on the
port (counterpart of mains/main_nyu_posereg_embedding.py; reference
src/main_nyu_posereg_embedding.py:38-205).

    python -m deepprior_tpu_torch.mains.main_nyu_posereg_embedding \\
        --data <NYU root> --epochs 100 --out ./eval [--streamed] [--resume]
    python -m deepprior_tpu_torch.mains.main_nyu_posereg_embedding \\
        --synthetic --epochs 5 --batch-size 128 --nmax 512 --out ./eval
    python -m deepprior_tpu_torch.mains.main_nyu_posereg_embedding \
        --data <NYU root> --accept [--accept-mm 10] [--baseline-file <.mat>]
    python -m deepprior_tpu_torch.mains.main_nyu_posereg_embedding \\
        --synthetic --model a2j --epochs 1 --nmax 128 --out ./eval
"""

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.importers import NYUImporter
from deepprior_tpu_torch.eval.datasets import NYUHandposeEvaluation
from deepprior_tpu_torch.mains.common import NYU_BASELINE, base_parser, run_posereg_embedding


def main(argv=None, v2v=None, a2j=None):
    """``v2v``: ``V2VConfig`` fields for --model v2v (default the published
    grid); ``a2j``: ``A2JConfig`` fields for --model a2j (default the
    published 176x176 crop)."""
    args = base_parser(__doc__).parse_args(argv)
    return run_posereg_embedding(
        args, NYUImporter, NYU_CAMERA, train_seq="train", test_seqs=["test_1", "test_2"],
        num_joints=14, eval_cls=NYUHandposeEvaluation,
        # --accept: against Tompson et al.'s predictions, BASELINE.md's < 10 mm
        baseline_spec=NYU_BASELINE, accept_mm=10.0, v2v=v2v, a2j=a2j,
    )


if __name__ == "__main__":
    main()
