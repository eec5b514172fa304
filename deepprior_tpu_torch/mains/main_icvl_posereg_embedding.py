"""ICVL: PoseRegNet + 30-D PCA embedding, on the port (counterpart of
mains/main_icvl_posereg_embedding.py; reference
src/main_icvl_posereg_embedding.py).

    python -m deepprior_tpu_torch.mains.main_icvl_posereg_embedding \\
        --data <ICVL root> --epochs 100 --out ./eval [--streamed] [--resume]
"""

from deepprior_tpu_torch.camera import ICVL_CAMERA
from deepprior_tpu_torch.data.importers import ICVLImporter
from deepprior_tpu_torch.eval.datasets import ICVLHandposeEvaluation
from deepprior_tpu_torch.mains.common import ICVL_BASELINE, base_parser, run_posereg_embedding


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    return run_posereg_embedding(
        args, ICVLImporter, ICVL_CAMERA, train_seq="train", test_seqs=["test_seq_1"],
        num_joints=16, eval_cls=ICVLHandposeEvaluation,
        # --accept: against Tang et al.'s LRF predictions (reference
        # main_icvl_posereg_embedding.py:184), BASELINE.md's 8.1 mm + 5%
        baseline_spec=ICVL_BASELINE, accept_mm=8.5,
    )


if __name__ == "__main__":
    main()
