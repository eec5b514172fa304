"""ICVL CoM refinement on the port (counterpart of
mains/main_icvl_com_refine.py; reference src/main_icvl_com_refine.py).

    python -m deepprior_tpu_torch.mains.main_icvl_com_refine \\
        --data <ICVL root> --epochs 100 --out ./eval [--streamed] [--resume]
"""

from deepprior_tpu_torch.camera import ICVL_CAMERA
from deepprior_tpu_torch.data.importers import ICVLImporter
from deepprior_tpu_torch.eval.datasets import ICVLHandposeEvaluation
from deepprior_tpu_torch.mains.common import ICVL_BASELINE, base_parser, run_com_refine


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(lr=0.0005)  # the reference's CoM recipe
    args = p.parse_args(argv)
    return run_com_refine(
        args, ICVLImporter, ICVL_CAMERA, train_seq="train", test_seqs=["test_seq_1"],
        num_joints=16, crop_joint_idx=0, eval_cls=ICVLHandposeEvaluation,
        baseline_spec=ICVL_BASELINE,
    )


if __name__ == "__main__":
    main()
