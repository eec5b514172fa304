"""MSRA15 CoM refinement on the port (counterpart of
mains/main_msra15_com_refine.py; reference src/main_msra15_com_refine.py):
train on --subject, test on --test-subject.

    python -m deepprior_tpu_torch.mains.main_msra15_com_refine \\
        --data <MSRA15 root> --subject P0 --test-subject P8 --out ./eval
"""

from deepprior_tpu_torch.camera import MSRA15_CAMERA
from deepprior_tpu_torch.data.importers import MSRA15Importer
from deepprior_tpu_torch.eval.datasets import MSRAHandposeEvaluation
from deepprior_tpu_torch.mains.common import base_parser, run_com_refine


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(lr=0.0005)  # the reference's CoM recipe
    p.add_argument("--subject", default="P0", help="MSRA15 train subject")
    p.add_argument("--test-subject", default="P8", help="held-out MSRA15 subject")
    args = p.parse_args(argv)
    return run_com_refine(
        args, MSRA15Importer, MSRA15_CAMERA, train_seq=args.subject,
        test_seqs=[args.test_subject], num_joints=21, crop_joint_idx=5,
        eval_cls=MSRAHandposeEvaluation,
    )


if __name__ == "__main__":
    main()
