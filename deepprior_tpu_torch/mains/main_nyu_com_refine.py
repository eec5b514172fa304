"""NYU CoM refinement: the 3-scale ScaleNet on the port (counterpart of
mains/main_nyu_com_refine.py; reference src/main_nyu_com_refine.py: batch
64, 1-joint offset labels, lr 0.0005).

    python -m deepprior_tpu_torch.mains.main_nyu_com_refine \\
        --data <NYU root> --epochs 100 --out ./eval [--streamed] [--resume]
"""

from deepprior_tpu_torch.camera import NYU_CAMERA
from deepprior_tpu_torch.data.importers import NYUImporter
from deepprior_tpu_torch.eval.datasets import NYUHandposeEvaluation
from deepprior_tpu_torch.mains.common import NYU_BASELINE, base_parser, run_com_refine


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(lr=0.0005)  # the reference's CoM recipe (main:172)
    args = p.parse_args(argv)
    return run_com_refine(
        args, NYUImporter, NYU_CAMERA, train_seq="train", test_seqs=["test_1", "test_2"],
        num_joints=14, crop_joint_idx=13, eval_cls=NYUHandposeEvaluation,
        baseline_spec=NYU_BASELINE,
    )


if __name__ == "__main__":
    main()
