"""Model zoo (NCHW ``nn.Module``s)."""

from deepprior_tpu_torch.models.poseregnet import PoseRegNet, PoseRegNetConfig

__all__ = ["PoseRegNet", "PoseRegNetConfig"]
