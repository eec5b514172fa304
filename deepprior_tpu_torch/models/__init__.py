"""Model zoo (NCHW ``nn.Module``s)."""

from deepprior_tpu_torch.models.poseregnet import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.models.resnet import ResNet, ResNetConfig
from deepprior_tpu_torch.models.scalenet import ScaleNet, ScaleNetConfig

__all__ = ["PoseRegNet", "PoseRegNetConfig", "ResNet", "ResNetConfig", "ScaleNet",
           "ScaleNetConfig"]
