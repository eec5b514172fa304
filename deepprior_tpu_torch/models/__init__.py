"""Model zoo (NCHW ``nn.Module``s; V2V-PoseNet NCDHW)."""

from deepprior_tpu_torch.models.a2j import A2J, A2JConfig
from deepprior_tpu_torch.models.poseregnet import PoseRegNet, PoseRegNetConfig
from deepprior_tpu_torch.models.resnet import ResNet, ResNetConfig
from deepprior_tpu_torch.models.scalenet import ScaleNet, ScaleNetConfig
from deepprior_tpu_torch.models.v2v import V2VConfig, V2VPoseNet

__all__ = ["A2J", "A2JConfig", "PoseRegNet", "PoseRegNetConfig", "ResNet", "ResNetConfig",
           "ScaleNet", "ScaleNetConfig", "V2VConfig", "V2VPoseNet"]
