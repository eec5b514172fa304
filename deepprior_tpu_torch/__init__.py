"""deepprior_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of deepprior_tpu.

The module paths mirror the JAX package's, so each counterpart is found at
the same place under the other package name:

- ``camera``            pinhole camera models (``Camera``, dataset presets)
- ``geometry``          2D point transforms, 3x3 inverse and compose
- ``data``              frame containers and the synthetic hand sequences
- ``ops.crop``          clamp + metric-cube crop + normalize, and the gather
                        warp of cropped patches (plain PyTorch)
- ``ops.hopper_crop``   the crop as a hand-written CUDA kernel (K1)
- ``ops.hopper_warp``   the augmentation warps as hand-written CUDA
                        kernels (K4, K5)
- ``ops.augment``       training-time augmentation on the device
- ``models``            PoseRegNet, ResNet-47 (with flax's BatchNorm) and
                        ScaleNet as NCHW ``nn.Module``s
- ``prior``             the PCA pose prior: its fit and its decode
- ``train``             reference optimizers, epoch indexing, the trainer
- ``eval``              the hand-pose metric suite
- ``realtime``          the fused frame -> joints estimator and its
                        micro-batching server
- ``mains``             the entry points (``python -m``)
- ``utils.convert``     flax variable trees -> PyTorch ``state_dict``s
- ``utils.refweights``  the reference's Theano pickles <-> ``state_dict``s

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access: deepprior_tpu_torch.models / ops / ...
    import importlib

    if name in (
        "camera", "data", "eval", "geometry", "mains", "models", "ops",
        "prior", "realtime", "train", "utils",
    ):
        return importlib.import_module(f"deepprior_tpu_torch.{name}")
    raise AttributeError(name)
