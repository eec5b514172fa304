"""deepprior_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of deepprior_tpu.

The module paths mirror the JAX package's, so each counterpart is found at
the same place under the other package name:

- ``camera``            pinhole camera models (``Camera``, dataset presets)
- ``data.synthetic``    numpy hand-frame generator
- ``ops.crop``          clamp + metric-cube crop + normalize (plain PyTorch)
- ``ops.hopper_crop``   the same crop as a hand-written CUDA kernel
- ``models``            PoseRegNet as NCHW ``nn.Module``s
- ``prior``             the PCA pose-prior decode
- ``realtime``          the fused frame -> joints estimator and its
                        micro-batching server
- ``utils.convert``     flax parameter trees -> PyTorch ``state_dict``s

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access: deepprior_tpu_torch.models / ops / ...
    import importlib

    if name in (
        "camera", "data", "models", "ops", "prior", "realtime", "utils",
    ):
        return importlib.import_module(f"deepprior_tpu_torch.{name}")
    raise AttributeError(name)
