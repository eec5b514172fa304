"""The 30-D PCA pose prior's decode (counterpart of deepprior_tpu/prior.py
``PCAPrior``): the network regresses an embedding e, and the fixed linear
layer e @ components + mean decodes it to the (J*3) pose."""

from __future__ import annotations

import torch


class PCAPrior:
    """Fitted linear pose prior: decode(e) = e @ components + mean.

    components (n_components, J*3) and mean (J*3,) may be numpy arrays or
    tensors; they are held as float32 tensors.
    """

    def __init__(self, components, mean, device=None):
        self.components = torch.as_tensor(components, dtype=torch.float32, device=device)
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=self.components.device)

    def to(self, device) -> "PCAPrior":
        return PCAPrior(self.components, self.mean, device=device)

    def inverse_transform(self, embedded: torch.Tensor) -> torch.Tensor:
        """(N, n_components) -> (N, J*3) in full float32.  On CUDA this
        needs ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's
        default); TF32 would keep about three decimal digits."""
        return embedded.to(torch.float32) @ self.components + self.mean
