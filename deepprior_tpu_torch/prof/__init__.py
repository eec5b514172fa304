"""Measuring scripts of the port, run on the card with
``python -m deepprior_tpu_torch.prof.<name>``."""
