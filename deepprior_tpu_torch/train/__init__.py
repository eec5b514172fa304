"""Training: the reference optimizers, epoch indexing and the trainer."""
