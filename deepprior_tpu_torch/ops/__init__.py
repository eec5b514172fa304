"""Depth-frame operations: the cube crop (plain PyTorch) and its CUDA kernel."""
