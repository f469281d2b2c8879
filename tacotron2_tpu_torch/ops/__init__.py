"""Kernel wrappers: each launches a hand-written CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor."""
