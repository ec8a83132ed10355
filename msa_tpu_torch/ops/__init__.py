"""Attention and joint-embedding ops: hand-written CUDA kernels, each with
its plain PyTorch version beside it."""
