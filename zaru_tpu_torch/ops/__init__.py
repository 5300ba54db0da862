"""Samplers: plain PyTorch versions and hand-written CUDA kernels
(zaru_tpu/ops)."""
