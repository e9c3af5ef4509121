"""MVLPT in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``mvlpt_tpu``; it imports nothing of JAX or of that package.
"""
