"""PyTorch/CUDA port of yt8m_tpu for one NVIDIA H100.

The JAX package `yt8m_tpu` is the reference; this package imports
nothing of it (nor JAX). Hot kernels are hand-written CUDA C++ under
`kernels/csrc/`, built with nvcc at first use and bound with ctypes.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
