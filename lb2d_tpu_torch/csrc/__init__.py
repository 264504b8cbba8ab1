"""CUDA C++ sources of the port's kernels (package data, built by
:mod:`lb2d_tpu_torch.ops._build`)."""
