"""Plain PyTorch lattice-Boltzmann ops and the CUDA kernels' wrappers.

Importing this package builds nothing: the kernels are compiled on the
first launch (see :mod:`lb2d_tpu_torch.ops._build`).
"""
