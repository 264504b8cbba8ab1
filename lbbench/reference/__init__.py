"""The plain reference of each configuration, found by its name. Plain
PyTorch; imports nothing of ``lb2d_tpu_torch``, ``lb2d_tpu`` or ``jax``."""
