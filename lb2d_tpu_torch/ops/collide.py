"""BGK collision (counterpart of ``lb2d_tpu.ops.collide``)."""

from __future__ import annotations

import torch

__all__ = ["bgk"]


def bgk(f: torch.Tensor, feq: torch.Tensor, omega) -> torch.Tensor:
    """``f (1 - omega) + omega feq`` (``D2Q9.cl:119``); ``omega`` is rounded
    to the field's dtype first, as in JAX."""
    omega = torch.as_tensor(omega, dtype=f.dtype, device=f.device)
    return f * (1.0 - omega) + omega * feq
