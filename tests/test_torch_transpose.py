"""P2, the transpose (``lb2d_tpu_torch.ops.transpose``), against JAX on the
CPU.

JAX's P2 (``benchmarks/probe_transpose.py:28`` ``make_tr``) cannot run off
a TPU: it is built with ``pltpu.CompilerParams`` and has no interpret
flag. So the port's plain version, and the wrapper's CPU path, are held
to ``jnp.transpose``, which ``make_tr`` is checked against on the TPU; a
transpose is exact, so they must be equal bit for bit. The kernel is held
to the plain version on the card (``tests/test_torch_kernel_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lb2d_tpu_torch.ops.transpose import transpose, transpose_reference


@pytest.mark.parametrize("shape", [(128, 256), (33, 70), (1, 5)],
                         ids=["128x256", "33x70", "1x5"])
def test_transpose_matches_jnp_transpose(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jnp.transpose(jnp.asarray(x)))
    got = transpose_reference(torch.from_numpy(x))
    assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    launches = transpose.launches
    out = torch.empty(shape[::-1])
    assert transpose(torch.from_numpy(x), out) is out
    assert np.array_equal(out.numpy(), want)
    assert transpose.launches == launches  # the CPU path launches nothing


def test_transpose_checks_its_arguments():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="float32 matrix"):
        transpose(x.double())
    with pytest.raises(ValueError, match="float32 matrix"):
        transpose(x.t())
    with pytest.raises(ValueError, match=r"\[6, 4\]"):
        transpose(x, torch.empty(4, 6))
