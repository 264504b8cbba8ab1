"""The C++ CPU engine of the pipe-flow family (counterpart of
``lb2d_tpu.native``).

``lb_d2q9.cpp`` is the D2Q9 pressure-driven step (stream, Zou-He pressure
BCs, walls and corners, optional bounce-back mask, compressible or He-Luo
incompressible BGK) for the host CPU, OpenMP-parallel over rows. On first
use it is compiled with the system ``g++`` and the JAX package's flags
(``GXX_FLAGS``) into ``lb2d_tpu_torch/_build/``, rebuilt when the source
is newer than the library, and driven through ``ctypes``: the same source,
flags and compiler give the JAX package's engine's bits.

OpenMP: the library links ``libgomp.so.1``. This module imports torch
first, and where torch has loaded its own ``libgomp.so.1`` (the CPU and
the CUDA 12.8 wheels ship one under the same soname), the loader binds the
library to that copy, so a process holds one OpenMP runtime.

Use :func:`native_run` for raw stepping or ``PipeFlow(backend="native")``
through the model API.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["build", "native_run", "is_available"]

_SRC = Path(__file__).resolve().with_name("lb_d2q9.cpp")
LIB_PATH = _SRC.parent.parent / "_build" / "liblb2d_native.so"
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib = None


def _compile():
    """Compile the engine to a temporary name, then move it into place (two
    processes may build at once; a loader sees the old library or the new
    one). Raises ``RuntimeError`` with g++'s stderr."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native build failed: g++ not found on PATH")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({gxx}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def build(force: bool = False) -> ctypes.CDLL:
    """Compile the engine if needed (or when ``force``) and return the
    loaded library."""
    global _lib
    if _lib is not None and not force:
        return _lib
    if (force or not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime):
        _compile()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.lb2d_run.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int]
    lib.lb2d_run.restype = None
    _lib = lib
    return lib


def is_available() -> bool:
    """Whether the engine builds and loads here."""
    try:
        build()
        return True
    except RuntimeError:
        return False


def native_run(f, n_steps, *, omega, inlet_rho, outlet_rho,
               incompressible=False, mask=None) -> np.ndarray:
    """Advance ``f`` (``[9, ny, nx]`` float32, a numpy array or a CPU tensor)
    by ``n_steps`` on the CPU and return the result as a new numpy array;
    ``f`` is not modified. ``mask`` is an optional obstacle mask
    ``[ny, nx]``, passed to the engine as int32 (non-zero: solid). Another
    dtype than float32, or a tensor on another device, raises
    ``ValueError``."""
    if isinstance(f, torch.Tensor):
        if f.device.type != "cpu":
            raise ValueError(f"native_run takes a CPU tensor, not one on "
                             f"{f.device}")
        f = f.detach().numpy()
    f = np.asarray(f)
    if f.dtype != np.float32:
        raise ValueError(f"the C++ engine is float32 only, not {f.dtype}")
    if f.ndim != 3 or f.shape[0] != 9:
        raise ValueError(f"f must be [9, ny, nx], got {list(f.shape)}")
    lib = build()
    f = np.array(f, order="C", copy=True)
    _, ny, nx = f.shape
    tmp = np.empty_like(f)
    mask_ptr = None
    if mask is not None:
        if isinstance(mask, torch.Tensor):
            mask = mask.detach().cpu().numpy()
        mask = np.ascontiguousarray(mask, dtype=np.int32)
        if mask.shape != (ny, nx):
            raise ValueError(f"mask must be [{ny}, {nx}], got "
                             f"{list(mask.shape)}")
        mask_ptr = mask.ctypes.data
    lib.lb2d_run(f.ctypes.data, tmp.ctypes.data, mask_ptr, ny, nx,
                 float(np.float32(omega)), float(np.float32(inlet_rho)),
                 float(np.float32(outlet_rho)), int(bool(incompressible)),
                 int(n_steps))
    return f
