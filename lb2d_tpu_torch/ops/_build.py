"""Build and load the port's CUDA kernels.

The sources in ``lb2d_tpu_torch/csrc`` have a plain C interface. On first
use each ``.cu`` file is compiled with its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library under ``lb2d_tpu_torch/_build/``, loaded with ``ctypes`` (the
pattern of ``lb2d_tpu/native``). The library is rebuilt when a source is
newer than it. No fast-math flags: the kernels keep IEEE division and
denormals, as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "LIB_PATH", "MultifieldParams", "McParams",
           "FftParams", "FftPass", "CoupledParams"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
_HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
LIB_PATH = _PKG / "_build" / "liblb2d_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _LL, _ULL = ctypes.c_uint, ctypes.c_longlong, ctypes.c_ulonglong


class MultifieldParams(ctypes.Structure):
    """``Lb2dMultifieldParams`` of ``csrc/multifield_cell.cuh``, passed by
    value to K4 and K5: per field ``omega`` (Expansion: the populations',
    then the nutrient's), per population growth ``g`` and noise amplitude
    ``dg``; the clip ``cutoff``, the imposed lattice velocity ``u``, ``v``,
    the Philox key ``k0``, ``k1`` and the global step ``step0`` of the
    launch's first step."""
    _fields_ = [("omega", _F * 8), ("g", _F * 8), ("dg", _F * 8),
                ("cutoff", _F), ("u", _F), ("v", _F), ("k0", _U), ("k1", _U),
                ("step0", _ULL)]


class McHook(ctypes.Structure):
    """``Lb2dMcHook`` of ``csrc/mc_cell.cuh``: one force hook of K6. ``kind``
    0 constant force (``p[0]``, ``p[1]``), 1 ``g rho`` (the same), 2 ext
    planes ``2 ext_pair``, ``2 ext_pair + 1``, 3 the same times ``rho``, 4
    Shan-Chen interaction of fluids ``a`` and ``b`` (``p[0] = -G``, the
    pseudopotential ``spec``'s parameters in ``p[1:]``, ``belt`` 1 or 2,
    ``clamped`` neighbours)."""
    _fields_ = [("kind", _I), ("a", _I), ("b", _I), ("spec", _I),
                ("belt", _I), ("clamped", _I), ("ext_pair", _I),
                ("p", _F * 5)]


class McCollision(ctypes.Structure):
    """``Lb2dMcCollision``: ``kind`` 0 eating (``a`` eats ``b``), 1 growth
    of ``a`` inside ``(lo, hi)``; ``rate``."""
    _fields_ = [("kind", _I), ("a", _I), ("b", _I), ("lo", _F), ("hi", _F),
                ("rate", _F)]


class McParams(ctypes.Structure):
    """``Lb2dMcParams`` of ``csrc/mc_cell.cuh``, passed by value to K6's
    ``mc_step``: per fluid (at most 4) the BGK, feq, Guo and drag constants,
    the lattice weights, and the hooks (at most 16) and collisions (at most
    8) in registration order. The two change together."""
    _fields_ = [("omega", _F * 4), ("one_minus_omega", _F * 4),
                ("guo_pref", _F * 4), ("inv_feq_cu2", _F * 4),
                ("inv_feq_usq", _F * 4), ("inv_guo_cu", _F * 4),
                ("inv_guo_uf", _F * 4),
                ("eps", _F * 4), ("drag_lin", _F * 4), ("K", _F * 4),
                ("drag_fe", _F * 4), ("sqrt_K", _F * 4), ("w", _F * 25),
                ("inv_cs2", _F),
                ("zero_density", _F), ("porous", _I), ("num_hooks", _I),
                ("num_collisions", _I), ("hooks", McHook * 16),
                ("coll", McCollision * 8)]


class FftParams(ctypes.Structure):
    """``Lb2dFftParams`` of ``csrc/spectral_dft.cu``, passed by value to K8:
    the element and line strides of input and output, the line length
    ``n``, the number of lines, the outputs kept per line, the block shape,
    the input and output kinds, the direction and output scale, the screen
    prologue's ``ny``, ``hy`` and ``lam2``, and the radices of ``n``. The
    two change together."""
    _fields_ = [("in_elem", _LL), ("in_line", _LL), ("out_elem", _LL),
                ("out_line", _LL), ("n", _I), ("lines", _I),
                ("out_rows", _I), ("lines_per_block", _I), ("threads", _I),
                ("in_kind", _I), ("out_kind", _I), ("inverse", _I),
                ("out_scale", _F), ("ny", _I), ("hy", _I), ("lam2", _F),
                ("num_radices", _I), ("radices", _I * 32)]


class FftPass(ctypes.Structure):
    """``Lb2dFftPass`` of ``csrc/spectral_dft.cu``, passed by value to K8's
    tiled passes (``lb2d_tpu_torch/ops/spectral.py:FftPass`` holds the same
    fields): the kind and direction, the line length and its radices, the
    twiddle table's stride and the group twiddle, the block shape, the
    strides of rows, column groups and planes, the grid and the screen's
    constants. The two change together."""
    _fields_ = [("kind", _I), ("inverse", _I), ("n", _I),
                ("num_radices", _I), ("radices", _I * 12),
                ("tw_stride", _I), ("tw_group", _I), ("lines", _I),
                ("total", _I), ("threads", _I), ("groups", _I),
                ("planes", _I), ("n1", _I), ("in_pitch", _I),
                ("out_pitch", _I), ("in_len", _I), ("out_len", _I),
                ("in_gmul", _I), ("in_stride", _I), ("out_gmul", _I),
                ("out_stride", _I), ("ny", _I), ("nx", _I), ("lam2", _F),
                ("out_scale", _F)]


class CoupledParams(ctypes.Structure):
    """``Lb2dCoupledParams`` of ``csrc/coupled_cell.cuh``, passed by value
    to K7 and K7h: the physics, the two fields' ``omega`` and ``1 - omega``, the
    growth and production rates, ``-epsilon``, ``rho_o``, ``-cs^2 G_chen``,
    ``-G_chen``, the surface-tension ``c_o`` and exponent ``alpha`` and the
    D2Q9 weights. The two change together."""
    _fields_ = [("physics", _I), ("omega", _F), ("one_minus_omega", _F),
                ("omega2", _F), ("one_minus_omega2", _F), ("lb_G", _F),
                ("lb_G2", _F), ("neg_epsilon", _F), ("rho_o", _F),
                ("sc_pref", _F), ("neg_G_chen", _F), ("c_o", _F),
                ("alpha", _F), ("int_alpha", _I), ("w", _F * 9)]


# C entry point -> argument types; each returns a CUDA error code (int)
_ENTRY_POINTS = {
    # f_in, f_out, mask, ny, nx, omega, rho in, rho out, incompressible, stream
    "lb2d_pipe_step": [_P, _P, _P, _I, _I, _F, _F, _F, _I, _P],
    # f_in, f_out, mask, ny, nx, k_steps, omega, rho in/out, incomp., stream
    "lb2d_temporal_step": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P],
    # f_in, f_out, mask, ny, nx, k_steps, omega, u_w, u_e, velocity outlet,
    # incompressible, stream
    "lb2d_temporal_velocity_step": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I,
                                    _P],
    # the same, in 32 x 32 tiles (small grids)
    "lb2d_temporal_velocity_tiles": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _I,
                                     _I, _P],
    # f_in, f_out, ny, nx, k_steps, omega, u, v, G, Dg, noisy, key0, key1,
    # step0, stream
    "lb2d_temporal_diffusion_step": [_P, _P, _I, _I, _I, _F, _F, _F, _F, _F,
                                     _I, _U, _U, _ULL, _P],
    # f, scratch, scratch floats, mask, ny, nx, n, strip, bands,
    # cluster, omega, rho in/out, incomp., stream
    "lb2d_resident_run": [_P, _P, _LL, _P] + [_I] * 6 + [_F, _F, _F, _I, _P],
    # f, scratch, scratch floats, mask, ny, nx, n, strip, bands, cluster,
    # omega, u_w, u_e, velocity outlet, incompressible, stream
    "lb2d_resident_velocity_run": [_P, _P, _LL, _P] + [_I] * 6
                                  + [_F, _F, _F, _I, _I, _P],
    # f, scratch, scratch floats, ny, nx, n, strip, bands, cluster, omega, u,
    # v, G, Dg, noisy, key0, key1, step0, stream
    "lb2d_resident_diffusion_run": [_P, _P, _LL] + [_I] * 6 + [_F] * 5
                                   + [_I, _U, _U, _ULL, _P],
    # f_in, f_out, ny, nx, fields, k_steps, expansion, params, stream
    "lb2d_temporal_multifield_step": [_P, _P, _I, _I, _I, _I, _I,
                                      MultifieldParams, _P],
    # band, out, rows, nx, fields, k_steps, row0, ny, params, stream
    "lb2d_expansion_band_step": [_P, _P, _I, _I, _I, _I, _I, _I,
                                 MultifieldParams, _P],
    # f, top, bot, left, right, mask, f_out, H, W, hk, y0, x0, ny, nx,
    # k_steps, physics, incompressible, omega, a, b, G, Dg, key0, key1,
    # step0, stream
    "lb2d_halo_step": [_P] * 7 + [_I] * 10 + [_F] * 5 + [_U, _U, _ULL, _P],
    # f, top, bot, left, right, f_out, H, W, hk, y0, x0, ny, nx, fields,
    # k_steps, expansion, params, stream
    "lb2d_halo_multifield_step": [_P] * 6 + [_I] * 10 + [MultifieldParams,
                                                         _P],
    # f, rho, ny, nx, q, fluids, zero-gradient fluid mask, stream
    "lb2d_mc_density": [_P, _P, _I, _I, _I, _I, _I, _P],
    # f_in, f_out, rho, ext, ny, nx, q, fluids, zero-gradient fluid mask,
    # params, stream
    "lb2d_mc_step": [_P, _P, _P, _P, _I, _I, _I, _I, _I, McParams, _P],
    # f, top, bot, left, right, rho, H, W, hk, y0, x0, ny, nx, q, fluids,
    # zero-gradient fluid mask, stream
    "lb2d_mc_halo_density": [_P] * 6 + [_I] * 10 + [_P],
    # f, top, bot, left, right, f_out, rho, ext, H, W, hk, y0, x0, ny, nx,
    # q, fluids, zero-gradient fluid mask, params, stream
    "lb2d_mc_halo_step": [_P] * 8 + [_I] * 10 + [McParams, _P],
    # in0, in1, out0, out1, scratch, twiddle table, params, stream
    "lb2d_fft_lines": [_P, _P, _P, _P, _P, _P, FftParams, _P],
    # in0, in1, out0, out1, twiddle table, stage table, pass, stream
    "lb2d_fft_pass": [_P, _P, _P, _P, _P, _P, FftPass, _P],
    # f_in, f_out, rho, ext, ny, nx, k_steps, params, stream
    "lb2d_coupled_sweep": [_P, _P, _P, _P, _I, _I, _I, CoupledParams, _P],
    # f, top, bot, left, right, f_out, rho, ext, H, W, hk, y0, x0, ny, nx,
    # k_steps, params, stream
    "lb2d_coupled_halo_sweep": [_P] * 8 + [_I] * 8 + [CoupledParams, _P],
    # physics (no stream: the most steps of one launch)
    "lb2d_coupled_max_k": [_I],
    # in, out, rows, cols, stream
    "lb2d_transpose": [_P, _P, _I, _I, _P],
    # f, rho, u, v (NULL: not asked), cells, incompressible, stream
    "lb2d_moments": [_P, _P, _P, _P, _LL, _I, _P],
    # out, n, key0, key1, step, stream
    "lb2d_normals": [_P, _LL, _U, _U, _ULL, _P],
    "lb2d_normals_per_cell": [_P, _LL, _U, _U, _ULL, _P],
    "lb2d_philox_bits": [_P, _LL, _U, _U, _ULL, _P],
}

# the structs passed by value, and the C function that returns each one's
# size in the library (checked at load: a mismatch would shift the
# arguments after the struct)
_STRUCT_SIZES = {"lb2d_multifield_params_size": MultifieldParams,
                 "lb2d_mc_params_size": McParams,
                 "lb2d_fft_params_size": FftParams,
                 "lb2d_fft_pass_size": FftPass,
                 "lb2d_coupled_params_size": CoupledParams}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin "
                       f"({cuda_home}); the CUDA kernels cannot be built")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in _SOURCES + _HEADERS)


def _run_all(cmds):
    """Run the commands concurrently; raise with the stderr of the first
    that fails, after every one has ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errors):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")


def _compile():
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    objs = [LIB_PATH.parent / f"{src.stem}.{tag}.o" for src in _SOURCES]
    tmp = LIB_PATH.with_suffix(f".{tag}.tmp")
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Compile the kernels if needed and return the loaded library."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _compile()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, struct in _STRUCT_SIZES.items():
        size = getattr(lib, name)()
        if size != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {ctypes.sizeof(struct)} "
                               f"bytes, the kernels' struct {size}: the "
                               "ctypes mirror and csrc/ disagree")
    _lib = lib
    return lib
