"""Time variants of P1 (``lb2d_tpu_torch/csrc/normals.cu``) on the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/p1_variants.py

It writes each variant of the checkout's ``normals.cu`` to the gitignored
``tools/_p1_variants/``, builds each alone into a shared library (one
``nvcc`` each, all at once), holds each variant's ``lb2d_normals`` bit for
bit to the first one-cell-a-thread loop (``lb2d_normals_per_cell``) for a
2048^2 field at three steps and four alignments of ``out``, prints each
variant's SASS instructions (``tools/sass_count.py``'s counts) and then its
ms per launch by CUDA-graph replay (20 launches a graph, 20 replays), four
rounds in rotating order, the first loop in each round. The variants:

* ``repo``: the checkout's kernel (four cells a thread, one 16-byte store
  in PTX);
* ``cast4``: the same with a ``float4`` store through a cast pointer;
* ``repo8``: eight cells a thread, two 16-byte stores;
* ``repo_cap``: at most 1,056 blocks (8 an SM), about four quads a thread;
* ``scalar1``, ``scalar2``: one and two cells a thread, 4-byte stores (the
  launch's hoisted Philox words alone, and with a second cell).
"""

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path.cwd()
CSRC = ROOT / "lb2d_tpu_torch" / "csrc"
OUT = ROOT / "tools" / "_p1_variants"
N = 2048 * 2048
KEY = (12345, 2)

_STORE = '''    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(out + i),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");'''
_CAST = ("    *reinterpret_cast<float4*>(out + i) = "
         "make_float4(v[0], v[1], v[2], v[3]);")
_EACH4 = '''#pragma unroll
    for (int k = 0; k < kCells; k += 4)
      asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(
                       out + i + k), "f"(v[k]), "f"(v[k + 1]), "f"(v[k + 2]),
                   "f"(v[k + 3]) : "memory");'''
_SCALAR = '''#pragma unroll
    for (int k = 0; k < kCells; ++k) out[i + k] = v[k];'''
_CELLS = "constexpr int kCells = 4;"
_GRID = "normals_kernel<<<grid_for(quads > ragged ? quads : ragged), kBlock, 0,"
_CAP = ("normals_kernel<<<(quads > 1056 * kBlock ? 1056 : "
        "grid_for(quads > ragged ? quads : ragged)), kBlock, 0,")


def _variants(src):
    for part in (_STORE, _CELLS, _GRID):
        if part not in src:
            raise RuntimeError(f"normals.cu has changed: {part!r} not found")
    return {
        "repo": src,
        "cast4": src.replace(_STORE, _CAST),
        "repo8": src.replace(_STORE, _EACH4).replace(
            _CELLS, "constexpr int kCells = 8;"),
        "repo_cap": src.replace(_GRID, _CAP),
        "scalar1": src.replace(_STORE, _SCALAR).replace(
            _CELLS, "constexpr int kCells = 1;"),
        "scalar2": src.replace(_STORE, _SCALAR).replace(
            _CELLS, "constexpr int kCells = 2;"),
    }


def _sass_counts(lib):
    spec = importlib.util.spec_from_file_location(
        "sass_count", ROOT / "tools" / "sass_count.py")
    sass_count = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass_count)
    sass = subprocess.run([sass_count._cuobjdump(), "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    for name, lines in sass_count._kernels(sass):
        if "14normals_kernel" in name:
            counts = sass_count._count(lines)
            counts.pop("opcodes")
            counts["stg128"] = sum("STG.E.128" in line for line in lines)
            return counts
    return None


def _graph_ms(fn, per_graph=20, replays=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / per_graph


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "normals.cu").read_text()
    nvcc = os.environ.get("NVCC", "nvcc")
    procs = {}
    for name, text in _variants(src).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(CSRC), "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ("lb2d_normals", "lb2d_normals_per_cell"):
            getattr(lib, fn).argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p]
        libs[name] = lib
        print(json.dumps({"variant": name,
                          **_sass_counts(OUT / f"{name}.so")}), flush=True)

    def call(lib, fn, out, step=7):
        err = getattr(lib, fn)(out.data_ptr(), out.numel(), *KEY, step,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err}")

    first = torch.empty(N, device="cuda")
    buf = torch.empty(N + 4, device="cuda")
    for name, lib in libs.items():
        for step in (0, 7, 2**32 + 1):
            call(lib, "lb2d_normals_per_cell", first, step)
            for skip in range(4):
                out = buf[skip:skip + N]
                call(lib, "lb2d_normals", out, step)
                torch.cuda.synchronize()
                if not torch.equal(out, first):
                    raise RuntimeError(f"{name} differs from the first loop "
                                       f"(step {step}, out + {skip})")
    print("every variant equals the first loop bit for bit", flush=True)
    out = torch.empty(N, device="cuda")
    names = list(libs)
    times = {name: [] for name in names + ["first loop"]}
    for r in range(4):
        for name in names[r:] + names[:r]:
            times[name].append(_graph_ms(
                lambda: call(libs[name], "lb2d_normals", out)))
        times["first loop"].append(_graph_ms(
            lambda: call(libs["repo"], "lb2d_normals_per_cell", out)))
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "ms_by_graph_replay": times}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
