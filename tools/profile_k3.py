"""Where a step of K3 spends its time, on the card: block 0's clock cycles
per step in each phase of ``csrc/resident_run.cu`` (the exchange's signal
and wait, the fetch of the halo rows, the compute of the cells, the write
of the rows with the next exchange's edges), beside the ms per 1000-step
launch, at the main paths' shapes and at other cuts of 32 x 256.

    cd <checkout> && python3 tools/profile_k3.py [label]

copies the port into ``tools/_k3_profile/`` (gitignored), adds a cycle
counter (``clock64``) at each phase boundary of thread 0 of the kernel and
an entry that reads block 0's sums (``lb2d_resident_profile``), builds that
copy (all kernels, about two minutes) and prints one JSON line. The counts
are thread 0's, so each phase includes the block barrier that ends it and
the wait for the block's slowest warp.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
COPY = Path(__file__).resolve().parent / "_k3_profile"

# (before, after, text): the text goes between the two in
# csrc/resident_run.cu
PROBES = [
    ("", "template <int kPhys, bool kIncomp, bool kObstacle, bool kStrip>\n"
     "__global__",
     "__device__ long long g_prof[8];\n"
     "#define PROF(k) if (tid == 0) { const long long t_ = clock64(); \\\n"
     "  prof[k] += t_ - tick; tick = t_; }\n"),
    ("  __syncthreads();\n\n", "  for (int e = 0; e < n; ++e) {",
     "  long long prof[5] = {0, 0, 0, 0, 0};\n"
     "  long long tick = clock64();\n"),
    ("      __syncthreads();\n    }\n", "    // fetch:", "    PROF(1)\n"),
    ("    __syncthreads();\n\n", "    // the step:", "    PROF(2)\n"),
    ("      __syncthreads();  // every cell of the group has pulled\n", "",
     "      PROF(3)\n"),
    ("      __syncthreads();\n", "    }\n    off = off == 0",
     "      PROF(4)\n"),
    ("", "  // no block leaves while",
     "  if (tid == 0 && b == 0) {\n"
     "    for (int k = 0; k < 5; ++k) g_prof[k] = prof[k];\n"
     "    g_prof[5] = n; g_prof[6] = bands; g_prof[7] = cluster_size;\n"
     "  }\n"),
]
READ = ('\nextern "C" int lb2d_resident_profile(long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
        "}\n")


def instrument(src: str) -> str:
    for before, after, text in PROBES:
        assert src.count(before + after) == 1, before + after
        at = src.index(before + after) + len(before)
        src = src[:at] + text + src[at:]
    return src + READ


CASES = [  # physics, ny, nx, bands, cluster (None: the plan's)
    ("flow", 32, 256, None, None), ("flow", 32, 256, 32, 1),
    ("flow", 32, 256, 16, 1), ("diffusion", 32, 256, None, None),
    ("diffusion", 32, 256, 16, 1), ("flow", 31, 61, None, None),
    ("noisy_fisher", 256, 256, None, None),
    ("diffusion", 256, 256, None, None),
    ("diffusion", 512, 512, None, None),
    ("velocity_inlet", 401, 401, None, None),
]


def probe(label):
    """In the instrumented copy: time and profile each case."""
    import ctypes

    import torch

    from lb2d_tpu_torch.ops import _build, resident_plan as rp
    from lb2d_tpu_torch.ops.fused import (
        resident_diffusion_run,
        resident_pipe_run,
        resident_scratch,
        resident_velocity_run,
    )

    read = _build.load_library().lb2d_resident_profile
    plan = rp.plan
    out = {"label": label, "card": torch.cuda.get_device_name(0)}
    g = torch.Generator(device="cuda").manual_seed(0)
    w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4,
                     device="cuda")[:, None, None]
    for physics, ny, nx, bands, cluster in CASES:
        if bands:
            rp.plan = (lambda ny_, nx_, sms=132, b=bands, c=cluster:
                       plan(ny_, nx_, sms)._replace(
                           bands=b, cluster=c,
                           smem=rp.smem_bytes(ny_, nx_, b, c),
                           exchange=rp.exchange_floats(b, nx_)))
        if physics in ("diffusion", "noisy_fisher"):
            rho = 0.1 + 0.8 * torch.rand((ny, nx), device="cuda", generator=g)
            f = (w * rho).contiguous()
        else:
            f = ((1 + 0.01 * torch.randn((9, ny, nx), device="cuda",
                                         generator=g)) / 9).contiguous()
        s = resident_scratch(f)
        if physics == "flow":
            def run():
                resident_pipe_run(f, s, 1000, 1.3, 1.003, 1.0,
                                  incompressible=False)
        elif physics == "velocity_inlet":
            def run():
                resident_velocity_run(f, s, 1000, 1.3, 0.05, 0.04,
                                      outlet="zero_gradient",
                                      incompressible=False)
        else:
            kw = (dict(lb_Dg=0.05, noisy=True, seed=7)
                  if physics == "noisy_fisher" else {})

            def run():
                resident_diffusion_run(f, s, 1000, 1.6, 0.0029, -0.0017,
                                       0.0025, **kw)
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                run()
            z.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(z) / 5)
        buf = (ctypes.c_longlong * 8)()
        read(buf)
        rp.plan = plan
        out[f"{physics} {ny}x{nx}" + (f" bands={bands} cluster={cluster}"
                                      if bands else "")] = {
            "ms per 1000 steps": sorted(times)[1],
            "cycles per step: wait, fetch, compute, write":
                [round(buf[k] / buf[5], 1) for k in range(1, 5)],
            "bands, cluster": [buf[6], buf[7]]}
    print(json.dumps(out), flush=True)


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else str(ROOT)
    if os.environ.get("LB2D_K3_PROFILE_CHILD"):
        probe(label)
        return
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(ROOT / "lb2d_tpu_torch", COPY / "lb2d_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    kernel = COPY / "lb2d_tpu_torch" / "csrc" / "resident_run.cu"
    kernel.write_text(instrument(kernel.read_text()))
    build = COPY / "lb2d_tpu_torch" / "ops" / "_build.py"
    text = build.read_text()
    entry = '    "lb2d_normals": [_P, _LL, _U, _U, _ULL, _P],\n'
    build.write_text(text.replace(
        entry, entry + '    "lb2d_resident_profile": [_P],\n'))
    env = dict(os.environ, LB2D_K3_PROFILE_CHILD="1")
    subprocess.run([sys.executable, __file__, label], cwd=COPY, env=env,
                   check=True)


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()
