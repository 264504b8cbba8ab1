"""The port imports nothing of the JAX package and no JAX.

A fresh interpreter blocks ``lb2d_tpu`` and ``jax`` (``sys.modules[name] =
None`` makes any import of them raise), then imports ``lb2d_tpu_torch``,
every one of its submodules, the scripts of ``examples_torch`` and
``chip_smoke`` (import only), and checks that no module of either package
was loaded.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

CODE = r"""
import importlib, pkgutil, sys
preloaded = {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")}
for name in ("lb2d_tpu", "jax", "jaxlib"):
    sys.modules.setdefault(name, None)  # any import of it now raises
import lb2d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lb2d_tpu_torch.__path__,
                                               "lb2d_tpu_torch.")]
import examples_torch
scripts = [m.name for m in pkgutil.iter_modules(examples_torch.__path__,
                                                "examples_torch.")]
for name in names + scripts:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and m not in preloaded
                and m.split(".")[0] in ("lb2d_tpu", "jax", "jaxlib"))
print(" ".join(names + scripts))
sys.exit(f"loaded {loaded}" if loaded else 0)
"""


def test_port_and_chip_smoke_import_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = proc.stdout.split()
    for name in ("lb2d_tpu_torch.core.lattice", "lb2d_tpu_torch.core.nondim",
                 "lb2d_tpu_torch.ops.random", "lb2d_tpu_torch.models.diffusion",
                 "lb2d_tpu_torch.models.waves",
                 "lb2d_tpu_torch.models.multifield",
                 "lb2d_tpu_torch.models.multicomponent",
                 "lb2d_tpu_torch.ops.fused_mc", "lb2d_tpu_torch.mc_cases",
                 "lb2d_tpu_torch.ops.spectral",
                 "lb2d_tpu_torch.ops.fused_coupled",
                 "lb2d_tpu_torch.ops.coupled_sweep",
                 "lb2d_tpu_torch.models.spectral",
                 "lb2d_tpu_torch.models.surfactant",
                 "lb2d_tpu_torch.models.rocket_yeast",
                 "lb2d_tpu_torch.ops.fused_halo",
                 "lb2d_tpu_torch.halo_cases",
                 "lb2d_tpu_torch.parallel",
                 "lb2d_tpu_torch.parallel.halo",
                 "lb2d_tpu_torch.parallel.distributed",
                 "lb2d_tpu_torch.parallel.sharded",
                 "lb2d_tpu_torch.models.poisson",
                 "lb2d_tpu_torch.utils.checkpoint",
                 "lb2d_tpu_torch.utils.metrics",
                 "lb2d_tpu_torch.utils.profiling",
                 "lb2d_tpu_torch.utils.render",
                 "lb2d_tpu_torch.native"):
        assert name in imported, imported
    scripts = [name for name in imported if name.startswith("examples_torch.")]
    assert sorted(scripts) == sorted(
        f"examples_torch.{p.stem}" for p in (REPO / "examples").glob("*.py")
        if p.stem != "__init__"), scripts
