"""The benchmark of ``lb2d_tpu_torch`` on one NVIDIA H100.

``python3 lbbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one piece sits in a file of its own,
found by name:

* ``configs/<config>.py``: builds the port's model for a traffic mix and
  drives one interval (``run(M)`` and the user's readouts);
* ``traffic/<mix>.json``: grid, geometry, steps per interval, readouts;
* ``reference/<config>.py``: the plain reference, which imports nothing of
  the port;
* ``limits/<workload>.json``: the limit of each number compared;
* ``kernels/<family>.py``: a kernel family's profiler names (the work its
  steps need is the configuration's ``work``);
* ``metrics/<metric>.py``: a reader of the traced run.

The package imports neither ``jax`` nor ``lb2d_tpu`` (the JAX package);
the port is imported only by the configurations.
"""
