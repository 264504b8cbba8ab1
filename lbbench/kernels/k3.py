"""K3, the flow steps of ``PipeFlow`` on grids K3 holds in shared
memory: ``csrc/resident_run.cu`` (``resident_plan.cuh``), the whole
``run(n)`` in one launch. The work of its steps is the configuration's
(``configs/<config>.py``'s ``work``)."""

PATTERN = r"resident_band_kernel"
