"""K6, the multicomponent step of ``SimulationRunner``: ``mc_density``
and ``mc_step`` of ``csrc/mc_step.cu`` (``mc_cell.cuh``), one launch of
each a step. The work of its steps is the configuration's
(``configs/<config>.py``'s ``work``)."""

PATTERN = r"mc_density_kernel|mc_step_kernel"
