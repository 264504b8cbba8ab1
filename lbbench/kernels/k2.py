"""K2, the flow steps of ``PipeFlow`` on grids too large for K3: the
row sweep of ``csrc/temporal_step.cu`` (``temporal_sweep.cuh``,
``row_sweep.cuh``), K steps a launch, and K1 (``csrc/pipe_step.cu``),
which runs the rest of a ``run(n)`` that K does not divide. Both advance
the same flow steps, so they are one family. The work of its steps is the
configuration's (``configs/<config>.py``'s ``work``)."""

PATTERN = r"temporal_step_kernel|pipe_step_kernel"
