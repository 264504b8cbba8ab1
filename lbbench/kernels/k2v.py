"""K2v, the velocity inlet's steps of ``PipeFlowVelocityInlet``, whichever
K2 kernel runs them: ``csrc/temporal_step.cu``'s 32 x 32 tiles
(``velocity_tile_kernel``, grids of up to ``VELOCITY_TILE_MAX_CELLS``
cells) or its row sweep (``temporal_step_kernel``, above), K steps a
launch. The sweep's kernel name is K2's flow family's too; the
configuration that runs this family (``velocity_inlet``) runs no pressure
flow, so no other family's work mixes in. The work of its steps is the
configuration's (``configs/<config>.py``'s ``work``)."""

PATTERN = r"velocity_tile_kernel|temporal_step_kernel"
