from .lattice_units import (
    LatticePipeFlow,
    LatticePipeFlowPeriodicBC,
    PipeFlowVelocityInlet,
)
from .pipe_flow import PipeFlow, PipeFlowCylinder, PipeFlowObstacles, disk_mask

__all__ = [
    "PipeFlow", "PipeFlowCylinder", "PipeFlowObstacles",
    "PipeFlowVelocityInlet", "disk_mask", "LatticePipeFlow",
    "LatticePipeFlowPeriodicBC",
]
