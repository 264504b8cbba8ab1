from .diffusion import (
    AdvectionDiffusion,
    Diffusion,
    ReactionAdvectionDiffusion,
    ReactionAdvectionDiffusionStochastic,
    ReactionDiffusion,
)
from .multicomponent import Fluid, SimulationRunner
from .multifield import Expansion, FisherExpansion
from .lattice_units import (
    LatticePipeFlow,
    LatticePipeFlowPeriodicBC,
    PipeFlowVelocityInlet,
)
from .pipe_flow import PipeFlow, PipeFlowCylinder, PipeFlowObstacles, disk_mask
from .poisson import PoissonSolver
from .rocket_yeast import RocketYeast, RocketYeastForcesOnly
from .spectral import ScreenedPoisson, screened_poisson_solve
from .surfactant import (
    ClumpySurfactantNutrientWave,
    SurfactantNutrientWave,
)
from .waves import (
    NoisyAdvectedFisherWave,
    RepellingFisherWave,
    ScreenedFisherWave,
)

__all__ = [
    "PipeFlow", "PipeFlowCylinder", "PipeFlowObstacles",
    "PipeFlowVelocityInlet", "disk_mask", "LatticePipeFlow",
    "LatticePipeFlowPeriodicBC",
    "Diffusion", "AdvectionDiffusion", "ReactionDiffusion",
    "ReactionAdvectionDiffusion", "ReactionAdvectionDiffusionStochastic",
    "NoisyAdvectedFisherWave", "RepellingFisherWave", "FisherExpansion",
    "Expansion",
    "Fluid", "SimulationRunner", "PoissonSolver", "ScreenedPoisson",
    "screened_poisson_solve",
    "ScreenedFisherWave", "SurfactantNutrientWave",
    "ClumpySurfactantNutrientWave", "RocketYeast", "RocketYeastForcesOnly",
]
