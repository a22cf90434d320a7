"""stfem_tpu: space-time finite-element multigrid framework in JAX.

Capabilities of immaaane/dealii-stfem (Margenberg & Munch space-time
multigrid, arXiv:2408.04372 / arXiv:2502.09159) rebuilt for JAX/XLA on GPUs.
See ARCHITECTURE.md for the design and STATUS.md for the component map.
"""

from .blocks import BlockSlice
from .config import Parameters
from .krylov import fgmres, gmres_fixed_left
from .system import SystemMatrix
from .system_stokes import StokesSystemMatrix
from .types import (CoarseningType, MGType, NonlinearExtrapolation,
                    NonlinearTreatment, ProblemType, SupportedSmoothers,
                    TimeStepType)

__all__ = [
    "BlockSlice", "Parameters", "fgmres", "gmres_fixed_left",
    "SystemMatrix", "StokesSystemMatrix", "CoarseningType", "MGType",
    "NonlinearExtrapolation", "NonlinearTreatment", "ProblemType",
    "SupportedSmoothers", "TimeStepType",
]

__version__ = "0.1.0"
