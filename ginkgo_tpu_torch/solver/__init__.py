from .bicgstab import Bicg, Bicgstab, Cgs
from .cg import Cg, Fcg
from .direct import Direct, DirectFactory
from .gmres import CbGmres, Gmres
from .idr import Idr
from .ir import Ir, Richardson
from .multigrid import FixedSmoother, Multigrid, MultigridFactory
from .solver_base import SolveInfo, SolverFactory
from .triangular import LowerTrs, LowerTrsFactory, TriangularSolver, UpperTrs, UpperTrsFactory

__all__ = ["Bicg", "Bicgstab", "CbGmres", "Cg", "Cgs", "Direct", "DirectFactory", "Fcg",
           "FixedSmoother", "Gmres", "Idr", "Ir", "LowerTrs", "LowerTrsFactory", "Multigrid",
           "MultigridFactory", "Richardson", "SolveInfo",
           "SolverFactory", "TriangularSolver", "UpperTrs", "UpperTrsFactory"]
