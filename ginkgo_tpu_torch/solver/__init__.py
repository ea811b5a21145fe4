from .bicgstab import Bicg, Bicgstab, Cgs
from .cg import Cg, Fcg
from .gmres import CbGmres, Gmres
from .idr import Idr
from .ir import Ir, Richardson
from .solver_base import SolveInfo, SolverFactory

__all__ = ["Bicg", "Bicgstab", "CbGmres", "Cg", "Cgs", "Fcg", "Gmres", "Idr", "Ir",
           "Richardson", "SolveInfo", "SolverFactory"]
