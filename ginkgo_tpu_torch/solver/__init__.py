from .cg import Cg, Fcg
from .solver_base import SolveInfo, SolverFactory

__all__ = ["Cg", "Fcg", "SolveInfo", "SolverFactory"]
