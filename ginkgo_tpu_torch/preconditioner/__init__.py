from .jacobi import Jacobi, JacobiFactory

__all__ = ["Jacobi", "JacobiFactory"]
