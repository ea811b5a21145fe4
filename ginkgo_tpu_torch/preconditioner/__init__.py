from .ilu import Ic, IcPreconditionerFactory, Ilu, IluPreconditioner, IluPreconditionerFactory
from .isai import GeneralIsai, Isai, IsaiFactory, LowerIsai, SpdIsai, UpperIsai
from .jacobi import Jacobi, JacobiFactory

__all__ = ["GeneralIsai", "Ic", "IcPreconditionerFactory", "Ilu", "IluPreconditioner",
           "IluPreconditionerFactory", "Isai", "IsaiFactory", "Jacobi", "JacobiFactory",
           "LowerIsai", "SpdIsai", "UpperIsai"]
