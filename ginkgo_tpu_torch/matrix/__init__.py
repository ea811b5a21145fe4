from .dense import Dense
from .dia import Dia
from .diagonal import Diagonal, Identity

__all__ = ["Dense", "Dia", "Diagonal", "Identity"]
