from .csr import Csr
from .dense import Dense
from .dia import Dia
from .diagonal import Diagonal, Identity
from .pell import Pell

__all__ = ["Csr", "Dense", "Dia", "Diagonal", "Identity", "Pell"]
