from .auto import choose_format
from .bell import Bell
from .csr import Csr
from .dense import Dense
from .dia import Dia
from .diagonal import Diagonal, Identity
from .pell import Pell
from .well import Well

__all__ = ["Bell", "Csr", "Dense", "Dia", "Diagonal", "Identity", "Pell", "Well",
           "choose_format"]
