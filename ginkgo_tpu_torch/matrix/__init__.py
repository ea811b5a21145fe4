from .auto import choose_format
from .bell import Bell
from .coo import Coo
from .csr import Csr
from .dense import Dense
from .dia import Dia
from .diagonal import Diagonal, Identity, IdentityFactory, Permutation, RowGatherer
from .ell import Ell, Sellp
from .fbcsr import Fbcsr
from .hybrid import Hybrid
from .pell import Pell
from .sparsity_csr import SparsityCsr
from .well import Well

__all__ = ["Bell", "Coo", "Csr", "Dense", "Dia", "Diagonal", "Ell", "Fbcsr", "Hybrid",
           "Identity", "IdentityFactory", "Pell", "Permutation", "RowGatherer", "Sellp",
           "SparsityCsr", "Well", "choose_format"]
