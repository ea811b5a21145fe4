from .factorization import Factorization
from .ilu import Ic, IcFactory, Ilu, IluFactory
from .lu import Lu, LuFactory, elimination_forest, symbolic_cholesky
from .par_ilu import ParIc, ParIcFactory, ParIlu, ParIluFactory
from .par_ilut import ParIct, ParIctFactory, ParIlut, ParIlutFactory

__all__ = ["Factorization", "Ic", "IcFactory", "Ilu", "IluFactory", "Lu", "LuFactory",
           "ParIc", "ParIcFactory", "ParIct", "ParIctFactory", "ParIlu", "ParIluFactory",
           "ParIlut", "ParIlutFactory", "elimination_forest", "symbolic_cholesky"]
