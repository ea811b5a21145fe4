from .pgm import (
    BandedProlongation,
    BandedRestriction,
    FixedCoarsening,
    FixedCoarseningFactory,
    MultigridLevel,
    Pgm,
    PgmFactory,
    Prolongation,
    Restriction,
    RowScatter,
    RowSelector,
)

__all__ = ["BandedProlongation", "BandedRestriction", "FixedCoarsening",
           "FixedCoarseningFactory", "MultigridLevel", "Pgm", "PgmFactory", "Prolongation",
           "Restriction", "RowScatter", "RowSelector"]
