from .criterion import (
    Criterion,
    Iteration,
    ResidualNorm,
    ImplicitResidualNorm,
    Combined,
    analyze_simple_residual,
    combine,
    default_criteria,
)

__all__ = [
    "Criterion",
    "Iteration",
    "ResidualNorm",
    "ImplicitResidualNorm",
    "Combined",
    "analyze_simple_residual",
    "combine",
    "default_criteria",
]
