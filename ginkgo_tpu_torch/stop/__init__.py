from .criterion import (
    Criterion,
    Iteration,
    ResidualNorm,
    ImplicitResidualNorm,
    Combined,
    Time,
    FrozenBaselineResidualNorm,
    analyze_simple_residual,
    combine,
    default_criteria,
    freeze_initial_baseline,
)

__all__ = [
    "Criterion",
    "Iteration",
    "ResidualNorm",
    "ImplicitResidualNorm",
    "Combined",
    "Time",
    "FrozenBaselineResidualNorm",
    "analyze_simple_residual",
    "combine",
    "default_criteria",
    "freeze_initial_baseline",
]
