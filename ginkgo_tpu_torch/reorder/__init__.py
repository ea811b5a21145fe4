"""Reorderings: reverse Cuthill-McKee, nested dissection, and the
scaled-and-reordered solver wrapper (counterpart of ``ginkgo_tpu/reorder/``;
host set-up code, each permutation a ``Permutation`` on A's device)."""

from .rcm import Rcm, RcmFactory, rcm_permutation, bandwidth
from .nd import NestedDissection, NestedDissectionFactory, nd_permutation
from .scaled_reordered import ScaledReordered, ScaledReorderedFactory

__all__ = [
    "Rcm",
    "RcmFactory",
    "rcm_permutation",
    "bandwidth",
    "NestedDissection",
    "NestedDissectionFactory",
    "nd_permutation",
    "ScaledReordered",
    "ScaledReorderedFactory",
]
