"""Projection core of the port: θ-solvers and norm balls (``ball``), the
schedule IR (``schedule``), multi-/bi-level projections and the planner
(``plan``), and the exact ℓ1,∞ baseline (``exact_l1inf``)."""

from .exact_l1inf import (  # noqa: F401
    l1inf_norm,
    project_l1inf_exact,
    project_l1inf_exact_bisect,
)
