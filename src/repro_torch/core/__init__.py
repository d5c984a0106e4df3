"""Projection core of the port: θ-solvers and norm balls (``ball``), the
schedule IR (``schedule``), multi-/bi-level projections and the planner
(``plan``)."""
