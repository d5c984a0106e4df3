"""Structured-sparsity score (port of ``repro/core/masks.py``, the part the
SAE factory reads; paper Appendix B).

After a projection, whole columns (groups) are exactly zero; ``sparsity``
reports the paper's metric, the % of columns entirely zeroed. The
double-descent helpers (``column_mask``, ``mask_tree``, ``apply_mask``) and
``element_sparsity`` wait for the §7.3 tables slice.
"""

from __future__ import annotations

import torch


def sparsity(x: torch.Tensor, axis: int = 0, tol: float = 0.0) -> torch.Tensor:
    """Paper's sparsity score: % of columns set entirely to zero."""
    alive = x.abs().amax(dim=axis) > tol
    return 100.0 * (1.0 - alive.float().mean())
