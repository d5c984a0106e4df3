"""Structured-sparsity masks and double-descent support (port of
``repro/core/masks.py``; paper Appendix B, Alg. 8).

After a projection, whole columns (groups) are exactly zero. ``column_mask``
extracts the kept-column indicator; ``sparsity`` reports the paper's metric
(% of columns entirely zeroed). ``apply_mask`` freezes zeros for the second
descent of the double-descent schedule (mask ⊙ weights and mask ⊙ grads).
Trees are nested dicts walked with ``repro_torch._tree``.
"""

from __future__ import annotations

import torch

from repro_torch import _tree


def column_mask(x: torch.Tensor, axis: int = 0, tol: float = 0.0) -> torch.Tensor:
    """1.0 where the column (reduced over ``axis``) has any surviving weight."""
    return (x.abs().amax(dim=axis) > tol).to(x.dtype)


def sparsity(x: torch.Tensor, axis: int = 0, tol: float = 0.0) -> torch.Tensor:
    """Paper's sparsity score: % of columns set entirely to zero."""
    alive = x.abs().amax(dim=axis) > tol
    return 100.0 * (1.0 - alive.float().mean())


def element_sparsity(x: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """% of individual weights that are zero (unstructured sparsity)."""
    return 100.0 * (x.abs() <= tol).float().mean()


def mask_tree(params, axis: int = 0, tol: float = 0.0):
    """Column-mask every >=2-D leaf of a parameter tree (1-D leaves get
    ones)."""
    def one(p):
        if p.ndim >= 2:
            return column_mask(p, axis=axis, tol=tol).unsqueeze(axis).expand(p.shape)
        return torch.ones_like(p)

    return _tree.tree_map(one, params)


def apply_mask(tree, masks):
    """Elementwise freeze: used on both weights and grads in descent #2."""
    return _tree.tree_map(lambda p, m: p * m, tree, masks)
