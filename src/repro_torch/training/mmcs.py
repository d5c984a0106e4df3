"""Mean Max Cosine Similarity — comparing learned SAE dictionaries (port of
``repro/training/mmcs.py``).

    MMCS(A, B) = mean_i max_j |cos(a_i, b_j)|

over the columns (features) of ``A`` (d, ka) and ``B`` (d, kb). ``|cos|``
makes the score invariant to per-feature sign flips and the max to feature
permutation — the two gauge freedoms of a learned dictionary. ``mmcs_sym``
averages both directions. Inputs are tensors or numpy arrays; the result is
a 0-d float32 tensor on the first argument's device (the CPU for numpy).
"""

from __future__ import annotations

import torch


def _f32(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device).float()


def _unit_columns(a, eps):
    n = torch.linalg.vector_norm(a, dim=0, keepdim=True)
    return a / torch.clamp(n, min=eps)


def mmcs(a, b, *, eps: float = 1e-9):
    """Directional MMCS(A, B): mean over A's columns of the best |cos| in B.

    MMCS(A, A) == 1; zero columns match nothing (their cosines are 0)."""
    a = _unit_columns(_f32(a), eps)
    b = _unit_columns(_f32(b, a.device), eps)
    cos = (a.T @ b).abs()                      # (ka, kb)
    return cos.amax(dim=1).mean()


def mmcs_sym(a, b, *, eps: float = 1e-9):
    """Symmetrized MMCS: (MMCS(A,B) + MMCS(B,A)) / 2."""
    return 0.5 * (mmcs(a, b, eps=eps) + mmcs(b, a, eps=eps))


def mmcs_table(dicts: dict, *, eps: float = 1e-9) -> dict:
    """Pairwise symmetric MMCS across named dictionaries:
    ``{(name_i, name_j): float}`` for i < j in insertion order."""
    names = list(dicts)
    out = {}
    for i, ni in enumerate(names):
        for nj in names[i + 1:]:
            out[(ni, nj)] = float(mmcs_sym(dicts[ni], dicts[nj], eps=eps))
    return out
