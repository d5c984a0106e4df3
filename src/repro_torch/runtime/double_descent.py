"""Double-descent training schedule (port of
``repro/runtime/double_descent.py``; paper Appendix B, Algorithm 8).

descent #1: train N epochs → project (BP^{p,q}) → extract the zero mask →
rewind surviving weights to their INITIAL values → descent #2: retrain with
the mask frozen (grads and weights multiplied by the mask every step).
This is the lottery-ticket-style schedule the paper uses for its SAE tables.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch import _tree
from repro_torch.configs.types import ProjectionSpec
from repro_torch.core import masks as M
from repro_torch.optim.projection_hook import project_tree


def double_descent(init_params, train_epochs_fn: Callable, spec: ProjectionSpec,
                   projector: Optional[Callable] = None, rewind: bool = True):
    """Run the two descents (paper Alg. 8: project ONCE after descent #1).

    ``train_epochs_fn(params, mask_or_None) -> trained_params`` runs one
    full descent (the caller owns optimizer and loop). ``projector``
    overrides the mask-inducing projection (e.g. the exact ℓ1,∞ baseline).
    ``rewind=False`` is the fine-tuning ablation: descent #2 continues from
    the PROJECTED weights instead of the masked initialization. Returns
    ``(final_params, mask_tree, sparsity_per_leaf)``.
    """
    # descent 1 — unconstrained
    trained = train_epochs_fn(init_params, None)
    # project onto the ball, then freeze the induced structured mask
    projected = projector(trained) if projector is not None \
        else project_tree(trained, spec)
    mask = _tree.tree_map(lambda p: (p.abs() > 0).to(p.dtype), projected)
    # rewind: surviving weights restart from initialization (masked);
    # no-rewind: keep the projected weights and fine-tune under the mask
    start = init_params if rewind else projected
    rewound = _tree.tree_map(lambda w0, m: w0 * m, start, mask)
    # descent 2 — masked retrain
    final = train_epochs_fn(rewound, mask)
    stats = {name: float(M.sparsity(p.reshape(-1, p.shape[-1]), axis=0))
             for name, p in _tree.leaves_with_paths(final) if p.ndim >= 2}
    return final, mask, stats
