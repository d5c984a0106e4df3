"""The training step: microbatch gradient accumulation, AdamW and the paper's
projection (port of ``repro/training/step.py``).

``make_train_step(cfg, tcfg, api, loss_fn=...)`` returns

    train_step(state, batch) -> (state, metrics)

  state = {"params", "opt"} ; batch = {"tokens": (n_micro, mb, ...)}

``batch["tokens"]`` is the per-step data leaf whatever its dtype or rank:
the SAE factory streams (n_micro, mb, d_model) activation rows through it.
The microbatch loop is a Python loop over the leading axis (``lax.scan`` in
the JAX package); gradients come from ``torch.autograd.grad`` and accumulate
in float32.

The optimizer epilogue is always the fused one (``optim/fused_step.py``):
AdamW update, multi-level projection and the param/master casts per
matched leaf in one pass; with the projection disabled or absent it is the
plain AdamW step. The step updates ``state``'s tensors in place (JAX
donates them) and returns it. The JAX package's unfused epilogue
(``fused=False``: AdamW, then the projection hook) waits for the slice that
needs it.

The LM next-token loss (``make_loss_fn``/``xent``) waits for the LM-training
slice, with the flash backward; so do in-step telemetry and the mesh path.
``loss_fn`` is therefore required.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig, TrainConfig
from repro_torch.optim import fused_step


def make_train_step(cfg: ArchConfig | None, tcfg: TrainConfig, api=None, *,
                    loss_fn: Callable = None) -> Callable:
    """Build the projected train step (see module docstring).

    ``loss_fn(params, microbatch) -> scalar tensor`` is the loss; the SAE
    factory passes the dictionary reconstruction loss.
    """
    if loss_fn is None:
        raise ValueError("make_train_step needs loss_fn=: the LM next-token "
                         "loss waits for the LM-training slice")

    def train_step(state, batch):
        params = state["params"]
        tokens = batch["tokens"]              # (n_micro, mb, ...)
        n_micro = tokens.shape[0]
        names_leaves = _tree.leaves_with_paths(params)
        leaves = [p for _, p in names_leaves]
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb in tokens:
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss = loss_fn(_tree.unflatten_like(params, live), mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            for a, g in zip(gsum, grads):
                if g is not None:
                    a.add_(g.float())
            lsum += loss.detach().float()
        grads = _tree.unflatten_like(params, [g / n_micro for g in gsum])
        loss = lsum / n_micro

        # one pass per leaf: update → project (f32) → cast, in place
        new_params, new_opt, metrics = fused_step.fused_update(
            grads, state["opt"], params, tcfg)
        metrics = dict(metrics, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
