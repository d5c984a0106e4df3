"""The training step: microbatch gradient accumulation, per-layer remat
(inside the models), AdamW and the paper's projection (port of
``repro/training/step.py``).

``make_train_step(cfg, tcfg, api, impl=...)`` returns

    train_step(state, batch) -> (state, metrics)

  state = {"params", "opt"} ; batch = {"tokens": (n_micro, mb, ...)}

The loss is next-token cross-entropy (:func:`xent`, logsumexp minus the
gathered target logit, in float32) of the LM run on the parameters cast to
``tcfg.compute_dtype`` (:func:`make_loss_fn`), unless ``loss_fn=`` replaces
it: ``batch["tokens"]`` is then the per-step data leaf whatever its dtype
or rank, and the SAE factory streams (n_micro, mb, d_model) activation rows
through it.
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

In-step telemetry (``telemetry_every``/``telemetry_marks``) and the mesh
path (``n_groups``, ``act_spec``, ``logits_spec``, ``mesh``) wait for their
slices.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig, TrainConfig
from repro_torch.models import params as PM
from repro_torch.optim import adamw, fused_step


def xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (B,S,V) any float dtype; targets (B,S) int. Mean nll in f32:
    logsumexp minus the gathered target logit (no (B,S,V) one-hot)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return (lse - tgt).mean()


def make_loss_fn(cfg: ArchConfig, api, *, impl: str, remat: bool,
                 compute_dtype: torch.dtype) -> Callable:
    """``loss_fn(params, tokens)``: the LM on ``tokens[:, :-1]`` with its
    float32/bf16 leaves cast to ``compute_dtype``, next-token :func:`xent`
    against ``tokens[:, 1:]``, plus 0.01 of a non-zero aux term."""
    def loss_fn(params, tokens):
        cparams = _tree.tree_map(
            lambda p: p.to(compute_dtype)
            if p.dtype in (torch.float32, torch.bfloat16) else p, params)
        logits, aux = api.forward(cparams, tokens[:, :-1], cfg, impl=impl,
                                  remat=remat)
        loss = xent(logits, tokens[:, 1:])
        if isinstance(aux, torch.Tensor) or aux:
            loss = loss + 0.01 * aux
        return loss

    return loss_fn


def make_train_step(cfg: ArchConfig | None, tcfg: TrainConfig, api=None, *,
                    impl: str = "chunked", loss_fn: Callable = None) -> Callable:
    """Build the projected train step (see module docstring).

    ``loss_fn(params, microbatch) -> scalar tensor`` overrides the LM
    next-token loss of ``make_loss_fn(cfg, api, impl=impl, ...)``; the SAE
    factory passes the dictionary reconstruction loss.
    """
    if loss_fn is None:
        loss_fn = make_loss_fn(cfg, api, impl=impl, remat=tcfg.remat,
                               compute_dtype=getattr(torch, tcfg.compute_dtype))

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
            del loss, grads, live  # free this microbatch's graph and grads
        # the mean in place: the accumulator is the gradient tree, so a full
        # float32 copy of it never coexists with it
        for a in gsum:
            a.div_(n_micro)
        grads = _tree.unflatten_like(params, gsum)
        loss = lsum / n_micro

        # one pass per leaf: update → project (f32) → cast, in place
        new_params, new_opt, metrics = fused_step.fused_update(
            grads, state["opt"], params, tcfg)
        metrics = dict(metrics, loss=loss)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(cfg: ArchConfig, tcfg: TrainConfig, api, seed: int, *,
               device=None):
    """``{"params", "opt"}``: the template initialised from ``seed`` in
    ``tcfg.param_dtype`` on ``device`` (the card by default), and AdamW's
    state."""
    params = PM.init_params(api.template(cfg), seed,
                            getattr(torch, tcfg.param_dtype), device=device)
    return {"params": params, "opt": adamw.init(params, tcfg)}
