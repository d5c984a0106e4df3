"""Paper §7.3 supervised-autoencoder experiments (Tables 2–5): test accuracy
against structured sparsity under five projections, with double descent
(port of the sweep in ``benchmarks/sae_tables.py``).

Synthetic = the ``make_classification`` clone (1000 × 2000, 64 informative,
sep 0.8); Lung-like = the log-normal heteroscedastic generator (1005 ×
2944): ``repro_torch.data.classification_synthetic`` and ``lung_like``,
nothing downloaded. 80/20 split, 5 methods: baseline (no projection), exact
ℓ1,∞, bi-level ℓ1,∞, ℓ1,1 and ℓ1,2 of the first encoder weight. Reported:
test accuracy % and the column sparsity % of that weight (the paper's
metric). This is the application the tables come from, not a timing
benchmark: the rows' times are the host clock of each method's run.

    python -m repro_torch.training.sae_tables [--full] [--device cpu]

prints one ``name,us_per_call,derived`` row per dataset and method.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import _device, _tree
from repro_torch.configs import registry
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.core.exact_l1inf import project_l1inf_exact
from repro_torch.core.masks import apply_mask, sparsity
from repro_torch.data import classification_synthetic, lung_like
from repro_torch.models import params as PM, sae
from repro_torch.optim import adamw
from repro_torch.optim.projection_hook import project_tree
from repro_torch.runtime.double_descent import double_descent

METHODS = ("baseline", "exact_l1inf", "bilevel_l1inf", "bilevel_l11",
           "bilevel_l12")


def _exact_enc1(params, radius):
    """The exact ℓ1,∞ projection of the first encoder weight's transpose
    (the same groups as the bi-level specs' ``transpose=True``)."""
    w = project_l1inf_exact(params["enc1"]["w"].T, radius).T.contiguous()
    return dict(params, enc1=dict(params["enc1"], w=w))


def train_fn(cfg, xtr, ytr, *, epochs, lr, alpha=0.1, device=None,
             losses: Optional[list] = None) -> Callable:
    """``train_epochs(params, mask) -> params`` for :func:`double_descent`:
    ``epochs`` full-batch AdamW steps of the supervised autoencoder's loss
    (α·Huber + CE, SiLU) from a fresh optimizer state, grads and weights
    multiplied by ``mask`` when one is given. ``losses``, a list, receives
    each descent's per-step losses (floats) as one list. (The JAX sweep's
    per-step ``constrain`` projection is set by none of its callers and is
    not carried over: the projection runs once, between the descents.)"""
    dev = _device.resolve(device)
    tcfg = TrainConfig(lr=lr, weight_decay=0.0, grad_clip=0.0, warmup=1,
                       total_steps=epochs, master_dtype="")
    batch = {"x": torch.as_tensor(xtr, device=dev),
             "y": torch.as_tensor(ytr, device=dev)}

    def step(params, opt, mask):
        live = _tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = sae.loss_fn(live, batch, cfg, alpha=alpha, act="silu")
        grads = _tree.unflatten_like(
            params, list(torch.autograd.grad(loss, _tree.leaves(live))))
        if mask is not None:
            grads = apply_mask(grads, mask)
        params, opt, _ = adamw.update(grads, opt, params, tcfg)
        if mask is not None:
            params = apply_mask(params, mask)
        return params, opt, loss.detach()

    def train_epochs(params, mask):
        opt = adamw.init(params, tcfg)
        per_step = []
        for _ in range(epochs):
            params, opt, loss = step(params, opt, mask)
            per_step.append(loss)
        if losses is not None:
            losses.append([float(v) for v in torch.stack(per_step).cpu()])
        return params

    return train_epochs


def accuracy(params, cfg, x, y, *, device=None) -> float:
    """Test accuracy % of the latent logits' argmax."""
    dev = _device.resolve(device)
    z, _ = sae.forward(params, torch.as_tensor(x, device=dev), cfg)
    hit = z.argmax(dim=-1) == torch.as_tensor(y, device=dev).long()
    return float(hit.float().mean() * 100)


def _specs(radius) -> Dict[str, dict]:
    return {
        "baseline": dict(spec=None),
        "exact_l1inf": dict(exact_radius=radius),
        "bilevel_l1inf": dict(spec=ProjectionSpec(
            pattern=r"enc1/w", levels=(("inf", 1), (1, 1)), radius=radius,
            transpose=True)),
        "bilevel_l11": dict(spec=ProjectionSpec(
            pattern=r"enc1/w", levels=((1, 1), (1, 1)), radius=100 * radius,
            transpose=True)),
        "bilevel_l12": dict(spec=ProjectionSpec(
            pattern=r"enc1/w", levels=((2, 1), (1, 1)), radius=10 * radius,
            transpose=True)),
    }


def run_dataset(name, x, y, *, radius, epochs=150, lr=3e-3, seed=0,
                prefix="sae", rewind=True, only=None, device=None, init=None,
                record: Optional[dict] = None):
    """5-method sweep on one dataset: rows ``(prefix_name_method, µs,
    derived)``.

    The 80/20 split is numpy's permutation from ``seed`` (the JAX package's
    split); the initial parameters are drawn from ``seed`` on ``device``
    unless ``init`` (a parameter tree on ``device``) is given. ``rewind=False``
    runs the no-rewind ablation; ``only`` restricts the methods. ``record``,
    a dict, receives per method its per-descent losses, the mask the
    projection induced (``None`` for the baseline), the final parameters,
    the accuracy, the column sparsity and the seconds, and for a projected
    method descent 1's ``trained`` and ``projected`` parameters.
    """
    dev = _device.resolve(device)
    cfg = dataclasses.replace(registry.get_arch("sae-paper"), d_model=x.shape[1])
    ntr = int(0.8 * len(x))
    order = np.random.default_rng(seed).permutation(len(x))
    tr, te = order[:ntr], order[ntr:]
    xtr, ytr, xte, yte = x[tr], y[tr], x[te], y[te]
    rows = []
    for mname, kw in _specs(radius).items():
        if only is not None and mname not in only:
            continue
        start = init if init is not None else PM.init_params(
            sae.template(cfg), seed, device=dev)
        losses = []
        fn = train_fn(cfg, xtr, ytr, epochs=epochs, lr=lr, device=dev,
                      losses=losses)
        t0 = time.perf_counter()
        mask = None
        seen = {}   # descent 1's trained and projected parameters
        if mname == "baseline":
            final = fn(start, None)
        else:
            spec = kw.get("spec")

            def projector(p, spec=spec, exact=kw.get("exact_radius")):
                seen["trained"] = p
                seen["projected"] = project_tree(p, spec) if exact is None \
                    else _exact_enc1(p, exact)
                return seen["projected"]

            final, mask, _ = double_descent(start, fn, spec,
                                            projector=projector, rewind=rewind)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        acc = accuracy(final, cfg, xte, yte, device=dev)
        sp = float(sparsity(final["enc1"]["w"], axis=1))
        rows.append((f"{prefix}_{name}_{mname}", dt * 1e6,
                     f"acc={acc:.1f}%_colsparsity={sp:.1f}%"))
        if record is not None:
            record[mname] = {"losses": losses, "mask": mask, "params": final,
                             "accuracy": acc, "colsparsity": sp, "seconds": dt,
                             **seen}
    return rows


def tables(full=False, device=None, record: Optional[dict] = None):
    """Both datasets' sweeps: at ``full`` size the paper's (synthetic 1000 ×
    2000, lung-like 1005 × 2944, 150 epochs a descent), else 400 × 600 at
    80 epochs. ``record`` receives :func:`run_dataset`'s per dataset."""
    out = []
    n = 1000 if full else 400
    m = 2000 if full else 600
    epochs = 150 if full else 80
    x, y, _ = classification_synthetic(n_samples=n, n_features=m,
                                       n_informative=64, class_sep=0.8)
    xl, yl, _ = lung_like() if full else lung_like(n_samples=400,
                                                   n_features=600)
    for name, (xs, ys) in (("synthetic", (x, y)), ("lung_like", (xl, yl))):
        rec = None if record is None else record.setdefault(name, {})
        out += run_dataset(name, xs, ys, radius=1.0, epochs=epochs,
                           device=device, record=rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes (default: 400 x 600, 80 epochs)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for row_name, us, derived in tables(full=args.full, device=args.device):
        print(f"{row_name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
