"""Sparse-SAE training factory — the paper's application, end to end (port of
``repro/training/sae_factory.py``).

1. **Harvest** (``data/activations.py``): run a configured LM from
   ``configs/`` — dense, or MoE with MLA attention — over the
   deterministic token stream and shard per-layer residual/MLP activations
   to disk. The port harvests with ``impl="flash"`` by default, so on the
   card every layer's attention runs the hand-written flash kernel
   (``csrc/flash_fwd.cu``); the JAX factory harvests with ``harvest``'s
   default ``impl="naive"``, the same function. MLA's q/k and v heads
   differ in width, which the flash kernels do not take, so an MLA model
   harvests with ``impl="chunked"`` (or ``"naive"``) and raises with
   ``"flash"``.
2. **Projected SAE training**: stream the shards back through
   ``DataPipeline`` into ``make_train_step`` with the
   dictionary SAE (``models/sae.py``) — the encoder weight is projected onto
   the bi-/tri-level ball every optimizer step by the fused AdamW+project
   epilogue (the plain schedule executor, as in the JAX step). Learned
   dictionaries are compared across seeds with MMCS (``training/mmcs.py``).

3. **GSP whole-network sparsification** (:func:`gsp_whole_network`): every
   weight of the LM projected per step; with a mesh, the sharded train
   step, whose sharded leaves project in place through the mesh executor.

``run_factory(lm_params=...)`` harvests from given LM weights, e.g. a
``runtime/checkpoint`` state (the CLI's ``--checkpoint``).
Everything here is deterministic given (arch, seeds): the data cursor is the
step index, inits are seeded ``torch.Generator``s.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import torch

from repro_torch import _device, _tree, models
from repro_torch.configs import registry
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.core.multilevel import multilevel_norm
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.data.activations import (HarvestConfig, check_family, harvest,
                                         read_meta)
from repro_torch.models import lm, params as PM, sae
from repro_torch.optim import adamw
from repro_torch.optim.projection_hook import matched_names, tree_sparsity
from repro_torch.parallel import collectives, sharding as SH
from repro_torch.training import step as TS
from repro_torch.training.mmcs import mmcs_sym


# ------------------------------------------------------------------ stage 1/2
@dataclasses.dataclass(frozen=True)
class SAEFactoryConfig:
    """One factory run: which model, what to harvest, how to train the SAE."""
    arch: str = "stablelm-1.6b"
    smoke: bool = True               # reduced arch (CPU tests); False = full
    site: str = "resid"              # harvest site
    layers: Optional[Sequence[int]] = None   # None -> all layers
    harvest_steps: int = 4           # shards per layer
    seq_len: int = 16
    lm_batch: int = 4                # sequences per harvest step
    expansion: int = 4               # d_dict = expansion * d_model
    train_steps: int = 40
    sae_batch: int = 64              # rows per SAE optimizer step
    microbatch: int = 32
    lr: float = 1e-2
    radius: float = 1.0
    levels: tuple = (("inf", 1), (1, 1))     # bi-level l1,inf by default
    heads: int = 1                   # >1: head-structured dictionary (§6) —
                                     # 3-D encoder + tri-level projection
    method: str = "bisect"
    seed: int = 0
    depth: int = 0                   # >0: the LM cut to its first `depth`
                                     # layers at full width (models.lm.cut_depth)


def effective_levels(fcfg: SAEFactoryConfig) -> tuple:
    """The norm design actually projected: a head-structured factory
    (``heads > 1``) upgrades the default bi-level design to the paper's §6
    tri-level ℓ1,∞,∞ (one ∞ level per head axis of the 3-D encoder); an
    explicit 3-axis ``fcfg.levels`` wins."""
    if fcfg.heads == 1 or sum(k for _, k in fcfg.levels) != 2:
        return tuple(fcfg.levels)
    return (("inf", 1),) + tuple(fcfg.levels)


def _arch(fcfg: SAEFactoryConfig):
    cfg = (registry.smoke_config(fcfg.arch) if fcfg.smoke
           else registry.get_arch(fcfg.arch))
    return lm.cut_depth(cfg, fcfg.depth) if fcfg.depth else cfg


def lm_for(fcfg: SAEFactoryConfig, *, device=None):
    """(cfg, api, params) for the harvest model, seeded by ``fcfg.seed``, on
    ``device`` (the card by default)."""
    cfg = _arch(fcfg)
    api = models.get(cfg)
    params = PM.init_params(api.template(cfg), fcfg.seed, device=device)
    return cfg, api, params


def harvest_activations(fcfg: SAEFactoryConfig, out_dir, params=None, *,
                        device=None, impl: str = "flash") -> dict:
    """Stage 1: run the LM through the ``impl`` attention path (the flash
    kernels by default) and shard activations. ``params`` (e.g. carried
    over from the JAX package) harvest in place of the seeded init, on
    their own device. Returns the manifest. A recurrent or audio family is
    refused before its weights are drawn (``data.activations.check_family``)."""
    check_family(_arch(fcfg))
    if params is None:
        cfg, api, params = lm_for(fcfg, device=device)
    else:
        cfg = _arch(fcfg)
        api = models.get(cfg)
    pipe = DataPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=fcfg.seq_len, global_batch=fcfg.lm_batch,
        microbatch=fcfg.lm_batch, seed=fcfg.seed))
    hcfg = HarvestConfig(site=fcfg.site, layers=fcfg.layers,
                         n_steps=fcfg.harvest_steps)
    return harvest(params, cfg, pipe, out_dir, hcfg=hcfg, forward=api.forward,
                   impl=impl)


def sae_projection_spec(fcfg: SAEFactoryConfig) -> ProjectionSpec:
    """The per-step constraint: encoder columns (features) live on the ball.

    ``transpose=True`` groups by dictionary feature (paper §7.3). With
    ``heads > 1`` the encoder is 3-D and the transposed view is
    (d_per_head, heads, d_in): the tri-level design aggregates ∞ over the
    per-head slots, ∞ over heads, then solves ℓ1 over d_in.
    """
    return ProjectionSpec(pattern=r"enc/w", levels=effective_levels(fcfg),
                          radius=fcfg.radius, every=1, method=fcfg.method,
                          transpose=True)


def sae_train_config(fcfg: SAEFactoryConfig) -> TrainConfig:
    return TrainConfig(
        microbatch=fcfg.microbatch, lr=fcfg.lr, weight_decay=0.0,
        grad_clip=1.0, warmup=2, total_steps=max(fcfg.train_steps, 2),
        master_dtype="", compute_dtype="float32", remat=False,
        projection=sae_projection_spec(fcfg), seed=fcfg.seed)


def init_sae_state(d_in: int, d_dict: int, tcfg: TrainConfig, seed: int, *,
                   heads: int = 1, device=None, params=None):
    """``{"params", "opt"}`` of a fresh SAE: the seeded init on ``device``,
    or ``params`` (a tree like ``sae.dict_template``'s) when given."""
    if params is None:
        params = PM.init_params(sae.dict_template(d_in, d_dict, heads=heads),
                                seed, getattr(torch, tcfg.param_dtype),
                                device=device)
    return {"params": params, "opt": adamw.init(params, tcfg)}


def make_sae_train_step(tcfg: TrainConfig, *, l1: float = 0.0,
                        fused="auto", mesh=None, param_specs=None):
    """The projected dictionary-SAE step: ``make_train_step`` with the
    reconstruction loss (plus ``l1`` times the features' mean magnitude) —
    the fused AdamW+project epilogue on the single-device path, the
    mesh-native in-place projection when ``mesh``/``param_specs`` are
    given."""
    return TS.make_train_step(
        None, tcfg, None, fused=fused, mesh=mesh, param_specs=param_specs,
        loss_fn=lambda p, xb: sae.dict_loss(p, xb.float(), l1=l1))


def train_sae(harvest_dir, layer: int, fcfg: SAEFactoryConfig, *,
              seed: Optional[int] = None, device=None, params=None) -> dict:
    """Stage 2 for one layer: stream shards into projected SAE training on
    ``device`` (the card by default).

    Returns ``{"params", "metrics", "losses", "dictionary", "sparsity"}``:
    ``losses`` is the loss of every step, ``dictionary`` the decoder weight
    as a (d_model, d_dict) tensor ready for ``mmcs``. ``params`` starts
    training from given SAE parameters instead of the seeded init.
    """
    dev = _device.resolve(device)
    meta = read_meta(harvest_dir)
    d_in = meta["d_model"]
    d_dict = fcfg.expansion * d_in
    seed = fcfg.seed if seed is None else seed
    tcfg = sae_train_config(fcfg)
    pipe = DataPipeline(DataConfig(
        vocab=1, seq_len=0, global_batch=fcfg.sae_batch,
        microbatch=fcfg.microbatch, activation_dir=str(harvest_dir),
        activation_layer=layer))
    state = init_sae_state(d_in, d_dict, tcfg, seed, heads=fcfg.heads,
                           device=dev, params=params)
    step = make_sae_train_step(tcfg)
    losses = []
    for i in range(fcfg.train_steps):
        state, m = step(state, {"tokens": torch.from_numpy(pipe.batch(i)).to(dev)})
        losses.append(m["loss"])
    last = {k: float(v) for k, v in m.items()}
    params = state["params"]
    eval_rows = torch.from_numpy(pipe.batch(0)).to(dev).reshape(-1, d_in).float()
    with torch.no_grad():
        diag = {k: float(v) for k, v in sae.dict_metrics(params, eval_rows).items()}
    spec = sae_projection_spec(fcfg)
    return {
        "params": params,
        "metrics": dict(last, **diag),
        "losses": [float(x) for x in losses],
        # head-structured dec/w is (heads, d_dict//heads, d_in): flatten the
        # head axes back to d_dict before the (d_model, d_dict) orientation
        "dictionary": params["dec"]["w"].reshape(-1, d_in).T,
        "sparsity": {k: float(v)
                     for k, v in tree_sparsity(params, spec).items()},
    }


def run_factory(fcfg: SAEFactoryConfig, workdir, *, seeds=(0, 1),
                lm_params=None, device=None, impl: str = "flash") -> dict:
    """Harvest once (attention ``impl``), train one SAE per (layer, seed),
    cross-compare with MMCS.

    Each layer's record holds the per-seed ``metrics``, ``sparsity``, the
    per-step ``losses`` and the encoder's ``constraint`` report, and the
    cross-seed ``mmcs``. ``lm_params`` harvests from given LM weights instead
    of the seeded init; the factory drops its reference to them before the
    SAE steps, so they are freed there unless the caller keeps one."""
    meta = harvest_activations(fcfg, workdir, params=lm_params, device=device,
                               impl=impl)
    lm_params = None
    spec = sae_projection_spec(fcfg)
    out = {"meta": meta, "layers": {}}
    for layer in meta["layers"]:
        runs = {s: train_sae(workdir, layer, fcfg, seed=s, device=device)
                for s in seeds}
        pairs = {}
        slist = list(seeds)
        for i, a in enumerate(slist):
            for b in slist[i + 1:]:
                pairs[f"seed{a}_vs_seed{b}"] = float(mmcs_sym(
                    runs[a]["dictionary"], runs[b]["dictionary"]))
        out["layers"][layer] = {
            "mmcs": pairs,
            "metrics": {s: runs[s]["metrics"] for s in seeds},
            "sparsity": {s: runs[s]["sparsity"] for s in seeds},
            "losses": {s: runs[s]["losses"] for s in seeds},
            "constraint": {s: constraint_report(runs[s]["params"], spec)
                           for s in seeds},
        }
    return out


def constraint_report(params, spec: ProjectionSpec) -> dict:
    """Max multilevel-norm violation over matched leaves (0 == feasible).

    Leading (stacked) axes are enumerated one slice at a time, so a single
    infeasible layer of a stack cannot hide in an aggregate.
    """
    pat = re.compile(spec.pattern)
    need = sum(k for _, k in spec.levels)
    levels = list(spec.levels)
    report = {}
    for name, w in _tree.leaves_with_paths(params):
        if not (hasattr(w, "ndim") and w.ndim >= need and pat.search(name)):
            continue
        w = torch.as_tensor(w).float()
        lead = w.ndim - need
        if spec.transpose:
            w = w.permute(tuple(range(lead)) + tuple(reversed(range(lead, w.ndim))))
        items = w.reshape((-1,) + tuple(w.shape[lead:]))
        report[name] = max(float(multilevel_norm(x, levels)) for x in items)
    viol = max((v - spec.radius for v in report.values()), default=0.0)
    return {"norms": report, "max_violation": max(viol, 0.0),
            "feasible": viol <= spec.radius * 1e-3 + 1e-5}


# ------------------------------------------------------------------- stage 3
def gsp_whole_network(arch: str = "stablelm-1.6b", *, mesh=None,
                      steps: int = 2, radius: float = 3.0,
                      pattern: str = r".*", microbatch: int = 2,
                      seq_len: int = 17, seed: int = 0, device=None) -> dict:
    """GSP-style whole-network sparsification: project EVERY weight per step.

    ``pattern=r".*"`` matches every >=2-D parameter of the LM's smoke config
    — embeddings, attention projections (trailing (heads, head_dim) axes:
    the paper's §6 head-structured sparsity), MLP weights and the stacked
    norm scales alike — under the bi-level ball of ``radius`` (θ by
    bisection), after ``steps`` steps of the LM (``impl="naive"``, bf16
    compute: the JAX package's settings). With ``mesh`` (a
    ``parallel.mesh.Mesh``) the state is sharded by ``param_specs(...,
    param_rules(mesh, fsdp=True))`` and ``adamw.state_specs``, and the step
    is the sharded one: leaves whose trailing axes are sharded project in
    place through the mesh executor (no gather), the rest on each rank's own
    copy. Returns the JAX package's dict (per-leaf column sparsity,
    feasibility, the last loss), the same on every rank."""
    return _gsp(arch, mesh=mesh, steps=steps, radius=radius, pattern=pattern,
                microbatch=microbatch, seq_len=seq_len, seed=seed,
                device=device)


def _gsp(arch: str = "stablelm-1.6b", *, mesh=None, steps: int = 2,
         radius: float = 3.0, pattern: str = r".*", microbatch: int = 2,
         seq_len: int = 17, seed: int = 0, device=None, params=None,
         compute_dtype: str = "bfloat16") -> dict:
    """:func:`gsp_whole_network` with two options that only the checks
    set (tests and ``chip_smoke.py``): ``params`` starts from given (full) LM parameters instead of the
    seeded init (the JAX package's, to hold the port against it), and
    ``compute_dtype`` replaces the step's bf16 (float32 makes a sharded run
    agree with an unsharded one to float32 rounding)."""
    dev = _device.resolve(device)
    cfg = registry.smoke_config(arch)
    api = models.get(cfg)
    proj = ProjectionSpec(pattern=pattern, radius=radius, every=1,
                          method="bisect")
    tcfg = TrainConfig(microbatch=microbatch, lr=1e-3, warmup=2,
                       total_steps=max(steps, 2), master_dtype="",
                       remat=False, projection=proj, seed=seed,
                       compute_dtype=compute_dtype)
    pspecs = None
    if mesh is not None:
        tpl = api.template(cfg)
        pspecs = PM.param_specs(tpl, SH.param_rules(mesh, fsdp=True),
                                SH.mesh_shape_dict(mesh))
    if params is None:
        state = TS.init_state(cfg, tcfg, api, seed, device=dev, mesh=mesh,
                              param_specs=pspecs)
    else:
        params = _tree.tree_map(lambda x: x.to(dev), params)
        if mesh is not None:
            params = SH.shard_tree(params, pspecs, mesh)
        state = {"params": params, "opt": adamw.init(params, tcfg)}
    step = TS.make_train_step(cfg, tcfg, api, impl="naive", mesh=mesh,
                              param_specs=pspecs)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                   global_batch=2 * microbatch,
                                   microbatch=microbatch, seed=seed))
    for i in range(steps):
        state, metrics = step(state, {"tokens": torch.from_numpy(
            pipe.batch(i)).to(dev)})
    params = state["params"]
    if mesh is not None:
        params = _tree.tree_map(lambda x, sp: collectives.gather_full(x, sp, mesh),
                                params, pspecs)
    names = matched_names(params, proj)
    rep = constraint_report(params, proj)
    sp = tree_sparsity(params, proj)
    return {
        "n_projected": len(names),
        "n_devices": mesh.size if mesh is not None else 1,
        "feasible": rep["feasible"],
        "max_violation": rep["max_violation"],
        "mean_col_sparsity": float(sum(float(v) for v in sp.values()) / len(sp)),
        "per_leaf_sparsity": {k: float(v) for k, v in sp.items()},
        "loss": float(metrics["loss"]),
    }
