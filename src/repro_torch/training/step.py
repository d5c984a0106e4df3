"""The training step: microbatch gradient accumulation, per-layer remat
(inside the models), AdamW and the paper's projection (port of
``repro/training/step.py``).

``make_train_step(cfg, tcfg, api, impl=..., ...)`` returns

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
in float32, or in bf16 when ``tcfg.grad_allreduce_dtype == "bfloat16"``,
as in the JAX package.

The optimizer epilogue is the fused one (``optim/fused_step.py``: AdamW
update, multi-level projection and the param/master casts per matched
leaf in one pass) when ``fused`` is True, or ``"auto"`` with the
projection on and no mesh; otherwise it is unfused, as the JAX package's
``fused=False``: AdamW, then the projection hook, then the master copy
resynchronised to the projected params. Either way the step writes the
new values into ``state``'s tensors (JAX donates them) and returns it.

**Under a mesh** (``mesh=`` a ``parallel.mesh.Mesh`` over an initialized
process group, ``param_specs=`` the spec tree of ``models.params.
param_specs``) ``state`` holds this rank's shards (``parallel.sharding.
shard_tree`` under the specs and ``adamw.state_specs``), while
``batch["tokens"]`` is the global batch, the same on every rank: each rank
takes its ``tokens_spec`` slice, runs the sharded forward and backward
(``models/lm.py``), psums the gradients over the batch axes it is not
already summed over (an FSDP leaf's gather psums over "data" in its
backward) in the accumulation dtype and divides by ``dp_shards``; then the
mesh ``global_norm`` clip, ``adamw.update`` and the mesh-native hook
(``make_projection_hook(spec, mesh=, param_specs=)``). A custom
``loss_fn`` under a mesh gets every leaf gathered whole. The loss and
every metric are global and the same on every rank. The epilogue is
unfused there (``fused=True`` with a mesh raises, as in the JAX package).

**In-step telemetry** rides :mod:`repro_torch.obs.bridge`.
``telemetry_every > 0`` reports, every that many steps, ``train_loss``,
``train_grad_norm`` and, when projecting, per projected leaf
``train_param_zero_frac`` and ``train_feasibility_gap`` (the worst
multi-level norm over the leaf's leading axes over the radius, minus 1),
without a sync. The JAX package gates the cadence with a ``lax.cond`` on
the device step; here a host counter does, read once from the state at
the first step that emits and counted on the host after, so off-cadence
steps compute nothing and no step reads the device's counter.
``telemetry_marks=True`` brackets the epilogue with a mark pair:
``train_epilogue_*`` (fused) or ``train_projection_*`` (unfused), device
time in stream order on the card. With the bridge off a step built with
``telemetry_every > 0`` issues exactly the operations of one built with 0.
Under a mesh each projected leaf's statistics are taken on the leaf
gathered whole (every rank gathers; a cadence step only).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from repro_torch import _tree, models
from repro_torch.configs.types import ArchConfig, TrainConfig
from repro_torch.core import multilevel
from repro_torch.models import lm
from repro_torch.models import params as PM
from repro_torch.obs import bridge
from repro_torch.optim import adamw, fused_step
from repro_torch.optim.projection_hook import _matches, make_projection_hook
from repro_torch.parallel import collectives, sharding
from repro_torch.roofline import costs


def xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits (B,S,V) any float dtype; targets (B,S) int. Mean nll in f32:
    logsumexp minus the gathered target logit (no (B,S,V) one-hot)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return (lse - tgt).mean()


def make_loss_fn(cfg: ArchConfig, api, *, impl: str, remat: bool,
                 compute_dtype: torch.dtype, n_groups: int = 1,
                 act_spec=None, logits_spec=None, mesh=None,
                 param_specs=None) -> Callable:
    """``loss_fn(params, tokens)``: the LM on ``tokens[:, :-1]`` with its
    float32/bf16 leaves cast to ``compute_dtype``, next-token :func:`xent`
    against ``tokens[:, 1:]``, plus 0.01 of a non-zero aux term.

    The forward gets the keywords the JAX package gives it: ``impl`` only
    outside the recurrent families (their forwards run their own attention,
    zamba's chunked), ``n_groups`` only for the dense, MoE and VLM
    families, and ``act_spec``.
    With ``mesh``/``param_specs`` the forward is the family's sharded one
    on this rank's shards and batch slice (the hybrid family's then takes
    ``impl`` too: its shared attention runs on the local heads, flash on
    the card), and the loss is this slice's mean; where
    the logits hold a "model" slice of the vocabulary
    (``models.lm.logits_spec``) it is ``collectives.vocab_xent``. The
    logits' layout follows from the parameter specs, so ``logits_spec``
    (JAX's sharding constraint on them) is accepted and has no effect."""
    vocab_tp = mesh is not None and \
        lm.logits_spec(cfg, param_specs, mesh)[-1] == "model"
    kw = {"remat": remat, "act_spec": act_spec}
    if cfg.family not in lm.RECURRENT or (mesh is not None
                                          and cfg.family == "hybrid"):
        kw["impl"] = impl
    if cfg.family in ("dense", "moe", "vlm"):
        kw["n_groups"] = n_groups
    if mesh is not None:
        kw.update(mesh=mesh, param_specs=param_specs)

    def loss_fn(params, tokens):
        cparams = _tree.tree_map(
            lambda p: p.to(compute_dtype)
            if p.dtype in (torch.float32, torch.bfloat16) else p, params)
        logits, aux = api.forward(cparams, tokens[:, :-1], cfg, **kw)
        loss = (collectives.vocab_xent(logits, tokens[:, 1:], mesh) if vocab_tp
                else xent(logits, tokens[:, 1:]))
        if isinstance(aux, torch.Tensor) or aux:
            loss = loss + 0.01 * aux
        return loss

    return loss_fn


def _whole_params_loss(loss_fn: Callable, mesh, param_specs) -> Callable:
    """A custom ``loss_fn`` under a mesh: every leaf gathered whole, its
    gradient psummed over the batch axes and sliced back to the shard."""
    b_axes = sharding.batch_axes(mesh)

    def whole(params, batch):
        full = _tree.tree_map(
            lambda p, sp: collectives.gather_spec(p, sp, mesh, keep=(),
                                                  data_axes=b_axes),
            params, param_specs)
        return loss_fn(full, batch)

    return whole


def make_train_step(cfg: ArchConfig | None, tcfg: TrainConfig, api=None, *,
                    impl: str = "chunked", n_groups: int = 1,
                    act_spec=None, logits_spec=None,
                    mesh=None, param_specs=None,
                    fused: bool | str = "auto",
                    telemetry_every: int = 0,
                    telemetry_marks: bool = False,
                    loss_fn: Callable = None) -> Callable:
    """Build the projected train step (see module docstring).

    ``loss_fn(params, microbatch) -> scalar tensor`` overrides the LM
    next-token loss of ``make_loss_fn(cfg, api, impl=impl, ...)``; the SAE
    factory passes the dictionary reconstruction loss.
    ``telemetry_every``/``telemetry_marks``: the in-step telemetry of the
    module docstring.
    """
    if (mesh is None) != (param_specs is None):
        raise ValueError("a sharded step takes both mesh= and param_specs=")
    if mesh is not None and cfg is not None and tcfg.moment_dtype == "int8":
        # refuse before the first step, not after its forward and backward
        adamw.check_int8_mesh(_tree.tree_map(lambda pd: pd.shape,
                                             models.get(cfg).template(cfg)),
                              param_specs, mesh)
    if isinstance(telemetry_every, bool) or not isinstance(
            telemetry_every, int) or telemetry_every < 0:
        raise ValueError(f"telemetry_every is a cadence in steps, an int >= 0 "
                         f"(0: off), got {telemetry_every!r}")
    compute_dtype = getattr(torch, tcfg.compute_dtype)

    # under a mesh the LM's loss follows each micro-batch's layout: the
    # split of its batch, which an MoE dispatch's groups follow
    @functools.lru_cache(maxsize=None)
    def lm_loss(spec):
        return make_loss_fn(cfg, api, impl=impl, remat=tcfg.remat,
                            compute_dtype=compute_dtype, n_groups=n_groups,
                            act_spec=spec, logits_spec=logits_spec,
                            mesh=mesh, param_specs=param_specs)

    if loss_fn is None and mesh is None:
        loss_fn = lm_loss(act_spec)
    elif loss_fn is not None and mesh is not None:
        loss_fn = _whole_params_loss(loss_fn, mesh, param_specs)
    projecting = tcfg.projection is not None and tcfg.projection.enabled
    if fused == "auto":
        use_fused = projecting and mesh is None
    else:
        use_fused = bool(fused)
        if use_fused and mesh is not None:
            raise ValueError("fused=True is single-device/GSPMD only — the "
                             "mesh-native projection path needs fused='auto' "
                             "or fused=False")
    # the hook is built once: regex, solver and shard-body resolution
    project = None if use_fused else make_projection_hook(
        tcfg.projection, mesh=mesh, param_specs=param_specs)
    acc_dtype = (torch.bfloat16 if tcfg.grad_allreduce_dtype == "bfloat16"
                 else torch.float32)
    emit = _telemetry(tcfg, telemetry_every, mesh, param_specs) \
        if telemetry_every else None
    marks = ("train_epilogue" if use_fused else "train_projection") \
        if telemetry_marks else None
    if mesh is not None:
        b_axes = sharding.batch_axes(mesh)
        dp = sharding.dp_shards(mesh)
        # per leaf: the batch axes its gradient still has to be summed over
        # (an FSDP leaf's gather psums over its own axis in the backward)
        grad_axes = [collectives.live_axes(
            mesh, [a for a in b_axes if a not in sharding.spec_axes(sp)])
            for sp in _tree.leaves(param_specs)]

    def train_step(state, batch):
        params = state["params"]
        tokens = batch["tokens"]              # (n_micro, mb, ...)
        fn = loss_fn
        if mesh is not None:  # each micro-batch's slice, taken in its turn
            mb_spec = sharding.tokens_spec(mesh, None, tokens.shape[1])[1:]
            fn = loss_fn or lm_loss((mb_spec[0], None, None))
        n_micro = tokens.shape[0]
        leaves = _tree.leaves(params)
        # one micro-batch: its gradients are the accumulator (no zero-filled
        # copy of the tree beside them); more, or a cost walk (which walks a
        # step's first micro-batch for all of them): each adds into zeros
        gsum = None if n_micro == 1 and costs.active() is None else [
            torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb in tokens:
            # one micro-batch: a cost walk multiplies it (roofline/costs.py)
            with costs.section("micro_batch"):
                if mesh is not None:
                    mb = sharding.shard(mb, mb_spec, mesh)
                live = [p.detach().requires_grad_(True) for p in leaves]
                loss = fn(_tree.unflatten_like(params, live), mb)
                grads = torch.autograd.grad(loss, live, allow_unused=True)
                if gsum is None:
                    gsum = _accumulator(leaves, grads, acc_dtype)
                else:
                    for a, g in zip(gsum, grads):
                        if g is not None:
                            a.add_(g.to(acc_dtype))
                lsum += loss.detach().float()
                del loss, grads, live  # free this microbatch's graph and grads
        scale = n_micro
        if mesh is not None:
            gsum = [collectives.psum(a, mesh, axes)
                    for a, axes in zip(gsum, grad_axes)]
            lsum = collectives.psum(lsum, mesh, b_axes) / dp
            scale *= dp
        # the mean in place: the accumulator is the gradient tree, so a full
        # copy of it never coexists with it
        for a in gsum:
            a.div_(scale)
        grads = _tree.unflatten_like(params, gsum)
        loss = lsum / n_micro

        dev = leaves[0].device
        if use_fused:
            # one pass per leaf: update → project (f32) → cast, in place
            if marks:
                bridge.mark(f"{marks}_start", device=dev)
            new_params, new_opt, metrics = fused_step.fused_update(
                grads, state["opt"], params, tcfg)
            if marks:
                bridge.mark(f"{marks}_end", device=dev)
        else:
            new_params, new_opt, metrics = adamw.update(
                grads, state["opt"], params, tcfg, mesh=mesh,
                param_specs=param_specs, inplace=True)
            # the paper's constraint: project back onto the norm ball
            if marks:
                bridge.mark(f"{marks}_start", device=dev)
            projected = project(new_params, new_opt["step"])
            for p, x in zip(_tree.leaves(new_params), _tree.leaves(projected)):
                if x is not p:
                    p.copy_(x)
            if marks:
                bridge.mark(f"{marks}_end", device=dev)
            # keep the master copy consistent with the projected params
            if "master" in new_opt and projecting:
                for p, m in zip(_tree.leaves(new_params),
                                _tree.leaves(new_opt["master"])):
                    m.copy_(p)
        metrics = dict(metrics, loss=loss)
        if emit is not None:
            emit(new_opt, new_params, metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _accumulator(leaves, grads, acc_dtype):
    """The gradient accumulator of a step of one micro-batch, made of its
    gradients (0 + g is g): a leaf's own tensor where it is contiguous and
    shares its storage with no other (a ``meta`` tensor has none), else a
    copy; zeros for a leaf without a gradient."""
    out, seen = [], set()
    for p, g in zip(leaves, grads):
        if g is None:
            out.append(torch.zeros(p.shape, dtype=acc_dtype, device=p.device))
            continue
        a = g.to(acc_dtype)
        ptr = None if a.is_meta else a.untyped_storage().data_ptr()
        if ptr in seen or not a.is_contiguous():
            a = a.clone(memory_format=torch.contiguous_format)
        if not a.is_meta:
            seen.add(a.untyped_storage().data_ptr())
        out.append(a)
    return out


def _telemetry(tcfg: TrainConfig, every: int, mesh, param_specs) -> Callable:
    """``emit(opt, params, metrics)``, called after every step: on every
    ``every``-th step, with the bridge on, report the loss, the gradient
    norm and each projected leaf's zero fraction and feasibility gap. The
    step number is read from ``opt`` at the first step that emits and
    counted on the host after (module docstring)."""
    spec = tcfg.projection
    projecting = spec is not None and spec.enabled
    match = _matches(spec) if projecting else None
    need = sum(k for _, k in spec.levels) if projecting else 0
    specs = (dict(_tree.leaves_with_paths(param_specs))
             if mesh is not None else None)
    clock = [None]   # the host's count of the state's step

    def leaf_stats(w):
        x = w.float()
        if spec.transpose:
            lead = tuple(range(x.ndim - need))
            x = x.permute(lead + tuple(reversed(range(x.ndim - need, x.ndim))))
        fn = lambda v: multilevel.multilevel_norm(v, list(spec.levels))  # noqa: E731
        for _ in range(x.ndim - need):
            fn = torch.func.vmap(fn)
        worst = fn(x).max()
        return (w == 0).float().mean(), worst / spec.radius - 1.0

    def emit(opt, params, metrics):
        if clock[0] is not None:
            clock[0] += 1
        elif bridge.enabled():
            clock[0] = int(opt["step"])     # the one read of the device step
        if not bridge.enabled() or clock[0] % every:
            return
        bridge.report("train_loss", metrics["loss"])
        bridge.report("train_grad_norm", metrics["grad_norm"])
        if not projecting:
            return
        with torch.no_grad():
            for name, w in _tree.leaves_with_paths(params):
                if not match(name, w) or not w.numel():
                    continue
                if specs is not None:
                    w = collectives.gather_full(w, specs[name], mesh)
                zero_frac, gap = leaf_stats(w)
                bridge.report("train_param_zero_frac", zero_frac,
                              labels={"leaf": name})
                bridge.report("train_feasibility_gap", gap,
                              labels={"leaf": name})

    return emit


def _hook_collectives(spec, param_specs, shapes, mesh_sizes,
                      itemsize: int = 4) -> dict:
    """Per op, the mesh-native hook's collectives on one step: each matched
    leaf whose projected axes are sharded runs ``sharded_collective_bytes``'
    schedule (a reduce's pmax or psum, the solve's all-gather, an ℓ1
    apply's bisection psums) on values of ``itemsize`` bytes (the
    parameters', which the hook projects)."""
    import types

    from repro_torch.core.schedule import sharded_collective_bytes
    from repro_torch.optim.projection_hook import _matches

    calls = {"psum": 0, "pmax": 0, "all_gather": 0}
    nbytes = dict.fromkeys(calls, 0)
    if spec is None or not spec.enabled:
        return {"calls": calls, "bytes": nbytes}
    match = _matches(spec)
    need = sum(k for _, k in spec.levels)
    for (name, sp), shape in zip(_tree.leaves_with_paths(param_specs),
                                 _tree.leaves(shapes)):
        if not match(name, types.SimpleNamespace(ndim=len(shape))) \
                or not math.prod(shape):
            continue
        batch = len(shape) - need
        names = tuple(sp) + (None,) * (len(shape) - len(sp))
        # the hook's rule: the mesh executor where a projected axis is sharded
        if not any(names[batch:]) or math.prod(mesh_sizes.values()) <= 1:
            continue
        perm = tuple(range(len(shape)))
        if spec.transpose:
            perm = perm[:batch] + perm[batch:][::-1]
        model = sharded_collective_bytes([shape[a] for a in perm], spec.levels,
                                         [names[a] for a in perm], mesh_sizes,
                                         itemsize, batch_dims=batch)
        for st in model["per_step"]:
            kind, norm = st["step"].split("_")
            op = ("all_gather" if kind == "solve" else
                  "pmax" if kind == "reduce" and norm == "inf" else "psum")
            calls[op] += st["calls"]
            nbytes[op] += st["bytes"]
    return {"calls": calls, "bytes": nbytes}


def step_collectives(cfg: ArchConfig, tcfg: TrainConfig, param_specs, mesh,
                     tokens_shape) -> dict:
    """The collectives one sharded LM step makes on each rank, per op
    (``{"calls": {op: n}, "bytes": {op: n}}``, the ops of ``Mesh.counts()``),
    for a global batch of ``tokens_shape`` (n_micro, mb, seq + 1): each
    micro-batch's forward and backward (``models.lm.sharded_collectives``
    on this rank's slice), one psum per leaf whose gradient still spans a
    batch axis, one for the loss, one per group of the mesh ``global_norm``,
    and the projection hook's schedules (``sharded_collective_bytes``)."""
    shp = sharding.mesh_shape_dict(mesh)
    live = {a for a, n in shp.items() if n > 1}
    n_micro, mb, s1 = tokens_shape
    entry = sharding.tokens_spec(shp, None, mb)[1]
    names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
    local_mb = mb // max(1, math.prod(shp[a] for a in names))
    itemsize = torch.empty((), dtype=getattr(torch, tcfg.compute_dtype)).element_size()
    acc = 2 if tcfg.grad_allreduce_dtype == "bfloat16" else 4
    fb = lm.sharded_collectives(cfg, param_specs, shp, local_mb, s1 - 1,
                                remat=tcfg.remat, itemsize=itemsize)
    calls = {op: n * n_micro for op, n in fb["calls"].items()}
    nbytes = {op: n * n_micro for op, n in fb["bytes"].items()}
    b_axes = sharding.batch_axes(shp)
    tpl = models.get(cfg).template(cfg)
    shapes = _tree.tree_map(lambda pd: pd.shape, tpl)
    groups = set()
    for sp, shape in zip(_tree.leaves(param_specs), _tree.leaves(shapes)):
        local = [d // sharding.entry_size(n, shp) for d, n in zip(shape, sp)]
        if live & (set(b_axes) - set(sharding.spec_axes(sp))):
            calls["psum"] += 1
            nbytes["psum"] += math.prod(local) * acc
        groups.add(tuple(sorted(live & set(sharding.spec_axes(sp)))))
    steps = int(bool(live & set(b_axes))) + len(groups - {()})
    calls["psum"] += steps
    nbytes["psum"] += 4 * steps
    p_size = torch.empty((), dtype=getattr(torch, tcfg.param_dtype)).element_size()
    hook = _hook_collectives(tcfg.projection, param_specs, shapes, shp, p_size)
    for op in calls:
        calls[op] += hook["calls"][op]
        nbytes[op] += hook["bytes"][op]
    return {"calls": calls, "bytes": nbytes}


def init_state(cfg: ArchConfig, tcfg: TrainConfig, api, seed: int, *,
               device=None, mesh=None, param_specs=None):
    """``{"params", "opt"}``: the template initialised from ``seed`` in
    ``tcfg.param_dtype`` on ``device`` (the card by default), and AdamW's
    state. With ``mesh``/``param_specs``: this rank's shards of that same
    state (each leaf drawn whole, then cut)."""
    shard = None
    if mesh is not None:
        specs = dict(_tree.leaves_with_paths(param_specs))
        shard = lambda path, x: sharding.shard(x, specs[path], mesh)  # noqa: E731
    params = PM.init_params(api.template(cfg), seed,
                            getattr(torch, tcfg.param_dtype), device=device,
                            shard=shard)
    return {"params": params, "opt": adamw.init(params, tcfg)}
