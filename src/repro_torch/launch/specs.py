"""Everything the dry run needs per (arch × shape × mesh) cell: the tuning,
the abstract state, the specs and the step function (port of
``repro/launch/specs.py``).

The JAX package hands its dry run ``ShapeDtypeStruct`` stand-ins to lower
and compile for 256 or 512 devices. The port follows one rank instead: a
cell is a dict with the step function (``fn``), its arguments (``args``) as
``meta`` tensors — nothing is allocated on any device —, the specs and the
mesh (a ``parallel.mesh.AbstractMesh``), which ``launch/dryrun.py`` walks
with ``roofline/costs.py``.

* **train** — ``training.step.make_train_step`` under the abstract mesh:
  the state is this rank's shard of every leaf (``sharding.local_shape``
  under ``state_shardings``' specs) and ``batch["tokens"]`` the global
  batch, of which the step takes its ``tokens_spec`` slice, as on a live
  mesh. Its collectives are the abstract mesh's counts.
* **decode / prefill** — the port has no sharded serving step: it serves
  on one device (``serving/lm.py``). The cell's arguments are therefore
  the *global* ones (the whole batch and cache, bf16 parameters) for the
  single-device step, and the dry run divides that step's FLOPs, bytes and
  peak by the chips; the argument bytes per device come from the specs'
  local shapes (``param_specs``, ``cache_spec_tree``); the collective
  term is not modelled (None, with the reason in the record). A sharded
  serving step is queued (ROADMAP.md § 2(b)).
* Every family walks its sharded forward: the dense and MoE families
  ``models/lm.py``'s (the MoE archs' experts and MLA heads over "model",
  their 'embed' over ("pod", "data") on the multi-pod mesh), the audio,
  hybrid and recurrent families their own.

The decode and prefill cells take ``serving.lm.make_decode_step`` and
``make_prefill``; the JAX module calls them through ``serving.engine``,
which has neither (ROADMAP.md § 3, reference item 8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch import _tree, models
from repro_torch.configs.types import ArchConfig, ProjectionSpec, ShapeConfig, TrainConfig
from repro_torch.models import params as PM
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.training import step as TS

_BLOCK = 256   # the int8 moments' block (optim/adamw.py)


# --------------------------------------------------- per-arch training tuning
@dataclasses.dataclass(frozen=True)
class Tuning:
    param_dtype: str = "bfloat16"
    master_dtype: str = "float32"
    moment_dtype: str = "float32"
    grad_allreduce_dtype: str = ""
    microbatch: int = 32          # global microbatch size for train_4k
    fsdp: bool = True
    attn_impl: str = "chunked"
    projection_pattern: str = r"(w_up|w_gate)"
    # ---- hillclimb knobs ----
    ep_2d: bool = False           # experts sharded over (data, model)
    moe_dispatch: str = ""        # "" -> cfg default; "scatter": no one-hot
    attn_chunk: int = 0           # 0 -> default 1024
    attn_probs_bf16: bool = False  # softmax probs rounded to bf16 (f32 accum)
    xlstm_chunk: int = 0          # mLSTM chunk length
    xlstm_shard_r: bool = False   # TP-shard sLSTM recurrent weights


TUNINGS: Dict[str, Tuning] = {
    # the trillion-scale MoEs: no fp32 master, int8 moments, bf16 grad accum
    "deepseek-v3-671b": Tuning(master_dtype="", moment_dtype="int8",
                               grad_allreduce_dtype="bfloat16", microbatch=16),
    "kimi-k2-1t-a32b": Tuning(master_dtype="", moment_dtype="int8",
                              grad_allreduce_dtype="bfloat16", microbatch=16),
    "qwen3-32b": Tuning(microbatch=16),
    "chameleon-34b": Tuning(microbatch=16),
}


def tuning_for(cfg: ArchConfig) -> Tuning:
    return TUNINGS.get(cfg.name, Tuning())


def apply_tuning(cfg: ArchConfig, tune: Tuning) -> ArchConfig:
    """Fold the hillclimb knobs into the arch config and
    ``models.layers.ATTN_TUNE`` (a module-wide setting, as in the JAX
    package: it holds until the next call)."""
    from repro_torch.models import layers as L

    L.ATTN_TUNE["chunk"] = tune.attn_chunk or 1024
    L.ATTN_TUNE["probs_dtype"] = torch.bfloat16 if tune.attn_probs_bf16 else None
    if tune.moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=tune.moe_dispatch))
    if cfg.xlstm is not None and (tune.xlstm_chunk or tune.xlstm_shard_r):
        cfg = dataclasses.replace(
            cfg, xlstm=dataclasses.replace(
                cfg.xlstm, chunk=tune.xlstm_chunk or cfg.xlstm.chunk,
                shard_r=tune.xlstm_shard_r or cfg.xlstm.shard_r))
    return cfg


def reset_attn_tune() -> None:
    """``models.layers.ATTN_TUNE`` back to its defaults."""
    from repro_torch.models import layers as L

    L.ATTN_TUNE.update(chunk=1024, probs_dtype=None)


def train_config(cfg: ArchConfig, shape: ShapeConfig, tune: Tuning) -> TrainConfig:
    return TrainConfig(
        microbatch=tune.microbatch,
        param_dtype=tune.param_dtype,
        master_dtype=tune.master_dtype,
        moment_dtype=tune.moment_dtype,
        grad_allreduce_dtype=tune.grad_allreduce_dtype,
        remat=True,
        projection=ProjectionSpec(pattern=tune.projection_pattern,
                                  radius=100.0, every=1),
    )


# ------------------------------------------------------------ abstract state
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig, api, *,
                         shape=None):
    """``training.step.init_state``'s tree as ``meta`` tensors (no
    allocation): every leaf's shape, or ``shape(path, pd)`` (a rank's local
    shard shape); an int8 moment is ``{"q": int8 (..., n padded to 256),
    "s": float32 (..., n_blocks)}`` of its parameter's shape."""
    tpl = api.template(cfg)
    params = PM.abstract_params(tpl, getattr(torch, tcfg.param_dtype),
                                shape=shape)

    def mom(p):
        if tcfg.moment_dtype == "int8":
            npad = -(-p.shape[-1] // _BLOCK) * _BLOCK
            return {"q": _meta(p.shape[:-1] + (npad,), torch.int8),
                    "s": _meta(p.shape[:-1] + (npad // _BLOCK,), torch.float32)}
        return _meta(p.shape, getattr(torch, tcfg.moment_dtype))

    opt = {"step": _meta((), torch.int32),
           "m": _tree.tree_map(mom, params),
           "v": _tree.tree_map(mom, params)}
    if tcfg.master_dtype and tcfg.master_dtype != tcfg.param_dtype:
        mdt = getattr(torch, tcfg.master_dtype)
        opt["master"] = _tree.tree_map(lambda p: _meta(p.shape, mdt), params)
    return {"params": params, "opt": opt}


def state_shardings(cfg: ArchConfig, tcfg: TrainConfig, api, mesh, *,
                    fsdp: bool = True, ep_2d: bool = False):
    """``{"params": specs, "opt": specs}`` of the train state on ``mesh``
    (JAX's second return value; the port has no ``NamedSharding``)."""
    tpl = api.template(cfg)
    rules = SH.param_rules(mesh, fsdp=fsdp)
    shp = SH.mesh_shape_dict(mesh)
    if "pod" in shp and cfg.name.startswith(("kimi", "deepseek")):
        rules = dict(rules, embed=("pod", "data"))  # cross-pod ZeRO for the giants
    if ep_2d:
        rules = dict(rules, experts=("data", "model"))
    pspecs = PM.param_specs(tpl, rules, shp)
    return {"params": pspecs, "opt": adamw.state_specs(pspecs, tpl, tcfg)}


def _local(specs, mesh):
    """``shape(path, pd)``: the leaf's local shard shape under ``specs``."""
    table = dict(_tree.leaves_with_paths(specs))
    return lambda path, pd: SH.local_shape(pd.shape, table[path], mesh)


def local_bytes(tree, specs, mesh) -> int:
    """Bytes of one rank's shards of ``tree`` (tensors of global shapes)
    under a spec tree of its structure."""
    total = 0
    for (path, t), sp in zip(_tree.leaves_with_paths(tree), _tree.leaves(specs)):
        total += math.prod(SH.local_shape(t.shape, sp, mesh)) * t.element_size()
    return total


# ------------------------------------------------------------------ the cells
def train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, tune=None):
    """The sharded train step of one rank (module docstring)."""
    tune = tune or tuning_for(cfg)
    cfg = apply_tuning(cfg, tune)
    tcfg = train_config(cfg, shape, tune)
    api = models.get(cfg)
    n_micro = shape.global_batch // tcfg.microbatch
    n_groups = SH.dp_shards(mesh)
    b_ax = SH.tokens_spec(mesh, shape, tcfg.microbatch)[1]
    act_spec = (b_ax, None, None)
    v_ok = cfg.vocab % SH.mesh_shape_dict(mesh)["model"] == 0
    logits_spec = (b_ax, None, "model" if v_ok else None)
    specs = state_shardings(cfg, tcfg, api, mesh, fsdp=tune.fsdp,
                            ep_2d=tune.ep_2d)
    state = abstract_train_state(cfg, tcfg, api,
                                 shape=_local(specs["params"], mesh))
    tokens = _meta((n_micro, tcfg.microbatch, shape.seq_len + 1), torch.int32)
    step_fn = TS.make_train_step(cfg, tcfg, api, impl=tune.attn_impl,
                                 n_groups=n_groups, act_spec=act_spec,
                                 logits_spec=logits_spec, mesh=mesh,
                                 param_specs=specs["params"])
    tok_spec = SH.tokens_spec(mesh, shape, tcfg.microbatch)
    arg_bytes = sum(t.numel() * t.element_size() for t in _tree.leaves(state)) \
        + math.prod(SH.local_shape(tokens.shape, tok_spec, mesh)) * 4
    return dict(fn=step_fn, args=(state, {"tokens": tokens}), kind="train",
                specs={"state": specs, "tokens": tok_spec}, mesh=mesh,
                tcfg=tcfg, n_micro=n_micro, arg_bytes=arg_bytes,
                collectives=True, donate=(0,))


def _serving_specs(cfg, mesh, tune):
    tpl = models.get(cfg).template(cfg)
    params = PM.abstract_params(tpl, torch.bfloat16)
    pspecs = PM.param_specs(tpl, SH.param_rules(mesh, fsdp=tune.fsdp),
                            SH.mesh_shape_dict(mesh))
    return params, pspecs


SERVING_NOTE = ("collective term not modelled: the port serves on one "
                "device; FLOPs, bytes and peak are the single-device step's "
                "at the global shapes divided by the chips")


def decode_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """serve_step: one new token for the whole batch against a cache of
    ``shape.seq_len`` (module docstring: run on one device, at the global
    shapes)."""
    from repro_torch.serving import lm as serving_lm

    api = models.get(cfg)
    b = shape.global_batch
    n_groups = max(1, min(SH.dp_shards(mesh), b))
    step_fn = serving_lm.make_decode_step(cfg, api, n_groups=n_groups,
                                          max_len=shape.seq_len)
    cache = api.make_cache(cfg, b, shape.seq_len, dtype=torch.bfloat16,
                           device="meta")
    cache_specs = SH.cache_spec_tree(cfg, mesh, cache, shape)
    params, pspecs = _serving_specs(cfg, mesh, tuning_for(cfg))
    tokens = _meta((b,), torch.int32)
    tok_spec = SH.batch_spec(mesh, b, extra_dims=0)
    pos = shape.seq_len - 1   # the last slot: the whole cache is live
    arg_bytes = (local_bytes(params, pspecs, mesh)
                 + local_bytes(cache, cache_specs, mesh)
                 + math.prod(SH.local_shape((b,), tok_spec, mesh)) * 4)
    return dict(fn=step_fn, args=(params, tokens, cache, pos), kind="decode",
                specs={"params": pspecs, "cache": cache_specs,
                       "tokens": tok_spec},
                mesh=mesh, tcfg=None, n_micro=1, arg_bytes=arg_bytes,
                collectives=False, note=SERVING_NOTE, donate=(2,))


def prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """The full-sequence forward (logits at the last position), on one
    device at the global shapes (module docstring)."""
    from repro_torch.serving import lm as serving_lm

    api = models.get(cfg)
    tune = tuning_for(cfg)
    tok_spec = SH.batch_spec(mesh, shape.global_batch, extra_dims=1)
    act_spec = (tok_spec[0], None, None)
    step_fn = serving_lm.make_prefill(cfg, api, impl=tune.attn_impl,
                                      act_spec=act_spec)
    params, pspecs = _serving_specs(cfg, mesh, tune)
    tokens = _meta((shape.global_batch, shape.seq_len), torch.int32)
    arg_bytes = (local_bytes(params, pspecs, mesh)
                 + math.prod(SH.local_shape(tokens.shape, tok_spec, mesh)) * 4)
    return dict(fn=step_fn, args=(params, tokens), kind="prefill",
                specs={"params": pspecs, "tokens": tok_spec}, mesh=mesh,
                tcfg=None, n_micro=1, arg_bytes=arg_bytes, collectives=False,
                note=SERVING_NOTE, donate=())


def sae_factory_cell(d_model: int, mesh, *, expansion: int = 8,
                     batch: int = 4096, microbatch: int = 512,
                     radius: float = 1.0, heads: int = 1):
    """The factory's projected dictionary-SAE train step as a cell.

    Activation rows stream in (n_micro, mb, d_model); the encoder
    ((d_model, expansion·d_model), 'ffn' over 'model') is projected onto
    the bi-level ball every step, through the mesh executor where its
    projected axes are sharded. ``heads > 1`` is the head-structured
    variant: a 3-D encoder projected onto the tri-level ℓ1,∞,∞ ball. The
    port's step gathers a custom loss's leaves whole (``training.step``),
    so the encoder's forward runs unsharded on every rank."""
    from repro_torch.models import sae
    from repro_torch.training import sae_factory as F

    d_dict = expansion * d_model
    fcfg = F.SAEFactoryConfig(expansion=expansion, radius=radius,
                              microbatch=microbatch, sae_batch=batch,
                              heads=heads)
    tcfg = F.sae_train_config(fcfg)
    tpl = sae.dict_template(d_model, d_dict, heads=heads)
    pspecs = PM.param_specs(tpl, SH.param_rules(mesh, fsdp=True),
                            SH.mesh_shape_dict(mesh))
    params = PM.abstract_params(tpl, getattr(torch, tcfg.param_dtype),
                                shape=_local(pspecs, mesh))
    state = {"params": params, "opt": {
        "step": _meta((), torch.int32),
        "m": _tree.tree_map(lambda p: _meta(p.shape, torch.float32), params),
        "v": _tree.tree_map(lambda p: _meta(p.shape, torch.float32), params),
    }}
    n_micro = batch // microbatch
    b_ax = SH.batch_spec(mesh, microbatch, extra_dims=0)
    rows_spec = (None, b_ax[0], None)
    rows = _meta((n_micro, microbatch, d_model), torch.float32)
    step_fn = F.make_sae_train_step(tcfg, mesh=mesh, param_specs=pspecs)
    arg_bytes = sum(t.numel() * t.element_size() for t in _tree.leaves(state)) \
        + math.prod(SH.local_shape(rows.shape, rows_spec, mesh)) * 4
    return dict(fn=step_fn, args=(state, {"tokens": rows}), kind="train",
                specs={"params": pspecs, "tokens": rows_spec}, mesh=mesh,
                tcfg=tcfg, n_micro=n_micro, arg_bytes=arg_bytes,
                collectives=True, donate=(0,))


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, tune=None):
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh, tune=tune)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh)
    return decode_cell(cfg, shape, mesh)


# cells that are skipped by assignment rule (full attention at 500k)
FULL_ATTENTION_500K_SKIP = {
    "stablelm-1.6b", "granite-3-2b", "qwen3-32b", "whisper-large-v3",
    "deepseek-v3-671b", "kimi-k2-1t-a32b", "chameleon-34b",
}


def cell_skipped(cfg: ArchConfig, shape: ShapeConfig):
    if shape.name == "long_500k" and cfg.name in FULL_ATTENTION_500K_SKIP:
        return ("skip: pure full-attention arch at 524k decode "
                "(sub-quadratic required; see DESIGN.md §5)")
    return None
