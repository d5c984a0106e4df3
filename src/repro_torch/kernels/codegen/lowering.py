"""Schedule IR → the generated CUDA pipeline (port of
``repro/kernels/codegen/lowering.py``).

A compiled ``Schedule`` is ``ReduceLevel* → OuterSolve → ApplyGroup*``; any
design the tiler (``tiling.plan_tiles``) accepts runs as three launches over
a batch of items:

* **reduce** (``csrc/codegen_reduce.cu``) — one streaming pass over Y gives
  every intermediate aggregate v_t and the finalized last-level aggregate;
* **outer solve** — the ℓ1 θ-solve kernel (``kernels/l1ball.py``) on the
  (B, m) aggregate, or a PyTorch rescale/clip for an ℓ2/ℓ∞ outer level;
* **apply** (``csrc/codegen_apply.cu``) — one elementwise pass over Y walks
  the radii chain down through the saved aggregates and writes X.

The mesh executor (``kernels/codegen/distributed.py``) adds two pieces: the
reduce's raw last-level accumulator (``raw=True``: ℓ2 as its sum of
squares, combined across ranks before it is finalized), and the
**partial apply** (``codegen_partial_apply``, the second entry of
``csrc/codegen_apply.cu``), which resumes the chain one level down from a
radii tensor w solved outside it.

Y is read twice and X written once, the minimum for the projection. Each
kernel sits beside its plain PyTorch version in this module
(:func:`reduce_plain`, :func:`apply_plain`, :func:`partial_apply_plain`);
the wrappers (:func:`codegen_reduce`, :func:`codegen_apply`,
:func:`codegen_partial_apply`) run the plain version for a CPU tensor and
the kernel for a CUDA tensor — nothing else. ``generate``
builds the single-item callable from the batched one: the kernels take the
batch as their leading launch axis.

Under autograd (an input that requires grad, grad mode on) the pipeline
runs as a ``torch.autograd.Function`` whose backward is the residual VJP
of ``codegen/backward.py`` in PyTorch ops, as the JAX package's
``custom_vjp`` carries its jnp backward.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import _device
from repro_torch.core import ball, schedule as sched_mod
from repro_torch.core.schedule import Schedule
from repro_torch.obs import profile as obs_profile
from repro_torch.roofline import costs as _costs

from .. import _build, l1ball
from . import backward as bwd_mod
from .tiling import (TilePlan, apply_rows, lead_geometry, plan_tiles,
                     reduce_geometry)

NORM_CODES = {"1": 0, "2": 1, "inf": 2}  # csrc/common.cuh

_P, _I = _build.PTR, _build.INT
REDUCE = _build.Kernel("codegen_reduce", {
    "codegen_reduce": [_P, _P, _P, _P, _P] + [_I] * 15 + [_P],
})
APPLY = _build.Kernel("codegen_apply", {
    "codegen_apply": [_P] * 6 + [_I] * 13 + [_P],
})
PARTIAL_APPLY = _build.Kernel("codegen_partial_apply", {
    "codegen_partial_apply": [_P] * 5 + [_I] * 10 + [_P],
}, source="codegen_apply")


# --------------------------------------------------------------------------- #
# Plain versions (PyTorch ops): the per-norm monoid of the reduce
# --------------------------------------------------------------------------- #


def _tile(q: str, a: torch.Tensor, dim: int) -> torch.Tensor:
    """Fold axis ``dim`` of non-negative ``a`` into its ``q``-norm."""
    if q == "1":
        return a.sum(dim=dim)
    if q == "2":
        return torch.sqrt((a * a).sum(dim=dim))
    return a.amax(dim=dim)


def finalize(q: str, acc: torch.Tensor) -> torch.Tensor:
    """The ``q``-norm from its raw accumulator (ℓ2: the root of the sum of
    squares; ℓ1 and ℓ∞ accumulate the norm itself)."""
    return torch.sqrt(acc) if q == "2" else acc


def reduce_plain(yc: torch.Tensor, norms: Sequence[str], raw: bool = False
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The reduce pass in PyTorch ops on the batched canonical view
    ``yc`` (B, *lead, n, m): ``([v_1, …, v_{L-2}], vfin)``; with ``raw``,
    the last level's raw accumulator in place of ``vfin``."""
    cur = yc.abs()
    aggs = []
    for q in norms[:-1]:
        cur = _tile(q, cur, 1)          # fold the leading lead axis
        aggs.append(cur)
    if raw and norms[-1] == "2":
        return aggs, (cur * cur).sum(dim=1)
    return aggs, _tile(norms[-1], cur, 1)


def _grouped_l1(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Project every slice of ``x`` along axis 1 onto the ℓ1 ball of its
    radius ``r`` (size-1 axis 1): the 64-step bisection of the ℓ1 kernel's
    plain version, one row per group, θ = 0 inside."""
    xt = x.movedim(1, -1)
    rows = l1ball.project_l1_plain(xt.reshape(-1, xt.shape[-1]),
                                   r.movedim(1, -1).reshape(-1), "bisect")
    return rows.reshape(xt.shape).movedim(-1, 1)


def _shrink(q: str, x: torch.Tensor, w: torch.Tensor,
            agg: Optional[torch.Tensor]) -> torch.Tensor:
    """One apply level on groups along axis 1 of ``x``; ``w`` and ``agg``
    carry a size-1 axis 1."""
    if q == "inf":
        return torch.minimum(torch.maximum(x, -w), w)
    if q == "2":
        return x * torch.where(agg > w, w / torch.clamp(agg, min=1e-30),
                               torch.ones_like(agg))
    return _grouped_l1(x, w)


def partial_apply_plain(yc: torch.Tensor, aggs: Sequence[torch.Tensor],
                        w: torch.Tensor, norms: Sequence[str]) -> torch.Tensor:
    """Levels L-2 … 1 of the apply pass in PyTorch ops: the radii chain
    resumed from ``w``, the level-(L-1) radii shaped like ``aggs[-1]``
    (B, n, m), down through ``stages = [yc, v_1, …, v_{L-2}]``."""
    stages = [yc, *aggs]
    for lvl in range(len(norms) - 1, 0, -1):
        w = _shrink(norms[lvl - 1], stages[lvl - 1], w[:, None],
                    stages[lvl][:, None])
    return w


def apply_plain(yc: torch.Tensor, aggs: Sequence[torch.Tensor],
                vfin: torch.Tensor, u: torch.Tensor,
                norms: Sequence[str]) -> torch.Tensor:
    """The apply pass in PyTorch ops: the radii chain from ``u`` (B, m) down
    through ``stages = [yc, v_1, …, v_{L-2}]``."""
    w = _shrink(norms[-1], aggs[-1] if aggs else yc, u[:, None], vfin[:, None])
    return partial_apply_plain(yc, aggs, w, norms)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def _lead_args(tp: TilePlan) -> Tuple[int, int]:
    lead = tuple(tp.lead) + (1,) * (2 - len(tp.lead))
    return lead[0], lead[1]


def _check_f32_contiguous(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 tensors, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


def _codes(norms: Sequence[str]) -> Tuple[int, int, int]:
    """(q1, q2, qlast) of the kernels: the lead levels' norms, then L-1's."""
    lead = [NORM_CODES[q] for q in norms[:-1]] + [0, 0]
    return lead[0], lead[1], NORM_CODES[norms[-1]]


_ALIGN = 32  # floats: every view of the reduce's buffer starts 128-byte aligned


@functools.lru_cache(maxsize=256)
def _reduce_launch(tp: TilePlan, norms: Tuple[str, ...], batch: int, vec: int):
    """What one reduce call allocates and passes, computed once per design,
    batch and vec (``tiling.reduce_geometry``: the plan's packs and splits
    where it fixes them): ``(views, total, ints)``. ``views`` are the ``(offset,
    shape)`` of the aggregates, vfin and (when the rows split) the partial
    scratch in one buffer of ``total`` floats, each offset a multiple of
    ``_ALIGN``; ``ints`` the kernel's integer arguments from ``batch`` to
    ``splits``."""
    n, m = tp.n, tp.m
    rs = reduce_geometry(tp, batch, vec)
    shapes = [(batch,) + tp.lead[t:] + (n, m) for t in range(1, len(tp.lead) + 1)]
    shapes.append((batch, m))
    if rs.splits > 1:
        shapes.append((batch, rs.splits, m))
    views, off = [], 0
    for sh in shapes:
        views.append((off, sh))
        off += -(-math.prod(sh) // _ALIGN) * _ALIGN
    g1, g2 = _lead_args(tp)
    q1, q2, qlast = _codes(norms)
    ints = (batch, len(tp.lead), g1, g2, n, m, q1, q2, qlast, rs.vec, rs.packs,
            rs.lanes, rs.rows, rs.splits)
    return tuple(views), off, ints


def codegen_reduce(yc: torch.Tensor, tp: TilePlan, norms: Sequence[str],
                   raw: bool = False
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Every forward aggregate of the batched canonical view ``yc``
    (B, *tp.canon_shape): ``([v_1, …, v_{L-2}], vfin (B, m))``. ``norms``
    are the reduce norms q_1 … q_{L-1}. ``raw`` returns the last level's raw
    accumulator in place of ``vfin`` (see :func:`finalize`). On a CUDA
    tensor the geometry is ``tiling.reduce_split``'s, and the aggregates,
    vfin and the kernel's scratch are views of one allocation."""
    if tuple(yc.shape[1:]) != tp.canon_shape or len(norms) != len(tp.lead) + 1:
        raise ValueError(f"codegen_reduce: {tuple(yc.shape)} does not match "
                         f"the plan {tp.canon_shape} / norms {list(norms)}")
    if yc.is_cpu:
        return reduce_plain(yc, norms, raw)
    _device.require_cuda(yc, "codegen_reduce")
    _check_f32_contiguous("codegen_reduce", yc)
    ptr = yc.data_ptr()
    vec = 4 if tp.m % 4 == 0 and ptr % 16 == 0 else 1
    views, total, ints = _reduce_launch(tp, tuple(norms), yc.shape[0], vec)
    if len(views) == 1:  # vfin alone
        out = [yc.new_empty(views[0][1])]
    else:
        buf = yc.new_empty(total)
        out = [buf[off:off + math.prod(sh)].view(sh) for off, sh in views]
    lead = len(tp.lead)
    aggs, vfin = out[:lead], out[lead]
    if _costs.active() and _costs.declare(
            REDUCE, yc, *_costs.codegen_reduce(
                yc.numel(), sum(a.numel() for a in aggs), yc.shape[0], tp.m)):
        return aggs, vfin
    REDUCE.launch("codegen_reduce", ptr, aggs[0].data_ptr() if lead else None,
                  aggs[1].data_ptr() if lead > 1 else None,
                  out[-1].data_ptr() if len(out) > lead + 1 else None,
                  vfin.data_ptr(), *ints, int(raw), _build.stream_handle(yc))
    return aggs, vfin


def codegen_apply(yc: torch.Tensor, aggs: Sequence[torch.Tensor],
                  vfin: torch.Tensor, u: torch.Tensor, tp: TilePlan,
                  norms: Sequence[str],
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused backward sweep: X (B, *tp.canon_shape) from ``yc``, the
    reduce's aggregates, ``vfin`` and the solved ``u`` (B, m). ``out`` may
    be ``yc`` itself (in-place projection)."""
    if tuple(yc.shape[1:]) != tp.canon_shape or len(aggs) != len(tp.lead) \
            or len(norms) != len(tp.lead) + 1:
        raise ValueError(f"codegen_apply: {tuple(yc.shape)} does not match "
                         f"the plan {tp.canon_shape} / norms {list(norms)}")
    if yc.device.type == "cpu":
        x = apply_plain(yc, aggs, vfin, u, norms)
        return x if out is None else out.copy_(x)
    _device.require_cuda(yc, "codegen_apply")
    _check_f32_contiguous("codegen_apply", yc, vfin, u, *aggs)
    b, n, m = yc.shape[0], tp.n, tp.m
    if vfin.shape != (b, m) or u.shape != (b, m):
        raise ValueError("codegen_apply: vfin and u must be (B, m)")
    if out is None:
        out = torch.empty_like(yc)
    elif out.shape != yc.shape or out.dtype != yc.dtype \
            or not out.is_contiguous() or out.device != yc.device:
        raise ValueError("out must be a contiguous float32 tensor like yc")
    g1, g2 = _lead_args(tp)
    q1, q2, qlast = _codes(norms)
    v1 = aggs[0] if aggs else None
    v2 = aggs[1] if len(aggs) > 1 else None
    chunk = vec = 0
    if split_lead(tp, norms):
        ptrs = yc.data_ptr() | out.data_ptr() | vfin.data_ptr() | u.data_ptr()
        for a in aggs:
            ptrs |= a.data_ptr()
        ls = lead_geometry(tp, g1 * g2, b,
                           4 if ptrs % 16 == 0 and m % 4 == 0 else 1)
        rows, splits, chunk, vec = 0, ls.splits, ls.chunk, ls.vec
    else:
        rows, splits = apply_rows(tp, b)
    if _costs.active() and _costs.declare(
            APPLY, yc, *_costs.codegen_apply(
                yc.numel(), sum(a.numel() for a in aggs), b, m,
                norms[-1] == "2")):
        return out
    APPLY.launch("codegen_apply", yc.data_ptr(), _build.ptr(v1),
                 _build.ptr(v2), vfin.data_ptr(), u.data_ptr(),
                 out.data_ptr(), b, len(tp.lead), g1, g2, n, m, q1, q2,
                 qlast, rows, splits, chunk, vec, _build.stream_handle(yc))
    return out


def split_lead(tp: TilePlan, norms: Sequence[str]) -> bool:
    """Whether the apply of ``tp`` under reduce norms ``norms`` takes the
    lead-split kernel: a lead axis, no ℓ1 among its levels nor at level
    L-1, so each element of a lead group shrinks alone."""
    return bool(tp.lead) and "1" not in norms


def codegen_partial_apply(yc: torch.Tensor, aggs: Sequence[torch.Tensor],
                          w: torch.Tensor, tp: TilePlan, norms: Sequence[str],
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Levels L-2 … 1 of the backward sweep, resumed from ``w``: X (B,
    *tp.canon_shape) from ``yc``, the reduce's aggregates and the level-(L-1)
    radii ``w``, shaped like ``aggs[-1]`` (B, n, m). Designs of depth 3 and 4
    (one or two lead axes). ``out`` may be ``yc`` itself."""
    if tuple(yc.shape[1:]) != tp.canon_shape or len(aggs) != len(tp.lead) \
            or len(norms) != len(tp.lead) + 1 or not 1 <= len(tp.lead) <= 2:
        raise ValueError(f"codegen_partial_apply: {tuple(yc.shape)} does not "
                         f"match the plan {tp.canon_shape} / norms "
                         f"{list(norms)}, or the design has no lead level")
    b, n, m = yc.shape[0], tp.n, tp.m
    if tuple(w.shape) != (b, n, m):
        raise ValueError(f"codegen_partial_apply: w must be {(b, n, m)}, got "
                         f"{tuple(w.shape)}")
    if yc.device.type == "cpu":
        x = partial_apply_plain(yc, aggs, w, norms)
        return x if out is None else out.copy_(x)
    _device.require_cuda(yc, "codegen_partial_apply")
    _check_f32_contiguous("codegen_partial_apply", yc, w, *aggs)
    if out is None:
        out = torch.empty_like(yc)
    elif out.shape != yc.shape or out.dtype != yc.dtype \
            or not out.is_contiguous() or out.device != yc.device:
        raise ValueError("out must be a contiguous float32 tensor like yc")
    rows, splits = apply_rows(tp, b)
    g1, g2 = _lead_args(tp)
    q1, q2, _ = _codes(norms)
    v1 = aggs[0]
    v2 = aggs[1] if len(aggs) > 1 else None
    if _costs.active() and _costs.declare(
            PARTIAL_APPLY, yc, *_costs.codegen_partial_apply(
                yc.numel(), w.numel(), v1.numel() if norms[0] == "2" else 0)):
        return out
    PARTIAL_APPLY.launch("codegen_partial_apply", yc.data_ptr(), v1.data_ptr(),
                         _build.ptr(v2), w.data_ptr(), out.data_ptr(), b,
                         len(tp.lead), g1, g2, n, m, q1, q2, rows, splits,
                         _build.stream_handle(yc))
    return out


# --------------------------------------------------------------------------- #
# Outer stage + the generator
# --------------------------------------------------------------------------- #


def _solve_outer_batched(v: torch.Tensor, norm: str, radii: torch.Tensor,
                         method: str) -> torch.Tensor:
    """Per-item outer solves on the (B, m) finalized aggregates."""
    if norm == "1":
        return l1ball.project_l1_batched(v, radii, method=method)
    if norm == "2":
        return ball.project_l2(v, radii)
    return torch.minimum(v, radii[:, None])  # ℓ∞ on v >= 0




class _Pipeline(torch.autograd.Function):
    """The generated pipeline under autograd: the forward runs the three
    launches (or their plain versions) with grad mode off, the backward is
    the residual VJP of ``backward.schedule_vjp`` on what the forward saved
    (``yc``, ``x``, the aggregates, ``vfin`` and ``u``: the JAX package's
    residuals), with no second forward."""

    @staticmethod
    def forward(ctx, yc, radii, run, norms):
        x, internals = run(yc, radii)
        ctx.norms = norms
        saved = ()
        if internals:
            aggs, vfin, u = internals
            saved = (*aggs, vfin, u)
        ctx.save_for_backward(yc, x, radii, *saved)
        return x

    @staticmethod
    def backward(ctx, g):
        yc, x, radii, *rest = ctx.saved_tensors
        norms = ctx.norms
        if len(norms) == 1:
            stages, u = [yc], x
        else:
            *aggs, vfin, u = rest
            stages = [yc, *aggs, vfin]
        dy, dr = bwd_mod.schedule_vjp(norms, stages, u, x, radii,
                                      g.contiguous())
        return dy, dr, None, None


def generate_batched(sched: Schedule, dtype, *, method: str = "bisect",
                     device=None, tile_plan: Optional[TilePlan] = None
                     ) -> Callable:
    """Compile ``sched`` into ``(ys, radii, out=None) -> xs`` for a bucket of
    B items stacked on a leading axis with one radius each.

    ``device`` (default ``"cuda"``) is where the callable runs: a CUDA
    device launches the kernels, ``"cpu"`` runs their plain versions, and
    inputs on any other device raise. ``method`` is the outer ℓ1 θ-solve,
    ``"bisect"`` or ``"filter"``; the grouped solves inside the apply are
    always the 64-step bisection. ``out`` receives X and may be ``ys``.

    When ``ys`` or ``radii`` requires grad (and grad mode is on) the call
    runs under :class:`_Pipeline`: the same launches, and a backward that
    gives ``ys`` and ``radii`` their cotangents; ``out`` is then refused.

    ``tile_plan`` (one of ``tiling.candidate_tile_plans``) fixes the launch
    geometry; by default it is ``plan_tiles``' heuristic.
    """
    dev = _device.resolve(device)
    if sched.batch_dims:
        raise ValueError(
            "generate_batched takes a batch-free schedule; the stacked "
            "serving axis is the callable's leading axis")
    if method not in l1ball.KERNEL_METHODS:
        raise ValueError(f"the outer solve kernel takes {l1ball.KERNEL_METHODS}, "
                         f"not {method!r}")
    tp = plan_tiles(sched, dtype)
    if tp is None:
        raise ValueError(
            f"codegen cannot lower levels={sched.levels} on shape="
            f"{sched.shape} as {dtype}: the Hopper tiler rejects it")
    if tile_plan is not None:
        if tile_plan[:6] != tp[:6]:
            raise ValueError(f"tile plan {tile_plan} is not a plan of "
                             f"{sched.shape} (the tiler's is {tp})")
        tp = tile_plan
    norms = [q for q, _ in sched.levels]

    def run(yc, radii, oc=None):
        """The three launches: ``(x, (aggs, vfin, u))``, or ``(x, ())`` for
        a design that is its outer solve."""
        if len(norms) == 1:
            with obs_profile.scope(f"codegen_solve_{norms[0]}"):
                x = l1ball.project_l1_batched(yc, radii, method=method, out=oc)
            return x, ()
        with obs_profile.scope("codegen_reduce"):
            aggs, vfin = codegen_reduce(yc, tp, norms[:-1])
        with obs_profile.scope(f"codegen_solve_{norms[-1]}"):
            u = _solve_outer_batched(vfin, norms[-1], radii, method)
        with obs_profile.scope("codegen_apply"):
            x = codegen_apply(yc, aggs, vfin, u, tp, norms[:-1], out=oc)
        return x, (aggs, vfin, u)

    def fused(ys: torch.Tensor, radii, out: torch.Tensor | None = None):
        if ys.device.type != dev.type:
            raise ValueError(f"kernel built for {dev.type}, got a tensor on "
                             f"{ys.device}")
        if tuple(ys.shape[1:]) != sched.shape:
            raise ValueError(f"batched kernel built for item shape "
                             f"{sched.shape}, got {tuple(ys.shape)}")
        batch = ys.shape[0]
        radii = torch.as_tensor(radii, dtype=ys.dtype, device=ys.device)
        if radii.shape != (batch,):
            raise ValueError(f"radii must be one scalar per stacked item: got "
                             f"{tuple(radii.shape)} for batch {batch}")
        yc = ys.reshape((batch,) + tp.canon_shape)
        if _device.records_grad(ys, radii):
            if out is not None:
                raise ValueError("out= writes in place, which autograd cannot "
                                 "follow: drop it for an input that requires "
                                 "grad")
            x = _Pipeline.apply(yc, radii, run, tuple(norms))
        else:
            oc = None if out is None else out.view((batch,) + tp.canon_shape)
            x = run(yc, radii, oc)[0]
        return x.reshape(ys.shape)

    return fused


def generate(sched: Schedule, dtype, *, method: str = "bisect",
             device=None, tile_plan: Optional[TilePlan] = None) -> Callable:
    """Compile ``sched`` into ``(y, radius, out=None) -> x`` with one scalar
    radius. Leading batch axes of the schedule join the kernels' batch axis
    (every item gets ``radius``), the counterpart of JAX's vmap.
    ``tile_plan``: as :func:`generate_batched`'s."""
    base = sched if not sched.batch_dims else sched_mod.compile_schedule(
        sched.shape[sched.batch_dims:], sched.levels)
    batched = generate_batched(base, dtype, method=method, device=device,
                               tile_plan=tile_plan)
    count = math.prod(sched.shape[:sched.batch_dims])

    def fused(y: torch.Tensor, radius, out: torch.Tensor | None = None):
        ys = y.reshape((count,) + base.shape)
        radii = torch.as_tensor(radius, dtype=y.dtype, device=y.device)
        if radii.ndim:
            raise ValueError("generate takes one scalar radius")
        x = batched(ys, radii.expand(count).contiguous(),
                    out=None if out is None else out.view(ys.shape))
        return x.reshape(y.shape)

    return fused
