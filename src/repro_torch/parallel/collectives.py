"""The collectives that GSPMD inserts implicitly in the JAX package's
sharded step, made explicit as ``torch.autograd.Function`` s over a
:class:`~repro_torch.parallel.mesh.Mesh` (Megatron's f / g operators and
ZeRO-3's gather):

* :func:`enter` — into a tensor-parallel region: identity forward, psum
  of the gradient backward (each rank's heads or ffn slice contribute a
  part of the input's gradient);
* :func:`leave` — out of it: psum forward (the partial products of a
  row-parallel matmul), identity backward;
* :func:`gather` — the FSDP gather of a weight's sharded axis: all-gather
  forward; backward, the psum of the full gradient over that mesh axis,
  then this rank's slice (a reduce-scatter built from the mesh's exact
  all-reduce);
* :func:`vocab_embed` and :func:`vocab_xent` — the embedding lookup and
  the next-token cross-entropy over a vocabulary sharded on "model": ids
  outside this rank's rows are masked and the pieces psummed; the
  logsumexp is a pmax and a psum, the target logit a masked local gather
  and a psum (what JAX's ``xent`` docstring says GSPMD lowers to).

Every collective goes through the mesh, which counts its calls and bytes.
A collective over mesh axes of size 1 is skipped (and not counted).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Axes = Union[str, Sequence[str]]


def live_axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """The axes among ``axes`` (a name or names) that span more than one
    rank, in mesh order: the ones a collective has to cross."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in mesh.axis_names if a in names and mesh.shape[a] > 1)


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over the live ``axes`` (not differentiable; ``x`` itself when
    none is live)."""
    live = live_axes(mesh, axes)
    return mesh.psum(x, live) if live else x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, axis, sum_grad):
        ctx.mesh, ctx.name, ctx.axis, ctx.local = mesh, name, axis, x.shape[axis]
        ctx.sum_grad = sum_grad
        return mesh.all_gather(x, name, axis)

    @staticmethod
    def backward(ctx, g):
        full = ctx.mesh.psum(g, (ctx.name,)) if ctx.sum_grad else g
        idx = ctx.mesh.axis_index(ctx.name)
        return full.narrow(ctx.axis, idx * ctx.local, ctx.local).contiguous(), \
            None, None, None, None


def enter(x: torch.Tensor, mesh, axes: Axes = "model") -> torch.Tensor:
    """Identity forward, psum of the gradient over ``axes`` backward."""
    live = live_axes(mesh, axes)
    return _Enter.apply(x, mesh, live) if live else x


def leave(x: torch.Tensor, mesh, axes: Axes = "model") -> torch.Tensor:
    """Psum over ``axes`` forward, identity backward."""
    live = live_axes(mesh, axes)
    return _Leave.apply(x, mesh, live) if live else x


def gather(x: torch.Tensor, mesh, name: str, axis: int,
           sum_grad: bool = True) -> torch.Tensor:
    """All-gather tensor axis ``axis`` over mesh axis ``name`` (the ranks'
    slices in coordinate order; a spec entry's axes, row-major); backward:
    psum over ``name`` (the ranks saw other data), then own slice.
    ``sum_grad=False`` skips the psum, for ranks that computed the same
    gradient from the same data."""
    if not live_axes(mesh, name):
        return x
    return _Gather.apply(x, mesh, name, axis % x.ndim, sum_grad)


def gather_spec(x: torch.Tensor, spec, mesh, keep: Axes = "model",
                data_axes: Axes = ("pod", "data")) -> torch.Tensor:
    """``x`` (this rank's shard under ``spec``) with every sharded axis
    gathered except those over ``keep``: with the default, the FSDP gather
    of a weight, whose tensor-parallel axes stay local. The gradient is
    psummed over the gathered axes among ``data_axes`` (where the ranks saw
    other slices of the batch) and only sliced over the others."""
    keep = (keep,) if isinstance(keep, str) else tuple(keep)
    data_axes = (data_axes,) if isinstance(data_axes, str) else tuple(data_axes)
    for axis, name in enumerate(spec):
        if name is not None and name not in keep:
            names = (name,) if isinstance(name, str) else tuple(name)
            x = gather(x, mesh, name, axis,
                       sum_grad=bool(set(names) & set(data_axes)))
    return x


def gather_full(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's (unpadded) shard under
    ``spec``, on every rank: an all-gather per sharded axis (not
    differentiable; a checkpoint's leaf by leaf gather)."""
    for axis, name in enumerate(spec):
        if name is not None and live_axes(mesh, name):
            x = mesh.all_gather(x, name, axis)
    return x


def _vocab_range(mesh, v_local: int) -> Tuple[int, int]:
    lo = mesh.axis_index("model") * v_local
    return lo, lo + v_local


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """``table`` holds rows [lo, lo + V/M) of the embedding (this rank's
    "model" slice): look the ids up in it, zero the rows of ids outside it,
    and psum over "model" (:func:`leave`)."""
    lo, hi = _vocab_range(mesh, table.shape[0])
    inside = (ids >= lo) & (ids < hi)
    local = torch.where(inside, ids - lo, torch.zeros_like(ids))
    rows = table[local] * inside[..., None].to(table.dtype)
    return leave(rows, mesh, "model")


def vocab_xent(logits: torch.Tensor, targets: torch.Tensor, mesh) -> torch.Tensor:
    """Mean next-token NLL (float32) of logits (B, S, V/M) that hold this
    rank's "model" slice of the vocabulary: a pmax and a psum make the
    logsumexp, a masked local gather and a psum the target logit. The
    result is the same on every rank of a "model" line."""
    lf = logits.float()
    m = lf.detach().amax(dim=-1)
    live = live_axes(mesh, "model")
    if live:
        m = mesh.pmax(m, live)
    sumexp = leave(torch.exp(lf - m[..., None]).sum(dim=-1), mesh, "model")
    lse = torch.log(sumexp) + m
    lo, hi = _vocab_range(mesh, logits.shape[-1])
    t = targets.long()
    inside = (t >= lo) & (t < hi)
    local = torch.where(inside, t - lo, torch.zeros_like(t))
    tgt = torch.gather(lf, -1, local[..., None])[..., 0] * inside.to(lf.dtype)
    tgt = leave(tgt, mesh, "model")
    return (lse - tgt).mean()
