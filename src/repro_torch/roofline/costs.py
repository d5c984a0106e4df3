"""The cost of a step, walked from what it dispatches (the port's
counterpart of ``repro/roofline/hlo_parse.py``).

The JAX package lowers a step, compiles it and walks XLA's HLO text. Eager
PyTorch has no such program: the step *is* the sequence of operations it
dispatches. :class:`walk` is a ``TorchDispatchMode`` that sees each one as
it runs, on any device (``meta`` tensors included, where nothing is
computed), and adds up the fields of ``hlo_parse.Costs``:

* **FLOPs** — matmul-class operations only (mm, bmm, addmm, baddbmm,
  convolutions, SDPA: the operations ``torch.utils.flop_counter`` has
  formulas for), by its formulas; ``hlo_parse`` counts dots only;
* **bytes** — the operands plus the results of every operation, each at
  ``numel · element_size``; views and aliases move nothing and are free
  (``hlo_parse._FREE_OPS``), and a tensor an operation only writes
  (``copy_``/``fill_``/``zero_``'s destination, an ``out=`` argument) is
  not read. Eager PyTorch fuses nothing, so this is the step's traffic;
* **collectives** — the mesh's own counts (``parallel.mesh``), by op, as
  ``hlo_parse`` names them: an all-reduce (psum, pmax) at twice its bytes
  (a ring sends and receives about the buffer each), an all-gather at its
  result's; and by the mesh axes each spanned (``coll_by_axis``), which
  ``roofline/analysis.py`` prices at each link's rate;
* **memory** — the peak of the bytes of live storages that the step
  allocated (its arguments excluded), followed by the storages' own
  lifetimes (a storage an autograd node keeps alive stays live): the
  counterpart of ``memory_analysis().temp_size_in_bytes``.

The hand-written kernels launch through ``ctypes`` (``kernels/_build.py``)
and no dispatch mode sees them. Each wrapper reports its kernel with
:func:`declare` just before the launch, at the bytes and operations of this
module's table (computed only where :func:`active` finds a walk, so a
launch outside one pays nothing for it), the same formulas ``chip_smoke.py``'s ``bound_ms`` column
reads; the flash kernels' operations are matmul FLOPs and count as such,
the projection kernels' (elementwise) only in ``kernels``. On a ``meta``
tensor inside a walk the wrapper allocates its outputs and launches
nothing (``_device.require_cuda``), so a meta walk and a walk of the same
step on the card give the same FLOPs and bytes.

**Repeated bodies.** ``hlo_parse`` multiplies a while body by its trip
count. Here a loop body marks itself with :func:`section` (the train step's
micro-batch); ``Costs.repeat(name, n)`` then gives the cost of the walked
step had the section run ``n`` times, so the dry run walks one micro-batch
of a step that has many. A loop over time or chunks inside a model (the
sLSTM's steps, the mLSTM's chunks: thousands of small operations at a
production sequence, each dispatched to a ``meta`` kernel in Python) runs
one step in a walk on ``meta`` tensors (:func:`walked_steps`) and counts
the others forward and backward from one more run of the step
(:func:`count_steps`). Only the peak is not scaled: the activations such
a loop saves for the backward count for the walked step alone.

Everything is per rank; ``roofline/analysis.py`` multiplies by the chips.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.utils import flop_counter as _flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_ACTIVE = []          # the walks in progress, innermost last
_aten = torch.ops.aten

# operations that allocate or alias without moving data
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten.detach, _aten.detach_, _aten.alias,
         _aten.lift_fresh, _aten.resize_, _aten.set_}
# operations that only write their first argument
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}
_ALL_REDUCE = ("psum", "pmax")


# --------------------------------------------------------------------------- #
# The kernels' table: (bytes, operations) of one launch, each input read once
# and each output written once
# --------------------------------------------------------------------------- #


def attention_pairs(sq: int, sk: int, causal: bool, window=None) -> float:
    """The (query, key) pairs a head attends: Sq·Sk, half of it causal, at
    most Sq·window under a window."""
    pairs = sq * sk / 2 if causal else sq * sk
    return min(pairs, sq * window) if window else pairs


def _attn(q, k, causal, window):
    b, hq, sq, d = q.shape
    work = b * hq * d * attention_pairs(sq, k.shape[2], causal, window)
    return q.element_size(), q.numel(), k.numel(), b * hq * sq, work


def flash_fwd(q, k, causal: bool = True, window=None) -> Tuple[float, float]:
    """q, k, v and o once each and the float32 lse; 4 FLOPs a pair and
    head dim (QKᵀ and PV)."""
    es, n_q, n_k, n_r, work = _attn(q, k, causal, window)
    return es * (2 * n_q + 2 * n_k) + 4 * n_r, 4 * work


def flash_bwd_dq(q, k, causal: bool = True, window=None) -> Tuple[float, float]:
    """q, dO, dq, k, v and lse, delta; 6 FLOPs a pair and head dim."""
    es, n_q, n_k, n_r, work = _attn(q, k, causal, window)
    return es * (3 * n_q + 2 * n_k) + 8 * n_r, 6 * work


def flash_bwd_dkv(q, k, causal: bool = True, window=None) -> Tuple[float, float]:
    """q, dO, k, v, dk, dv and lse, delta; 8 FLOPs a pair and head dim."""
    es, n_q, n_k, n_r, work = _attn(q, k, causal, window)
    return es * (2 * n_q + 4 * n_k) + 8 * n_r, 8 * work


def codegen_reduce(elems: int, agg_elems: int, batch: int, m: int):
    """Y read once, every aggregate and vfin written once."""
    return 4 * (elems + agg_elems + batch * m), 2 * elems + 2 * agg_elems


def codegen_apply(elems: int, agg_elems: int, batch: int, m: int,
                  reads_vfin: bool):
    """Y read and X written once, the aggregates and u read once, vfin only
    where an ℓ2 at the last reduce level rescales by it."""
    return (4 * (2 * elems + agg_elems + batch * m
                 + (batch * m if reads_vfin else 0)),
            2 * elems + 2 * agg_elems)


def codegen_partial_apply(elems: int, w_elems: int, v1_elems: int):
    """Y read and X written once, w read once, v1 only where an ℓ2 at level
    L-2 rescales by it (``v1_elems`` 0 otherwise)."""
    return 4 * (2 * elems + w_elems + v1_elems), 2 * elems


def l1ball(batch: int, n: int, itemsize: int = 4):
    """v read and x written once (``itemsize`` bytes a value), the float32
    radii read; the 64-step bisection's three operations a value and step,
    plus six."""
    return itemsize * 2 * batch * n + 4 * batch, batch * n * (3 * 64 + 6)


def colmax(itemsize: int, elems: int, m: int):
    return itemsize * (elems + m), 2 * elems


def clip(itemsize: int, elems: int, m: int):
    return itemsize * (2 * elems + m), 2 * elems


def trilevel_reduce(itemsize: int, elems: int, nm: int, m: int):
    return itemsize * (elems + nm + m), 2 * elems + nm


def trilevel_apply(itemsize: int, elems: int, nm: int, m: int):
    return itemsize * (2 * elems + nm + m), 2 * elems + nm


# --------------------------------------------------------------------------- #
# The walk
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Costs:
    """One rank's cost of what a walk saw (``hlo_parse.Costs``'s fields,
    plus the per-axis collective bytes, the kernels' declared costs and
    the peak of live bytes)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    coll_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    dot_flops_by_shape: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: defaultdict(float)))
    peak_bytes: int = 0
    sections: Dict[str, "Costs"] = dataclasses.field(default_factory=dict)
    passes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, other: "Costs", mult: float = 1.0) -> None:
        """Add ``mult`` times ``other``'s counts (not its peak or sections)."""
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        for mine, theirs in ((self.coll_by_kind, other.coll_by_kind),
                             (self.coll_by_axis, other.coll_by_axis),
                             (self.dot_flops_by_shape, other.dot_flops_by_shape)):
            for k, v in theirs.items():
                mine[k] += v * mult
        for k, v in other.kernels.items():
            for f, x in v.items():
                self.kernels[k][f] += x * mult

    def counts(self) -> "Costs":
        """The counts alone (no peak, no sections)."""
        out = Costs()
        out.add(self)
        return out

    def repeat(self, name: str, n: int) -> "Costs":
        """These costs had section ``name`` run ``n`` times in all (it ran
        ``passes[name]`` times in the walk, at the same cost each). The
        peak is kept: one more pass of a body that frees what it allocates
        raises no peak."""
        out = self.counts()
        out.peak_bytes = self.peak_bytes
        ran = self.passes.get(name, 0)
        if n != ran:
            if not ran:
                raise ValueError(f"section {name!r} did not run in the walk")
            out.add(self.sections[name], (n - ran) / ran)
        return out


def active() -> Optional["walk"]:
    """The innermost walk in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def declare(kernel, t: torch.Tensor, nbytes: float, ops: float, *,
            matmul: bool = False) -> bool:
    """A kernel wrapper's report, just before its launch: ``kernel`` (a
    ``_build.Kernel``) moves ``nbytes`` and does ``ops`` operations (matmul
    FLOPs when ``matmul``). Returns True when a walk is active and ``t`` is
    a ``meta`` tensor: the call is abstract and launches nothing."""
    w = active()
    if w is None:
        return False
    w._kernel(kernel.name, nbytes, ops, matmul)
    return t.is_meta


def walked_steps(n: int, like: torch.Tensor) -> int:
    """How many steps of an ``n``-step loop whose steps all cost alike to
    run: ``n``, but one inside a walk where ``like`` is a ``meta`` tensor;
    :func:`count_steps` then counts the other ``n - 1``."""
    return 1 if n > 1 and like.is_meta and active() is not None else n


def count_steps(step, inputs, extra: int, out: torch.Tensor,
                shared=()) -> torch.Tensor:
    """Inside a walk, count ``extra`` more runs of ``step(*inputs)`` in a
    loop whose result is ``out``, and return ``out``. ``step`` runs once
    more on detached copies of the inputs, and its vector-Jacobian product
    is taken (the gradient of every floating input, and for each input
    that every step reads, its index in ``shared``, the sum autograd adds
    that step's gradient into): the forward's cost
    counts ``extra`` times here (this run's own, and the rest), and the
    backward's when ``out``'s gradient arrives (an identity on ``out``
    adds it then, so a recomputed block counts its forward twice and its
    backward once, as it runs). Under no grad the forward alone. Outside a
    walk ``out`` itself."""
    w = active()
    if w is None or extra <= 0:
        return out
    grad = torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
    s0 = w._snapshot()
    xs = [x.detach().requires_grad_(grad and x.is_floating_point())
          for x in inputs]
    # identity saved-tensor hooks: inside a checkpointed block the
    # checkpoint's own hooks would recompute the whole block to unpack
    # what this run saves
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
        outs = [o for o in tree_leaves(step(*xs))
                if isinstance(o, torch.Tensor) and o.requires_grad]
        s1 = w._snapshot()
        if grad:
            wrt = [i for i, x in enumerate(xs) if x.requires_grad]
            gs = dict(zip(wrt, torch.autograd.grad(
                outs, [xs[i] for i in wrt], [torch.ones_like(o) for o in outs],
                allow_unused=True)))
            for i in shared:
                if gs.get(i) is not None:
                    gs[i].add(gs[i])
    s2 = w._snapshot()
    fwd, bwd = s1, s2
    bwd.add(s1, -1.0)
    fwd.add(s0, -1.0)
    w.costs.add(fwd, extra - 1)
    w.costs.add(bwd, -1.0)
    if not (grad and out.requires_grad):
        return out
    return _CountBackward.apply(out, w, bwd, extra)


class _CountBackward(torch.autograd.Function):
    """Identity; its backward adds ``extra`` times a step's backward cost
    to the walk (:func:`count_steps`)."""

    @staticmethod
    def forward(ctx, x, w, bwd, extra):
        ctx.w, ctx.bwd, ctx.extra = w, bwd, extra
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.w.costs.add(ctx.bwd, ctx.extra)
        return g, None, None, None


@contextlib.contextmanager
def section(name: str):
    """Mark a repeated body (module docstring); free outside a walk."""
    w = active()
    if w is None:
        yield
        return
    before = w._snapshot()
    try:
        yield
    finally:
        delta = w._snapshot()
        delta.add(before, -1.0)
        c = w.costs
        if name in c.sections:
            c.sections[name].add(delta)
        else:
            c.sections[name] = delta
        c.passes[name] = c.passes.get(name, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class walk(TorchDispatchMode):
    """Walk what runs inside ``with walk(mesh=...) as w:``; ``w.costs``
    holds the :class:`Costs` after the block. ``mesh`` (a ``Mesh`` or an
    ``AbstractMesh``) gives the collectives: its counts over the block.
    ``device`` (a device type, e.g. "cuda" or "meta") counts only the
    tensors on it: a step's cost on the card leaves out the host's small
    tensors (the RNG states a checkpoint saves on the card's behalf)."""

    def __init__(self, mesh=None, device=None):
        super().__init__()
        self.mesh = mesh
        self.device = None if device is None else torch.device(device).type
        self.costs = Costs()
        self._live = 0
        self._peak = 0
        self._tracked: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._mesh0 = None

    # ----------------------------------------------------------- lifecycle
    def __enter__(self):
        # re-entered from its own dispatch (a composite op's parts): only
        # the outermost entry and exit keep the books
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth == 1:
            if self.mesh is not None:
                self._mesh0 = self.mesh.axis_bytes()
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                _ACTIVE.remove(self)
                self._add_mesh(self.costs, self._mesh_delta())
                self.costs.peak_bytes = self._peak

    def _mesh_delta(self) -> Dict[Tuple[str, Tuple[str, ...]], int]:
        if self.mesh is None:
            return {}
        before, now = self._mesh0, self.mesh.axis_bytes()
        return {k: n - before.get(k, 0) for k, n in now.items()}

    @staticmethod
    def _add_mesh(c: Costs, delta) -> None:
        for (op, axes), n in delta.items():
            if n:
                n = 2 * n if op in _ALL_REDUCE else n
                c.coll_bytes += n
                c.coll_by_kind["all-reduce" if op in _ALL_REDUCE
                               else "all-gather"] += n
                c.coll_by_axis[",".join(axes)] += n

    def _snapshot(self) -> Costs:
        out = self.costs.counts()
        self._add_mesh(out, self._mesh_delta())
        return out

    # ------------------------------------------------------------- ops
    def _kernel(self, name: str, nbytes: float, ops: float, matmul: bool):
        c = self.costs
        c.bytes += nbytes
        if matmul:
            c.flops += ops
        k = c.kernels[name]
        k["calls"] += 1
        k["bytes"] += nbytes
        k["ops"] += ops

    def _counts(self, t) -> bool:
        return isinstance(t, torch.Tensor) and (
            self.device is None or t.device.type == self.device)

    def _track(self, st) -> None:
        key, n = id(st), st.nbytes()
        with self._lock:
            self._tracked[key] = n
            self._live += n
            self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self._live -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # a composite op reaches the mode whole where autograd is off
            # (inference mode): walk what it is made of, as with grad on
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = [t for t in tree_leaves((args, kwargs)) if self._counts(t)]
        outs = [t for t in tree_leaves(out) if self._counts(t)]
        if not ins and not outs:
            return out
        c = self.costs
        formula = _flop_counter.flop_registry.get(packet)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            c.flops += f
            c.dot_flops_by_shape[str(tuple(outs[0].shape)) if outs else ""] += f
        if not func.is_view and packet not in _FREE:
            skip = set()
            if packet in _WRITE_ONLY and args:
                skip.add(id(args[0]))
            if isinstance(kwargs.get("out"), torch.Tensor):
                skip.add(id(kwargs["out"]))
            c.bytes += sum(_nbytes(t) for t in ins if id(t) not in skip)
            c.bytes += sum(_nbytes(t) for t in outs)
        if outs:
            seen = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                st = t.untyped_storage()
                if id(st) not in seen and id(st) not in self._tracked:
                    seen.add(id(st))
                    self._track(st)
        return out

