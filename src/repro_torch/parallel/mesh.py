"""A device mesh over ``torch.distributed`` ranks and its named-axis
collectives: the port's counterpart of ``jax.sharding.Mesh`` and of
``jax.lax.psum`` / ``pmax`` / ``all_gather`` / ``axis_index`` inside
``shard_map``.

Every rank runs the same program on its own shard (SPMD). A :class:`Mesh`
lays the world's ranks out row-major over named axes (``("data",
"model")``: rank = data · |model| + model, the layout ``jax.make_mesh``
gives host devices) and opens one process group per set of axes a
collective can span. A collective over axis names reduces among the ranks
that differ only in those axes' coordinates.

The caller initializes the default process group and picks its backend
(gloo for CPU ranks or several ranks on one card, NCCL for one rank per
card); the mesh picks nothing, and without an initialized group it raises —
a sharded call never runs quietly as one rank. ``torch.distributed``'s own
``init_device_mesh`` is not used: it puts rank r on ``cuda:r``, which a
machine with fewer cards than ranks does not have.

``all_gather`` is an ``all_reduce(SUM)`` of a zero-filled buffer in which
each rank writes its own slice: exact (x + 0 = x), and one code path for
every backend (gloo's ``all_gather`` refuses CUDA tensors).

Each collective counts its calls and bytes (:meth:`Mesh.counts`): an
all-reduce its tensor's bytes, an all-gather the gathered result's — the
payloads ``core.schedule.sharded_collective_bytes`` models.

:class:`AbstractMesh` is the same interface with no process group: its
collectives take and return ``meta`` tensors of the shapes a rank would
see, and count exactly as a :class:`Mesh` counts. It is how the dry run
(``launch/dryrun.py``) follows one rank of a production mesh of hundreds
of cards; a real tensor handed to it raises, so no sharded call ever runs
quietly as one rank.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]
OPS = ("psum", "pmax", "all_gather")


def require_process_group(what: str) -> None:
    """Raise unless ``torch.distributed``'s default process group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialized torch.distributed process group "
            "(dist.init_process_group with the world's size and this rank); "
            "a sharded call never runs as a single rank")


class Mesh:
    """Named axes over the world's ranks (row-major, last axis fastest).

    ``shape`` maps each axis name to its size, in mesh order, like
    ``jax.sharding.Mesh.shape``; their product must be the world size.
    ``device`` is where :meth:`broadcast_choice` keeps its one integer:
    this process's current CUDA device under NCCL, else the CPU.
    """

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        require_process_group("Mesh")
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {tuple(axis_names)} vs sizes {tuple(sizes)}")
        self.axis_names: Tuple[str, ...] = tuple(str(a) for a in axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks, the "
                             f"world {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.coords = rank_coords(self.rank, self.shape)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl" else torch.device("cpu"))
        # one group per non-empty set of axes of more than one rank, every
        # rank creating every group in the same order (dist.new_group is
        # collective over the world)
        self._groups: Dict[Tuple[str, ...], Optional[object]] = {}
        for k in range(1, len(self.axis_names) + 1):
            for subset in itertools.combinations(self.axis_names, k):
                span = math.prod(self.shape[a] for a in subset)
                if span == 1:
                    self._groups[subset] = None
                elif span == self.size:
                    self._groups[subset] = dist.group.WORLD
                else:
                    self._groups[subset] = self._new_line_group(subset)
        self.reset_counts()

    def _new_line_group(self, subset):
        """The group of ranks that share this rank's coordinates on every
        axis outside ``subset``; creates every such group in order."""
        mine = None
        rest = [a for a in self.axis_names if a not in subset]
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            ranks = [r for r in range(self.size)
                     if all(rank_coords(r, self.shape)[a] == c
                            for a, c in zip(rest, fixed))]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    # ---------------------------------------------------------------- axes
    def _entry(self, axes: Axes) -> Tuple[str, ...]:
        """The mesh axes of ``axes`` in the order given: a name, names, or
        names nested one level (a spec entry over several mesh axes)."""
        names = tuple(a for x in ((axes,) if isinstance(axes, str) else axes)
                      for a in ((x,) if isinstance(x, str) else x))
        for a in names:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not an axis of mesh {self.shape}")
        return names

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        names = self._entry(axes)
        return tuple(a for a in self.axis_names if a in names)

    def axis_index(self, name: Axes) -> int:
        """This rank's coordinate on axis ``name`` (``jax.lax.axis_index``);
        on several axes, row-major over them in the order given (a spec
        entry's)."""
        idx = 0
        for a in self._entry(name):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    # --------------------------------------------------------- collectives
    def reset_counts(self) -> None:
        self._calls = dict.fromkeys(OPS, 0)
        self._bytes = dict.fromkeys(OPS, 0)
        self._axis_bytes: Dict[Tuple[str, Tuple[str, ...]], int] = {}

    def counts(self) -> Dict[str, object]:
        """Collective calls and bytes since the last :meth:`reset_counts`:
        ``{"calls": n, "bytes": n, "by_op": {op: {"calls", "bytes"}}}``."""
        return {"calls": sum(self._calls.values()),
                "bytes": sum(self._bytes.values()),
                "by_op": {op: {"calls": self._calls[op], "bytes": self._bytes[op]}
                          for op in OPS}}

    def axis_bytes(self) -> Dict[Tuple[str, Tuple[str, ...]], int]:
        """The bytes of :meth:`counts` by op and by the mesh axes each
        collective spanned (in mesh order), ``{(op, axes): bytes}``: what
        the roofline prices at each link's rate (``roofline/analysis.py``)."""
        return dict(self._axis_bytes)

    def _count(self, op: str, t: torch.Tensor, names: Tuple[str, ...]) -> None:
        n = t.numel() * t.element_size()
        self._calls[op] += 1
        self._bytes[op] += n
        self._axis_bytes[op, names] = self._axis_bytes.get((op, names), 0) + n

    def _all_reduce(self, op: str, x: torch.Tensor, axes: Axes,
                    reduce_op) -> torch.Tensor:
        names = self._axes(axes)
        if not names:
            return x
        out = x.contiguous().clone()
        self._count(op, out, names)
        group = self._groups[names]
        if group is not None:
            dist.all_reduce(out, op=reduce_op, group=group)
        return out

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum of ``x`` over the ranks along ``axes`` (``jax.lax.psum``)."""
        return self._all_reduce("psum", x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Maximum of ``x`` over the ranks along ``axes`` (``jax.lax.pmax``)."""
        return self._all_reduce("pmax", x, axes, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, name: Axes, axis: int) -> torch.Tensor:
        """The ranks' ``x`` along mesh axis ``name`` concatenated on tensor
        axis ``axis`` in coordinate order (``jax.lax.all_gather(...,
        tiled=True)``); ``name`` may be a spec entry over several axes,
        gathered row-major over them."""
        names = self._axes(name)
        size, idx = self.axis_size(names), self.axis_index(name)
        axis = axis % x.ndim
        shape = list(x.shape)
        local = shape[axis]
        shape[axis] = local * size
        out = x.new_zeros(shape)
        out.narrow(axis, idx * local, local).copy_(x)
        self._count("all_gather", out, names)
        group = self._groups[names]
        if group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    def broadcast_choice(self, choices: Sequence[str],
                         pick: Callable[[], str]) -> str:
        """``pick()`` on rank 0 alone, its answer sent to every rank: how a
        timed choice (an autotune verdict) stays the same on all ranks, so
        that they go on issuing the same collectives. Not counted."""
        choices = list(choices)
        t = torch.zeros(1, dtype=torch.int64, device=self.device)
        if self.rank == 0:
            t[0] = choices.index(pick())
        dist.broadcast(t, src=0)
        return choices[int(t[0])]


class AbstractMesh(Mesh):
    """The :class:`Mesh` of ``sizes`` over ``axis_names`` seen from one
    rank (``coords``, every axis at 0 by default), with no process group:
    every collective checks that its tensor is a ``meta`` tensor, counts
    its call and bytes as :meth:`Mesh.counts` does, and returns a ``meta``
    tensor of the shape the real collective would give. A tensor on any
    other device raises."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 coords: Optional[Dict[str, int]] = None):
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {tuple(axis_names)} vs sizes {tuple(sizes)}")
        self.axis_names = tuple(str(a) for a in axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        coords = dict.fromkeys(self.axis_names, 0) if coords is None else dict(coords)
        if set(coords) != set(self.axis_names) or any(
                not 0 <= coords[a] < self.shape[a] for a in self.axis_names):
            raise ValueError(f"coords {coords} are not a rank of mesh {self.shape}")
        self.coords = {a: int(coords[a]) for a in self.axis_names}
        self.rank = 0
        for a in self.axis_names:
            self.rank = self.rank * self.shape[a] + self.coords[a]
        self.device = torch.device("meta")
        # no process group: every collective stops at its count
        self._groups = {subset: None for k in range(1, len(self.axis_names) + 1)
                        for subset in itertools.combinations(self.axis_names, k)}
        self.reset_counts()

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, coords={self.coords})"

    @staticmethod
    def _meta(x: torch.Tensor, what: str) -> None:
        if not isinstance(x, torch.Tensor) or x.device.type != "meta":
            where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(
                f"AbstractMesh.{what} takes meta tensors, got one on {where}: "
                "an abstract mesh has no ranks to reduce over, and a real "
                "tensor would run as one rank")

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        self._meta(x, "psum")
        return super().psum(x, axes)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        self._meta(x, "pmax")
        return super().pmax(x, axes)

    def all_gather(self, x: torch.Tensor, name: str, axis: int) -> torch.Tensor:
        self._meta(x, "all_gather")
        return super().all_gather(x, name, axis)

    def broadcast_choice(self, choices: Sequence[str],
                         pick: Callable[[], str]) -> str:
        """Rank 0's ``pick()`` (every abstract rank is this one)."""
        return pick()


def rank_coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Coordinates of world rank ``rank`` on a mesh of axis sizes ``shape``
    (row-major, last axis fastest)."""
    coords = {}
    for name in reversed(list(shape)):
        rank, coords[name] = divmod(rank, shape[name])
    return {name: coords[name] for name in shape}
