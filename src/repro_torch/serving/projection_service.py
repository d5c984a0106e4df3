"""Synchronous flush()-driven projection batching, the legacy serving flow
(port of ``repro/serving/projection_service.py``).

A request is one tensor + norm design + radius. The service groups pending
requests whose *plan key* matches (same shape, dtype, canonical levels and
backend), stacks each group along a fresh leading axis, and runs it with
ONE planner batch plan (``radius_kind="batch"``, one radius per request).
Heterogeneous traffic costs one dispatch per distinct workload shape
instead of one per request. A group is padded to the next power of two
with copies of its last request before stacking, so varying traffic sees
O(log max-group) distinct batch shapes.

Nothing executes until a caller invokes ``flush()``, so under live traffic
every request waits for its bucket. New code should use
:class:`repro_torch.serving.engine.ProjectionEngine`: the same plan-key
grouping with continuous batching, in-place buckets, a plan warm pool and
admission control. This class stays as the simple synchronous building
block: no threads, explicit flush.

A singleton group runs the single-item plan. A batch-native backend
(``codegen_batch``) takes stacked buckets only, so its requests are
validated as a batch key and a singleton of one runs the batch plan as a
bucket of one, as both packages' engines do. (The JAX service validates
every request as a single-item key, so it refuses a batch-native method at
``submit`` whatever the group.) A torch tensor carries no sharding, so the
service serves single-device traffic: JAX's sharded plan key has no
counterpart here.

    svc = ProjectionService()                       # on the card; method="auto"
    t1 = svc.submit(w1, [("inf", 1), ("1", 1)], radius=1.0)
    t2 = svc.submit(w2, [("inf", 1), ("1", 1)], radius=2.0)   # same shape: batched
    t3 = svc.submit(w3, [("1", 1)], radius=1.0)                # own group
    svc.flush()
    x1 = svc.result(t1)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import _device
from repro_torch.core import plan as planmod, schedule

# (shape, dtype name, canonical levels, requested method)
GroupKey = Tuple[Tuple[int, ...], str, Tuple[Tuple[str, int], ...], str]


def _bucket(n: int) -> int:
    """Next power of two >= n."""
    return 1 << (n - 1).bit_length()


class ProjectionService:
    """Batches projection requests by plan key and runs each group as one
    batch plan call.

    ``device``: ``"cuda"`` (the default; raises without a card) or
    ``"cpu"``. ``method`` is the default backend for every submit
    (``"auto"`` autotunes per workload); a per-request ``method=``
    overrides it, and requests with different backends never share a batch.
    """

    def __init__(self, *, method: str = planmod.AUTO, device=None):
        self.device = _device.resolve(device)
        self.default_method = method
        self._pending: Dict[GroupKey, List[Tuple[int, torch.Tensor,
                                                 torch.Tensor]]] = {}
        self._results: Dict[int, torch.Tensor] = {}
        self._next_ticket = 0
        self.stats = {"submitted": 0, "executed_batches": 0,
                      "batched_requests": 0, "flushes": 0}

    def submit(self, y, levels, radius=1.0, *,
               method: Optional[str] = None) -> int:
        """Queue one projection; returns a ticket for :meth:`result`. ``y``
        is copied to the service's device when it lies elsewhere. A bad
        design, backend or radius raises ``ValueError`` here, where the
        caller can handle it: a raise inside ``flush()`` would stop a whole
        batch for one bad ticket."""
        y = torch.as_tensor(y, device=self.device)
        levels = planmod.canonical_levels(levels)
        schedule.check_levels(tuple(y.shape), levels)
        requested = self.default_method if method is None else method
        kind = "batch" if planmod.is_batch_native(requested) else "scalar"
        requested = planmod.validate_backend(
            y.shape, y.dtype, levels, requested, device=self.device.type,
            radius_kind=kind)
        radius = torch.as_tensor(radius, dtype=y.dtype, device=self.device)
        if radius.ndim != 0:
            raise ValueError(
                f"radius must be a scalar (one per request), got shape "
                f"{tuple(radius.shape)}")
        key: GroupKey = (tuple(y.shape), planmod.dtype_name(y.dtype), levels,
                         requested)
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.setdefault(key, []).append((ticket, y, radius))
        self.stats["submitted"] += 1
        return ticket

    def pending(self) -> int:
        """Number of queued (unflushed) requests."""
        return sum(len(v) for v in self._pending.values())

    def flush(self) -> None:
        """Run every pending group: one batch plan call per group of two or
        more (and per batch-native singleton), the single-item plan for
        any other singleton. A group that raises stays queued, its tickets
        retryable; groups already run in this flush stay run."""
        dev = self.device.type
        for key in list(self._pending):
            (shape, dtype, levels, method), reqs = key, self._pending.pop(key)
            try:
                if len(reqs) == 1 and not planmod.is_batch_native(method):
                    ticket, y, radius = reqs[0]
                    p = planmod.make_plan(shape, dtype, levels, method=method,
                                          device=dev)
                    self._results[ticket] = p(y, radius)
                else:
                    p = planmod.make_plan(shape, dtype, levels,
                                          radius_kind="batch", method=method,
                                          device=dev)
                    pad = _bucket(len(reqs)) - len(reqs)
                    ys = torch.stack([y for _, y, _ in reqs]
                                     + [reqs[-1][1]] * pad)
                    radii = torch.stack([r for _, _, r in reqs]
                                        + [reqs[-1][2]] * pad)
                    out = p(ys, radii)
                    for i, (ticket, _, _) in enumerate(reqs):
                        self._results[ticket] = out[i]
                    if len(reqs) > 1:
                        self.stats["batched_requests"] += len(reqs)
            except Exception:
                # the failed group stays queued (its tickets stay retryable)
                self._pending[key] = reqs
                raise
            self.stats["executed_batches"] += 1
        self.stats["flushes"] += 1

    def result(self, ticket: int) -> torch.Tensor:
        """Projected tensor for a flushed ticket, read once: the result is
        removed on return. KeyError for an unknown, unflushed or
        already-claimed ticket."""
        return self._results.pop(ticket)

    def discard(self, ticket: int) -> None:
        """Drop a flushed result that will never be claimed (no-op if
        absent): unclaimed results are otherwise held indefinitely."""
        self._results.pop(ticket, None)

    def project(self, y, levels, radius=1.0, *,
                method: Optional[str] = None) -> torch.Tensor:
        """submit + flush + result in one call."""
        ticket = self.submit(y, levels, radius, method=method)
        self.flush()
        return self.result(ticket)
