"""In-step bridge: values computed on the device during a step flow into
the registry without a sync (counterpart of ``repro/obs/jax_bridge.py``;
the name drops ``jax`` because the port never imports it).

A projected train step knows things worth observing that exist only on
the device (the loss, the feasibility gap after projection, the support
of the projected weights), but reading them with ``float(x)`` waits for
the device on the hot path. :func:`report` instead copies a CUDA value
``non_blocking`` into a pinned host scalar behind the step's work and
records a ``torch.cuda.Event``; the value folds into the process-global
registry once its event has completed, at the next :func:`report` or
:func:`mark`, or at :func:`drain`, which waits for everything pending (the
counterpart of ``jax.effects_barrier()``). A CPU value or a number folds
at once.

The bridge is **gated off by default**: with the gate off, ``report`` and
``mark`` return before touching their argument, so an instrumented step
issues exactly the operations and launches of one without the calls.
:func:`enable` or :func:`enabled_scope` turn it on, as the launchers'
``--telemetry-every``/``--telemetry-marks`` do. The JAX package's gate also
reads ``REPRO_OBS_BRIDGE=1`` at import; the port reads no environment
variable, so nothing outside the call path changes what a step runs.

:func:`mark` pairs ``<stem>_start`` / ``<stem>_end`` into the
``<stem>_seconds`` histogram. Given a CUDA ``device`` it records an event
on that device's current stream at each end and observes
``elapsed_time``: the device time of the bracketed region in stream order.
Otherwise it reads ``perf_counter`` at each call, as the JAX package reads
the host arrival of its ordered callbacks.

    from repro_torch.obs import bridge

    bridge.enable()
    x = project(w)
    bridge.report("feasibility_gap", gap(x), kind="gauge")
    bridge.drain()
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Optional

import torch

from . import metrics

_ENABLED = False

_HELP = "bridged from inside the step (obs.bridge)"

_KINDS = ("gauge", "counter", "hist")

# values and mark pairs in flight on the card, in the order reported:
# ("value", event, pinned host tensor, name, kind, labels) or
# ("mark", end event, start event, stem, labels)
_pending: collections.deque = collections.deque()
_lock = threading.Lock()


def enabled() -> bool:
    """Whether :func:`report` and :func:`mark` do anything now."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def enabled_scope(on: bool = True):
    """Temporarily flip the gate: calls made inside see ``on``."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    try:
        yield
    finally:
        _ENABLED = prev


def _family(name: str, kind: str, labels: Optional[Dict[str, str]]):
    reg = metrics.get_registry()
    names = tuple(labels or ())
    if kind == "counter":
        fam = reg.counter(name, _HELP, labels=names)
    elif kind == "hist":
        fam = reg.histogram(name, _HELP, labels=names)
    else:
        fam = reg.gauge(name, _HELP, labels=names)
    return fam.labels(**labels) if labels else fam


def _record(name: str, kind: str, labels: Optional[Dict[str, str]],
            value) -> None:
    v = float(value)
    child = _family(name, kind, labels)
    if kind == "counter":
        child.inc(v)
    elif kind == "hist":
        child.observe(v)
    else:
        child.set(v)


def _fold(entry) -> None:
    if entry[0] == "value":
        _, _, host, name, kind, labels = entry
        _record(name, kind, labels, host)
    else:
        _, end, start, stem, labels = entry
        _family(f"{stem}_seconds", "hist", labels).observe(
            start.elapsed_time(end) / 1e3)


def _fold_ready(wait: bool = False) -> None:
    """Fold the completed head of the queue (everything with ``wait``)."""
    while True:
        with _lock:
            if not _pending:
                return
            entry = _pending[0]
            if not wait and not entry[1].query():
                return
            _pending.popleft()
        if wait:
            entry[1].synchronize()
        _fold(entry)


def drain() -> None:
    """Wait for every pending value and mark pair and fold it into the
    registry. Returns at once when nothing is pending."""
    _fold_ready(wait=True)


def report(name: str, value, *, kind: str = "gauge",
           labels: Optional[Dict[str, str]] = None) -> None:
    """Emit one scalar into the registry without a sync.

    ``kind`` is ``"gauge"`` (set), ``"counter"`` (inc by value) or
    ``"hist"`` (observe). A CUDA tensor folds once the copy that the call
    enqueues has landed (module docstring); a CPU tensor or a number folds
    now. No-op, before ``value`` is touched, when the bridge is off.
    """
    if not _ENABLED:
        return
    if kind not in _KINDS:
        raise ValueError(f"unknown bridge kind {kind!r}")
    labels = dict(labels) if labels else None
    _fold_ready()
    if isinstance(value, torch.Tensor) and value.is_cuda:
        v = value.detach()
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(v.device))
        with _lock:
            _pending.append(("value", ev, host, name, kind, labels))
        return
    _record(name, kind, labels, value)


def mark(name: str, *, labels: Optional[Dict[str, str]] = None,
         device=None) -> None:
    """A ``<stem>_start`` / ``<stem>_end`` marker bracketing a region of a
    step; the pair folds into the ``<stem>_seconds`` histogram. With a
    CUDA ``device`` the pair is two events on its current stream (device
    time in stream order), else two ``perf_counter`` readings. An
    unmatched end is dropped. No-op when the bridge is off.
    """
    if not _ENABLED:
        return
    if not (name.endswith("_start") or name.endswith("_end")):
        raise ValueError(
            f"mark name must end in _start or _end, got {name!r}")
    _fold_ready()
    _mark_record(name, dict(labels) if labels else None, device)


_pending_marks: Dict[str, object] = {}


def _mark_record(name: str, labels: Optional[Dict[str, str]],
                 device=None) -> None:
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda":
        now = torch.cuda.Event(enable_timing=True)
        now.record(torch.cuda.current_stream(dev))
    else:
        now = time.perf_counter()
    stem, _, edge = name.rpartition("_")
    key = stem + "|" + "|".join(
        f"{k}={v}" for k, v in sorted((labels or {}).items()))
    if edge == "start":
        _pending_marks[key] = now
        return
    t0 = _pending_marks.pop(key, None)
    if t0 is None:
        return  # unmatched end (e.g. the bridge enabled mid-step): drop it
    if isinstance(t0, float) != isinstance(now, float):
        raise ValueError(f"mark pair {stem!r}: start and end on different "
                         "devices")
    if isinstance(now, float):
        _family(f"{stem}_seconds", "hist", labels).observe(now - t0)
        return
    with _lock:
        _pending.append(("mark", now, t0, stem, labels))
