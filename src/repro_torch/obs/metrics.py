"""Metrics core: counters, gauges, fixed-bucket histograms — stdlib only.

Model (a deliberately tiny subset of the Prometheus data model):

* a :class:`Registry` owns metric *families*; a family has a name, a help
  string, and a fixed tuple of label names;
* ``family.labels(key=value, ...)`` returns the child for one label
  combination (created on first use, cached); a family with no label names
  IS its own child, so ``registry.counter("x").inc()`` just works;
* every mutation takes the registry's single lock — counters are exact
  under concurrency by construction (the serving dispatcher, the plan
  warm pool, and test hammers all write from their own threads);
* :meth:`Registry.snapshot` renders everything to nested plain dicts, and
  the two exporters (:meth:`Registry.to_jsonl`,
  :meth:`Registry.to_prometheus`) are pure functions of that snapshot.

Histograms are fixed-bucket (cumulative counts per upper bound, plus sum
and count), so ``observe()`` is O(#buckets) with no allocation — cheap
enough for the serving hot path — and :meth:`Histogram.quantile` gives the
standard bucket-interpolated estimate that ``ProjectionEngine.stats()``
reports p50/p99 from.

>>> from repro_torch.obs import metrics
>>> reg = metrics.Registry()
>>> c = reg.counter("requests_total", "handled requests", labels=("route",))
>>> c.labels(route="submit").inc()
>>> c.labels(route="submit").inc(2)
>>> reg.snapshot()["requests_total"]["values"]
[{'labels': {'route': 'submit'}, 'value': 3}]
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

# default latency buckets (seconds): 100µs .. 30s, roughly ×3 apart —
# wide enough for CPU test runs, tight enough for p99 estimates
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
                   10.0, 30.0)

LabelValues = Tuple[str, ...]


class _Child:
    """One (family, label-values) series. Base for the three metric kinds."""

    __slots__ = ("_lock", "labelvalues")

    def __init__(self, lock: threading.Lock, labelvalues: LabelValues):
        self._lock = lock
        self.labelvalues = labelvalues


class Counter(_Child):
    """Monotonic counter: ``inc(n)`` with n >= 0."""

    __slots__ = ("_value",)

    def __init__(self, lock, labelvalues):
        super().__init__(lock, labelvalues)
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Child):
    """Point-in-time value: ``set(v)`` / ``add(d)``."""

    __slots__ = ("_value",)

    def __init__(self, lock, labelvalues):
        super().__init__(lock, labelvalues)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, d: float) -> None:
        with self._lock:
            self._value += float(d)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    """Fixed-bucket histogram: cumulative bucket counts + sum + count."""

    __slots__ = ("buckets", "_counts", "_sum", "_count")

    def __init__(self, lock, labelvalues, buckets: Sequence[float]):
        super().__init__(lock, labelvalues)
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, ub in enumerate(self.buckets):  # noqa: B007
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 <= q <= 1).

        Returns 0.0 for an empty histogram. Values past the last bucket
        clamp to the last finite upper bound (the usual Prometheus
        ``histogram_quantile`` behaviour).
        """
        with self._lock:
            counts, total = list(self._counts), self._count
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0.0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            if seen + counts[i] >= rank:
                frac = 0.0 if counts[i] == 0 else (rank - seen) / counts[i]
                return lo + frac * (ub - lo)
            seen += counts[i]
            lo = ub
        return self.buckets[-1] if self.buckets else 0.0


class _Family:
    """A named metric family: labels -> child registry."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...], lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self.buckets = tuple(buckets) if buckets is not None else None
        self._lock = lock
        self._children: Dict[LabelValues, _Child] = {}
        if not labelnames:
            self._default = self._make(())
            self._children[()] = self._default

    def _make(self, labelvalues: LabelValues) -> _Child:
        if self.kind == "counter":
            return Counter(self._lock, labelvalues)
        if self.kind == "gauge":
            return Gauge(self._lock, labelvalues)
        return Histogram(self._lock, labelvalues, self.buckets)

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}")
        values = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make(values)
                self._children[values] = child
        return child

    # ---- label-free convenience: the family proxies its default child ----
    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._default

    def inc(self, n: float = 1):
        self._default_child().inc(n)

    def set(self, v: float):
        self._default_child().set(v)

    def add(self, d: float):
        self._default_child().add(d)

    def observe(self, v: float):
        self._default_child().observe(v)

    @property
    def value(self):
        return self._default_child().value

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)

    def children(self) -> Iterable[_Child]:
        with self._lock:
            return list(self._children.values())


class Registry:
    """Holds metric families; one lock guards every mutation (exactness
    beats micro-contention at the rates projection serving runs at)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, name: str, help: str, kind: str,
                       labels: Tuple[str, ...],
                       buckets: Optional[Sequence[float]] = None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}")
                return fam
            fam = _Family(name, help, kind, labels, threading.Lock(), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, help, "counter", tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, help, "gauge", tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._get_or_create(name, help, "histogram", tuple(labels),
                                   buckets)

    def clear(self) -> None:
        """Drop every family (tests / bench isolation)."""
        with self._lock:
            self._families.clear()

    # ------------------------------------------------------------ export

    def snapshot(self) -> Dict[str, dict]:
        """Nested plain-dict view of every series (JSON-serializable)."""
        with self._lock:
            families = list(self._families.values())
        out: Dict[str, dict] = {}
        for fam in families:
            values = []
            for child in fam.children():
                labels = dict(zip(fam.labelnames, child.labelvalues))
                if fam.kind == "histogram":
                    with child._lock:
                        counts = list(child._counts)
                        s, n = child._sum, child._count
                    values.append({"labels": labels,
                                   "buckets": list(fam.buckets),
                                   "counts": counts, "sum": s, "count": n})
                else:
                    values.append({"labels": labels, "value": child.value})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "values": values}
        return out

    def to_jsonl(self) -> str:
        """One JSON object per line: ``{"name", "kind", "labels", ...}``."""
        lines = []
        for name, fam in sorted(self.snapshot().items()):
            for v in fam["values"]:
                row = {"name": name, "kind": fam["kind"]}
                row.update(v)
                lines.append(json.dumps(row, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        buf = io.StringIO()
        for name, fam in sorted(self.snapshot().items()):
            if fam["help"]:
                buf.write(f"# HELP {name} {fam['help']}\n")
            buf.write(f"# TYPE {name} {fam['kind']}\n")
            for v in fam["values"]:
                if fam["kind"] == "histogram":
                    cum = 0
                    for ub, cnt in zip(v["buckets"] + [float("inf")],
                                       v["counts"]):
                        cum += cnt
                        le = "+Inf" if ub == float("inf") else repr(ub)
                        lbl = _fmt_labels({**v["labels"], "le": le})
                        buf.write(f"{name}_bucket{lbl} {cum}\n")
                    lbl = _fmt_labels(v["labels"])
                    buf.write(f"{name}_sum{lbl} {v['sum']}\n")
                    buf.write(f"{name}_count{lbl} {v['count']}\n")
                else:
                    lbl = _fmt_labels(v["labels"])
                    buf.write(f"{name}{lbl} {v['value']}\n")
        return buf.getvalue()


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


@contextlib.contextmanager
def timed(hist, **labels):
    """Time a block into a histogram (seconds): ``with timed(h): work()``.

    ``hist`` is a histogram family or child; keyword labels select the
    child. The observation happens even when the block raises — a failing
    dispatch still took the time it took.
    """
    child = hist.labels(**labels) if labels else hist
    t0 = time.perf_counter()
    try:
        yield
    finally:
        child.observe(time.perf_counter() - t0)


# process-global default registry — what the serving engine, the planner,
# the training telemetry, and the benchmarks all record into unless handed
# an explicit one
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


def set_registry(reg: Registry) -> Registry:
    """Swap the process-global registry (tests); returns the previous one."""
    global REGISTRY
    prev, REGISTRY = REGISTRY, reg
    return prev
