"""Observability for the port: the stdlib metrics registry, the in-step
bridge (``bridge``, the counterpart of ``repro.obs.jax_bridge``) and the
``proj/*`` profiler scopes."""
from .metrics import (Counter, Gauge, Histogram, Registry,  # noqa: F401
                      get_registry, set_registry, timed)
from . import bridge, metrics, profile  # noqa: F401

REGISTRY = metrics.REGISTRY
