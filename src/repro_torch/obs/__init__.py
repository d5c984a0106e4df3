"""Observability for the port: the stdlib metrics registry and the
``proj/*`` profiler scopes."""
