"""Serving tier of the port: the continuous-batching ``ProjectionEngine``."""
