"""--arch h2o-danube-1.8b — the port's copy; see registry.py for the full definition."""

from .registry import get_arch, smoke_config

ARCH_ID = "h2o-danube-1.8b"
CONFIG = get_arch(ARCH_ID)
SMOKE = smoke_config(ARCH_ID)
