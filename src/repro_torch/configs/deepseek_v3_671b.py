"""--arch deepseek-v3-671b — the port's copy; see registry.py for the full definition."""

from .registry import get_arch, smoke_config

ARCH_ID = "deepseek-v3-671b"
CONFIG = get_arch(ARCH_ID)
SMOKE = smoke_config(ARCH_ID)
