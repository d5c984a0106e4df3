"""--arch whisper-large-v3 — the port's copy; see registry.py for the full definition."""

from .registry import get_arch, smoke_config

ARCH_ID = "whisper-large-v3"
CONFIG = get_arch(ARCH_ID)
SMOKE = smoke_config(ARCH_ID)
