"""repro_torch.runtime — checkpointing and fault tolerance (port of
``repro/runtime``; ``double_descent`` waits for the §7.3 slice)."""
from .checkpoint import CheckpointManager  # noqa: F401
from .resilience import (  # noqa: F401
    HeartbeatFile, StragglerMonitor, StragglerReport, run_with_restarts,
)
