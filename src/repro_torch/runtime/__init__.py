"""repro_torch.runtime — checkpointing, fault tolerance and the
double-descent schedule (port of ``repro/runtime``)."""
from .checkpoint import CheckpointManager  # noqa: F401
from .double_descent import double_descent  # noqa: F401
from .resilience import (  # noqa: F401
    HeartbeatFile, StragglerMonitor, StragglerReport, run_with_restarts,
)
