"""repro_torch.configs — architecture registry + config dataclasses (port of
``repro/configs``)."""
from .registry import ARCHS, ASSIGNED, get_arch, smoke_config  # noqa: F401
from .types import (  # noqa: F401
    ArchConfig, HybridConfig, MLAConfig, MoEConfig, ProjectionSpec, SHAPES,
    ShapeConfig, SSMConfig, TrainConfig, XLSTMConfig,
)
