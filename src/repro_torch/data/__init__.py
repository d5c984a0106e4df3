"""repro_torch.data — deterministic shardable pipelines, the paper's datasets
and activation harvesting (port of ``repro/data``)."""
from .pipeline import (  # noqa: F401
    DataConfig, DataPipeline, TokenFileReader, classification_synthetic,
    lung_like,
)
from .activations import (  # noqa: F401
    ActivationReader, HarvestConfig, harvest, read_meta,
)
