"""repro_torch.roofline — the cost walk of a step (``costs``), its roofline
with the H100's terms (``analysis``), and the dry run's tables (``report``,
``fill_experiments``): port of ``repro/roofline``."""
from .analysis import (  # noqa: F401
    HBM_BW, NIC_BW, NVLINK_BW, PEAK_FLOPS, Roofline, analyze, model_flops,
)
