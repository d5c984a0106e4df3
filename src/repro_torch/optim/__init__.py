"""repro_torch.optim — AdamW, the projection hook and the fused projected
step (port of ``repro/optim``)."""

from .adamw import global_norm, init, lr_schedule, update  # noqa: F401
from .projection_hook import (  # noqa: F401
    apply_projection,
    make_projection_hook,
    project_tree,
    tree_sparsity,
)
