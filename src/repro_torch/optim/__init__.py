"""repro_torch.optim — AdamW (float32 or int8 block-quantized moments),
the projection hook and the fused projected step (port of
``repro/optim``)."""

from .adamw import (  # noqa: F401
    dequantize_blockwise,
    global_norm,
    init,
    lr_schedule,
    quantize_blockwise,
    state_specs,
    update,
)
from .projection_hook import (  # noqa: F401
    apply_projection,
    make_projection_hook,
    project_tree,
    tree_sparsity,
)
