"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each bound
with ``ctypes`` (``_build``) and wrapped beside its plain PyTorch version
(``l1ball``, ``codegen.lowering``, ``bilevel_l1inf``,
``trilevel_l1infinf``, ``flash_attention``).

``codegen`` compiles any schedule to the generated pipeline; the
hand-written ``bilevel_l1inf`` / ``trilevel_l1infinf`` kernels are the golden
references that pin it, as in the JAX package.
"""

from .bilevel_l1inf import bilevel_l1inf_fused, clip, colmax  # noqa: F401
from .l1ball import KERNEL_METHODS, project_l1  # noqa: F401
from .trilevel_l1infinf import trilevel_l1infinf_fused  # noqa: F401
