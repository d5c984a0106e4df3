"""Projection core of the port: θ-solvers and norm balls (``ball``), the
schedule IR (``schedule``), bi-/multi-level projections (``bilevel``,
``multilevel``), the planner (``plan``), the mesh executor (``sharded``),
structured-sparsity masks (``masks``) and the exact ℓ1,∞ baseline
(``exact_l1inf``). The names are the JAX package's ``repro.core`` exports.
Importing this package pulls in no kernel module: the planner registers the
kernel backends on first use."""

from .ball import (  # noqa: F401
    available_methods,
    ball_norm,
    canonical_norm,
    method_info,
    norm_reduce,
    project_ball,
    project_grouped,
    project_l1,
    project_l1_bisect,
    project_l1_filter,
    project_l1_sort,
    project_l2,
    project_linf,
    project_simplex,
    register_l1_method,
    resolve_method,
)
from .bilevel import (  # noqa: F401
    bilevel_l11,
    bilevel_l12,
    bilevel_l1inf,
    bilevel_l21,
    bilevel_project,
    bilevel_project_axes,
)
from .exact_l1inf import (  # noqa: F401
    l1inf_norm,
    project_l1inf_exact,
    project_l1inf_exact_bisect,
)
from .masks import apply_mask, column_mask, element_sparsity, mask_tree, sparsity  # noqa: F401
from .plan import (  # noqa: F401
    PlanBackend,
    ProjectionPlan,
    best_l1_method,
    make_plan,
    register_plan_backend,
)
from .multilevel import (  # noqa: F401
    multilevel_norm,
    multilevel_project,
    trilevel_l111,
    trilevel_l1infinf,
    work_depth,
)
from .schedule import (  # noqa: F401
    ApplyGroup,
    OuterSolve,
    ReduceLevel,
    Schedule,
    compile_schedule,
)
from .sharded import (  # noqa: F401
    bilevel_project_sharded,
    make_schedule_body,
    make_sharded_bilevel,
    make_sharded_trilevel,
    multilevel_project_sharded,
    sharded_collective_bytes,
    trilevel_project_sharded,
)
