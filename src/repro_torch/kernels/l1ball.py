"""ℓ1-ball projection of a batch of vectors: the θ-solve of the generated
pipeline (port of ``repro/kernels/l1ball.py``).

:func:`project_l1_batched` projects every row of ``v`` (B, n) onto its own
ℓ1 ball, float32 or bf16. On a CUDA tensor it launches ``csrc/l1ball.cu``:
the ``l1ball`` kernel (one CTA per row, the row in registers up to 2048
values and in shared memory up to ``L1_ONE_CTA_MAX`` = 51,200) or, for
longer rows up to ``L1_KERNEL_MAX`` = 524,288 (JAX's single-block limit),
the ``l1ball_cluster`` kernel (a thread block cluster per row, the row in
the shared memory of its CTAs). bf16 is read into float32, the radius
rounded to bf16 first, the solve run in float32 and the output rounded to
bf16 once. On a CPU tensor it runs :func:`project_l1_plain`, the same two
algorithms in PyTorch ops:

* ``bisect`` — at most 64 bisection steps on θ over [0, max|v|] (the kernel
  stops at the float fixed point, where further steps leave θ as it is,
  and evaluates φ for two steps per block reduction);
* ``filter`` — Michelot/Condat fixed point, at most n + 2 sweeps.

Both return θ = 0 inside the ball (the ball contract of ``core.ball``).

:func:`project_l1` is the single-vector form (B = 1; a number radius goes to
the kernel by value, with no copy to the device) and :func:`outer_l1_solve`
the golden pipelines' outer θ-solve, routed by method as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.roofline import costs as _costs

from . import _build
from .codegen.tiling import L1_KERNEL_MAX, L1_ONE_CTA_MAX

_ITERS = 64
KERNEL_METHODS = ("bisect", "filter")
# the JAX package's single-block VMEM limit (its L1_KERNEL_MAX): longer
# vectors take the PyTorch-ops route in outer_l1_solve there and here
REF_ROUTE_ABOVE = 512 * 1024
_METHOD_CODES = {"bisect": 0, "filter": 1}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [_build.PTR, _build.PTR, _build.FLOAT, _build.PTR] + [_build.INT] * 5 \
    + [_build.PTR]
KERNEL = _build.Kernel("l1ball", {"l1ball_project": _ARGS})
# rows past L1_ONE_CTA_MAX: the same source, counted apart
CLUSTER_KERNEL = _build.Kernel(
    "l1ball_cluster", {"l1ball_cluster_project": _ARGS}, source="l1ball")


def _iters(method: str, n: int) -> int:
    # filter terminates in <= n sweeps; bisect needs its fixed budget
    return n + 2 if method == "filter" else _ITERS


def project_l1_plain(v: torch.Tensor, radii: torch.Tensor,
                     method: str = "bisect") -> torch.Tensor:
    """The plain PyTorch version of the kernel, row by row identical in
    algorithm (the sums run in another order). A bf16 ``v`` is solved as
    the kernel solves it: |v| in float32, the radius rounded to bf16 first,
    the output rounded to bf16 once."""
    out_dtype = v.dtype
    if v.dtype == torch.bfloat16:
        radii = radii.to(v.dtype).float()
        v = v.float()
    a = v.abs()
    r = radii[:, None]
    s0 = a.sum(dim=1, keepdim=True)
    inside = s0 <= r
    if method == "bisect":
        lo = torch.zeros_like(s0)
        hi = a.amax(dim=1, keepdim=True)
        for _ in range(_ITERS):
            mid = 0.5 * (lo + hi)
            too_small = torch.clamp(a - mid, min=0.0).sum(dim=1, keepdim=True) > r
            lo = torch.where(too_small, mid, lo)
            hi = torch.where(too_small, hi, mid)
        theta = 0.5 * (lo + hi)
    else:
        n = a.shape[1]
        theta = (s0 - r) / n
        count = torch.full_like(s0, n, dtype=torch.int64)
        changed = torch.ones_like(s0, dtype=torch.bool)
        it = 0
        while bool(changed.any()) and it < _iters(method, n):
            active = a > theta
            new_count = active.sum(dim=1, keepdim=True)
            ssum = torch.where(active, a, torch.zeros_like(a)).sum(dim=1, keepdim=True)
            new_theta = torch.where(
                new_count > 0, (ssum - r) / torch.clamp(new_count, min=1).to(a.dtype),
                theta)
            theta = torch.where(changed, new_theta, theta)
            still = (new_count != count) & (new_count > 0)
            count = torch.where(changed, new_count, count)
            changed = changed & still
            it += 1
        theta = torch.clamp(theta, min=0.0)
    theta = torch.where(inside, torch.zeros_like(theta), theta)
    return (torch.sign(v) * torch.clamp(a - theta, min=0.0)).to(out_dtype)


def _check_method(method: str) -> None:
    if method not in KERNEL_METHODS:
        raise ValueError(
            f"no l1ball kernel for method {method!r}; available: "
            f"{list(KERNEL_METHODS)}")


def _check_dtype(v: torch.Tensor) -> None:
    if v.dtype not in _DTYPE_CODES:
        raise ValueError(f"l1ball takes float32 or bfloat16, got {v.dtype}")


def _check(v: torch.Tensor, radii: torch.Tensor, method: str) -> None:
    _check_method(method)
    if v.ndim != 2 or radii.shape != (v.shape[0],):
        raise ValueError(
            f"l1ball takes v (B, n) and radii (B,), got {tuple(v.shape)} and "
            f"{tuple(radii.shape)}")
    _check_dtype(v)
    if radii.dtype not in (torch.float32, v.dtype):
        raise ValueError(f"l1ball takes radii in float32 or v's type, got "
                         f"{radii.dtype} for {v.dtype}")
    if radii.get_device() != v.get_device():  # no torch.device built
        raise ValueError("v and radii must lie on one device")


def _launch(v: torch.Tensor, b: int, n: int, radii: torch.Tensor | None,
            radius: float, method: str, out: torch.Tensor | None
            ) -> torch.Tensor:
    """Launch a kernel on ``b`` rows of ``n`` values of ``v`` (any shape of
    ``b · n`` values): radius ``radii[i]`` for row i, or ``radius`` for every
    row when ``radii`` is None. ``l1ball`` up to ``L1_ONE_CTA_MAX`` values,
    ``l1ball_cluster`` beyond. Autograd may not record the call: the
    kernels have no backward of their own (the generated pipeline's
    Function calls them with grad mode off)."""
    _device.require_cuda(v, "l1ball")
    if v.requires_grad or (radii is not None and radii.requires_grad):
        _device.refuse_grad("l1ball", v, radii)
    if not 1 <= n <= L1_KERNEL_MAX:
        raise ValueError(f"l1ball takes 1 <= n <= {L1_KERNEL_MAX}, got n={n}")
    if not (v.is_contiguous() and (radii is None or radii.is_contiguous())):
        raise ValueError("l1ball takes contiguous v and radii")
    if out is None:
        out = torch.empty_like(v)
    elif out.shape != v.shape or out.dtype != v.dtype or not out.is_contiguous() \
            or out.get_device() != v.get_device():
        raise ValueError("out must be a contiguous tensor like v")
    if radii is not None and radii.dtype != torch.float32:
        radii = radii.float()  # bf16 radii are exact in float32
    if n <= L1_ONE_CTA_MAX:
        kernel, fn = KERNEL, "l1ball_project"
    else:
        kernel, fn = CLUSTER_KERNEL, "l1ball_cluster_project"
    if _costs.active() and _costs.declare(
            kernel, v, *_costs.l1ball(b, n, v.element_size())):
        return out
    kernel.launch(fn, v.data_ptr(), _build.ptr(radii), radius, out.data_ptr(),
                  b, n, _METHOD_CODES[method], _iters(method, n),
                  _DTYPE_CODES[v.dtype], _build.stream_handle(v))
    return out


def project_l1_batched(v: torch.Tensor, radii: torch.Tensor, *,
                       method: str = "bisect",
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Project each row of ``v`` (B, n) onto the ℓ1 ball of its radius.

    CUDA tensor: the ``l1ball`` kernel, writing into ``out`` (allocated when
    None; may be ``v`` itself). CPU tensor: :func:`project_l1_plain`.
    """
    _check(v, radii, method)
    if v.is_cpu:
        x = project_l1_plain(v, radii, method)
        return x if out is None else out.copy_(x)
    return _launch(v, *v.shape, radii, 0.0, method, out)


def project_l1(v: torch.Tensor, radius, *, method: str = "bisect") -> torch.Tensor:
    """Project one vector ``v`` (n,) onto the ℓ1 ball of ``radius``: the
    batched kernel (or its plain version on a CPU tensor) with B = 1.

    ``method`` is "bisect" or "filter"; a CUDA vector over
    ``L1_KERNEL_MAX`` values raises (the kernels keep it on chip). A number
    radius reaches the kernel by value (rounded to float32, then to v's
    type), so the call copies nothing to the device; a tensor radius is read
    there.
    """
    if v.ndim != 1:
        raise ValueError(f"project_l1 takes a vector, got {tuple(v.shape)}")
    if v.is_cpu or isinstance(radius, torch.Tensor):
        radii = torch.as_tensor(radius, dtype=v.dtype, device=v.device).reshape(1)
        return project_l1_batched(v[None], radii, method=method)[0]
    _check_method(method)
    _check_dtype(v)
    return _launch(v, 1, v.shape[0], None, float(radius), method, None)


def outer_l1_solve(v: torch.Tensor, radius, *, method: str = "bisect"
                   ) -> torch.Tensor:
    """The golden pipelines' outer θ-solve on the column aggregate ``v``
    (m,), routed as JAX's ``outer_l1_solve``: a kernel method ("bisect",
    "filter") runs :func:`project_l1`, any other method, or a vector over
    ``REF_ROUTE_ABOVE`` values, the ``core.ball`` solver in PyTorch ops on
    ``v``'s device. ``L1_KERNEL_MAX`` is ``REF_ROUTE_ABOVE``: every length a
    kernel method sends to JAX's kernel runs one of the port's."""
    if v.shape[0] <= REF_ROUTE_ABOVE and method in KERNEL_METHODS:
        return project_l1(v, radius, method=method)
    from .ref import project_l1_ref
    return project_l1_ref(v, radius, method=method)
