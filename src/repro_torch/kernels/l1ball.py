"""ℓ1-ball projection of a batch of vectors: the θ-solve of the generated
pipeline (port of ``repro/kernels/l1ball.py``).

:func:`project_l1_batched` projects every row of ``v`` (B, n) onto its own
ℓ1 ball. On a CUDA tensor it launches ``csrc/l1ball.cu`` (one CTA per row,
the row in registers up to 2048 values and in shared memory up to
``L1_KERNEL_MAX``); on a CPU tensor it runs :func:`project_l1_plain`, the
same two algorithms in PyTorch ops:

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
from .codegen.tiling import L1_KERNEL_MAX

_ITERS = 64
KERNEL_METHODS = ("bisect", "filter")
# the JAX package's single-block VMEM limit (its L1_KERNEL_MAX): longer
# vectors take the PyTorch-ops route in outer_l1_solve there and here
REF_ROUTE_ABOVE = 512 * 1024
_METHOD_CODES = {"bisect": 0, "filter": 1}

KERNEL = _build.Kernel("l1ball", {
    "l1ball_project": [_build.PTR, _build.PTR, _build.FLOAT, _build.PTR,
                       _build.INT, _build.INT, _build.INT, _build.INT,
                       _build.PTR],
})


def _iters(method: str, n: int) -> int:
    # filter terminates in <= n sweeps; bisect needs its fixed budget
    return n + 2 if method == "filter" else _ITERS


def project_l1_plain(v: torch.Tensor, radii: torch.Tensor,
                     method: str = "bisect") -> torch.Tensor:
    """The plain PyTorch version of the kernel, row by row identical in
    algorithm (the sums run in another order)."""
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
    return torch.sign(v) * torch.clamp(a - theta, min=0.0)


def _check_method(method: str) -> None:
    if method not in KERNEL_METHODS:
        raise ValueError(
            f"no l1ball kernel for method {method!r}; available: "
            f"{list(KERNEL_METHODS)}")


def _check(v: torch.Tensor, radii: torch.Tensor, method: str) -> None:
    _check_method(method)
    if v.ndim != 2 or radii.shape != (v.shape[0],):
        raise ValueError(
            f"l1ball takes v (B, n) and radii (B,), got {tuple(v.shape)} and "
            f"{tuple(radii.shape)}")
    if v.dtype != torch.float32 or radii.dtype != torch.float32:
        raise ValueError(f"l1ball takes float32, got {v.dtype}/{radii.dtype}")
    if radii.get_device() != v.get_device():  # no torch.device built
        raise ValueError("v and radii must lie on one device")


def _launch(v: torch.Tensor, b: int, n: int, radii: torch.Tensor | None,
            radius: float, method: str, out: torch.Tensor | None
            ) -> torch.Tensor:
    """Launch the kernel on ``b`` rows of ``n`` values of ``v`` (any shape of
    ``b · n`` values): radius ``radii[i]`` for row i, or ``radius`` for every
    row when ``radii`` is None. Autograd may not record the call: the
    kernel has no backward of its own (the generated pipeline's Function
    calls it with grad mode off)."""
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
        raise ValueError("out must be a contiguous float32 tensor like v")
    if _costs.active() and _costs.declare(KERNEL, v, *_costs.l1ball(b, n)):
        return out
    KERNEL.launch("l1ball_project", v.data_ptr(), _build.ptr(radii), radius,
                  out.data_ptr(), b, n, _METHOD_CODES[method],
                  _iters(method, n), _build.stream_handle(v))
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
    ``L1_KERNEL_MAX`` values raises (the kernel keeps it on chip). A number
    radius reaches the kernel by value (rounded to float32), so the call
    copies nothing to the device; a tensor radius is read there.
    """
    if v.ndim != 1:
        raise ValueError(f"project_l1 takes a vector, got {tuple(v.shape)}")
    if v.is_cpu or isinstance(radius, torch.Tensor):
        radii = torch.as_tensor(radius, dtype=v.dtype, device=v.device).reshape(1)
        return project_l1_batched(v[None], radii, method=method)[0]
    _check_method(method)
    if v.dtype != torch.float32:
        raise ValueError(f"l1ball takes float32, got {v.dtype}")
    return _launch(v, 1, v.shape[0], None, float(radius), method, None)


def outer_l1_solve(v: torch.Tensor, radius, *, method: str = "bisect"
                   ) -> torch.Tensor:
    """The golden pipelines' outer θ-solve on the column aggregate ``v``
    (m,), routed as JAX's ``outer_l1_solve``: a kernel method ("bisect",
    "filter") runs :func:`project_l1`, any other method, or a vector over
    ``REF_ROUTE_ABOVE`` values, the ``core.ball`` solver in PyTorch ops on
    ``v``'s device. A kernel method on a CUDA vector of
    ``L1_KERNEL_MAX`` + 1 … ``REF_ROUTE_ABOVE`` values raises (over the
    card's shared memory, under JAX's limit)."""
    if v.shape[0] <= REF_ROUTE_ABOVE and method in KERNEL_METHODS:
        return project_l1(v, radius, method=method)
    from .ref import project_l1_ref
    return project_l1_ref(v, radius, method=method)
