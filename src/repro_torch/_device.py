"""Device resolution for every entry point of the port.

An entry point that takes ``device=`` resolves it here. ``None`` means the
card: the port exists to run there, so a caller who wants the plain PyTorch
path on the CPU asks for ``"cpu"`` by name. Without a CUDA device a request
for ``"cuda"`` (explicit or by default) raises; nothing falls back to the CPU.
``"meta"`` is taken by name too: shapes and dtypes with no storage, what
the dry run (``launch/dryrun.py``) builds its abstract state and caches on.

A kernel's wrapper launches on a CUDA tensor and runs its plain version on a
CPU one (:func:`require_cuda` is the gate). Inside a cost walk
(``roofline/costs.py``) it also takes a ``meta`` tensor: it then allocates
its outputs on ``meta``, reports the kernel's cost to the walk and launches
nothing.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``cuda`` unless the caller
    asked for ``cpu``. Raises ``RuntimeError`` when CUDA is wanted and absent,
    ``ValueError`` for any other device type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         "'meta'")
    return dev


def records_grad(*ts) -> bool:
    """True when autograd records a call on ``ts``: grad mode is on and a
    tensor among them requires grad (anything else is ignored)."""
    if torch.is_grad_enabled():
        for t in ts:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return True
    return False


def refuse_grad(what: str, *ts) -> None:
    """Raise where autograd would record a kernel that has no backward: its
    result would be cut from the graph. The generated pipeline
    (``kernels.codegen.build``, ``core.multilevel_project(...,
    method="auto")``) is the differentiable route."""
    if records_grad(*ts):
        raise ValueError(
            f"{what}: the kernel has no backward, so its result would be cut "
            "from the autograd graph; differentiate through "
            "kernels.codegen.build(...) or core.multilevel_project(..., "
            "method='auto'), or call it under torch.no_grad()")


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` lies on a CUDA device (a kernel's launch gate), or
    is a ``meta`` tensor inside a cost walk (module docstring)."""
    if not t.is_cuda and not (t.is_meta and _walking()):
        raise ValueError(
            f"{what}: the CUDA kernel needs a CUDA tensor, got one on "
            f"{t.device}; the plain version runs only for CPU tensors")


def _walking() -> bool:
    from repro_torch.roofline import costs

    return costs.active() is not None
