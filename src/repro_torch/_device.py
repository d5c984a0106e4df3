"""Device resolution for every entry point of the port.

An entry point that takes ``device=`` resolves it here. ``None`` means the
card: the port exists to run there, so a caller who wants the plain PyTorch
path on the CPU asks for ``"cpu"`` by name. Without a CUDA device a request
for ``"cuda"`` (explicit or by default) raises; nothing falls back to the CPU.
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
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` lies on a CUDA device (a kernel's launch gate)."""
    if not t.is_cuda:
        raise ValueError(
            f"{what}: the CUDA kernel needs a CUDA tensor, got one on "
            f"{t.device}; the plain version runs only for CPU tensors")
