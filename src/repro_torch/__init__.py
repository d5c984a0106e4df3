"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The port mirrors ``repro``'s module names (``core.ball``, ``core.schedule``,
``core.plan``, ``kernels.codegen``, ``serving.engine``, ...) so each piece has
an obvious counterpart, and uses PyTorch idiom inside: plain functions on
tensors, an explicit ``device=``, explicit ``torch.Generator``s, ``out=``
buffers where JAX donated arguments.

Entry points run on the card (``device="cuda"``) unless the caller asks for
``"cpu"``; without a CUDA device they raise. On a CUDA tensor every kernel
wrapper launches its hand-written CUDA kernel (``csrc/``, built with ``nvcc``
at first use into ``build/repro_torch/``) or raises; the plain PyTorch version
beside each kernel runs only for CPU tensors.

The package imports ``torch`` and nothing of JAX or of ``repro``.
"""

from ._device import resolve as resolve_device  # noqa: F401

__all__ = ["resolve_device"]
