"""Move parameters from the JAX package to the port.

:func:`from_numpy_tree` turns a parameter tree of arrays (nested dicts,
lists and tuples, as the JAX package's parameter pytrees are) into the same
tree of torch tensors on ``device``, with the **same layouts**: no axis is
transposed or reordered, so ``enc/w`` of shape (d_in, d_dict) stays
(d_in, d_dict) and the same code indexes both. Leaves are copied. Anything
``numpy.asarray`` accepts is a leaf (numpy arrays, and JAX arrays handed
over as numpy). ``bfloat16`` leaves pass through float32 (exact).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device


def _leaf(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def from_numpy_tree(tree, device=None):
    """The tree with every leaf a torch tensor on ``device`` (``"cuda"`` by
    default; ``"cpu"`` when asked)."""
    dev = _device.resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _leaf(node, dev)

    return walk(tree)


params_from_jax = from_numpy_tree
