"""Fault-tolerant checkpointing: atomic, async, keep-K, restore (port of
``repro/runtime/checkpoint.py``).

Layout, the JAX package's own:  <dir>/step_<N>/{manifest.json, arrays.npz}
(+ .tmp staging), one npz entry per leaf under its path with ``/`` written
as ``╱``, and the manifest's ``step``, ``time``, ``keys``, ``dtypes`` and
``shapes``. So a training checkpoint the JAX launcher wrote restores into
the port, and the port's into numpy.

* atomic   — written to ``step_N.tmp`` then renamed (a crash mid-save can
             never corrupt the latest valid checkpoint).
* async    — ``save_async`` snapshots to host memory synchronously (one
             device-to-host copy per leaf) and writes on a daemon thread;
             ``wait()`` joins before exit.
* keep-K   — oldest checkpoints removed after each successful save.
* restore  — tensors land on ``device`` (the card unless ``"cpu"`` is
             asked for); the data cursor is the step (data/pipeline.py).

numpy has no bf16: a bf16 leaf is stored as its raw 2-byte records (numpy
``|V2``), which is what ``np.savez`` makes of the JAX package's bf16
arrays, with ``"bfloat16"`` in the manifest's ``dtypes``; ``restore`` reads
such records back as bf16.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import _device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_host(x):
    """(numpy array, manifest dtype) of one leaf."""
    if isinstance(x, torch.Tensor):
        # a copy even on the host: the async writer must not see later
        # in-place updates of the live state
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(x)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make 0-d 1-d)
        a = a.copy()
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = str(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: Optional[dict] = None):
        self.wait()
        self._write(step, self._snapshot(state), extra or {})

    def save_async(self, step: int, state, extra: Optional[dict] = None):
        self.wait()
        host = self._snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _snapshot(state):
        return {k: _to_host(v) for k, v in _flatten(state).items()}

    def _write(self, step: int, host: dict, extra: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "╱"): a for k, (a, _) in host.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host),
            "dtypes": {k: dt for k, (_, dt) in host.items()},
            "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
            **extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None):
        """``(state, manifest)`` of ``step`` (the latest by default), every
        leaf a tensor on ``device``; ``(None, None)`` when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        dev = _device.resolve(device)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {}
            for name in z.files:
                key = name.replace("╱", "/")
                flat[key] = _from_host(z[name], manifest["dtypes"][key], dev)
        return _unflatten(flat), manifest
