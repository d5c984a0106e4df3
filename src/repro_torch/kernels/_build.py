"""Build the port's CUDA sources into shared libraries and bind them with
``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions that take device pointers,
sizes and a CUDA stream and return a ``cudaError_t``. At first use it is
compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

into ``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, the
hash covering the sources and the flags, so an edited source rebuilds and an
unchanged one loads at once. ``nvcc``'s report (registers, shared memory,
spills per kernel) is kept beside the library as ``.log``. A failed build
raises; nothing falls back. A build holds an ``fcntl`` lock on the
library's ``.lock`` file, so processes that start together (the ranks of a
mesh on a fresh checkout) build each library once: the others wait, then
load it.

A :class:`Kernel` owns one library and the plain integer ``launches`` that
its wrapper bumps after every successful launch, so a run can show which
kernels the main path went through. Launches made inside :func:`searching`
(the measured tile search of ``kernels/codegen``, which times candidate
launch geometries on the main path) also count in ``search_launches``, so
a run can tell them apart. The library's functions are bound
once, when it loads; a launch after that takes no lock and looks nothing
up by name. Two kernels of one source (``source=``,
as ``flash_bwd_dq`` and ``flash_bwd_dkv`` share ``csrc/flash_bwd.cu``) share
its library and count their launches apart.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH

ERROR_STRING = "repro_error_string"  # every library's cudaGetErrorString

# ctypes argument kinds of the exported C functions
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float

KERNELS: Dict[str, "Kernel"] = {}
_SEARCHING = [0]   # depth of searching() blocks in progress
_BUILD_LOCK = threading.Lock()  # one nvcc per library, whichever kernel asks


@contextlib.contextmanager
def _file_lock(library: Path):
    """Hold an exclusive ``fcntl`` lock on ``library``'s ``.lock`` file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(library.with_suffix(".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and TOOLKIT_NVCC.exists():
        nvcc = str(TOOLKIT_NVCC)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return nvcc


class Kernel:
    """One CUDA source built into a shared library, with its launch count.

    ``functions`` maps each exported C function to its argument kinds; every
    function returns an ``int`` (``cudaError_t``). ``source`` names the
    ``csrc/<source>.cu`` file (default: ``name``).
    """

    def __init__(self, name: str, functions: Dict[str, Sequence],
                 source: Optional[str] = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.functions = dict(functions)
        self.launches = 0
        self.search_launches = 0
        self.build_seconds: Optional[float] = None
        self._t0 = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, Callable[..., int]] = {}  # bound at load
        self._lock = threading.Lock()
        KERNELS[name] = self

    @property
    def library(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists; returns
        the process (finish it with :meth:`finish_build`)."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        self._t0 = time.perf_counter()
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        self.library.with_suffix(".log").write_text(log)
        os.replace(tmp, self.library)
        self.build_seconds = time.perf_counter() - self._t0

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                with _BUILD_LOCK, _file_lock(self.library):
                    self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library))
                fns = {}
                for fn, argtypes in self.functions.items():
                    fns[fn] = getattr(lib, fn)
                    fns[fn].argtypes = list(argtypes)
                    fns[fn].restype = ctypes.c_int
                fns[ERROR_STRING] = lib.repro_error_string
                fns[ERROR_STRING].argtypes = [ctypes.c_int]
                fns[ERROR_STRING].restype = ctypes.c_char_p
                self._fns = fns
                self._lib = lib
            return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call one exported function (the caller passes the stream among
        ``args``), raise on any CUDA error, and count the launch. The first
        call loads the library (building it if needed); later calls go
        straight to the function bound at load."""
        if self._lib is None:
            self.lib()
        rc = self._fns[fn](*args)
        if rc != 0:
            msg = self._fns[ERROR_STRING](rc).decode()
            raise RuntimeError(f"{self.name}.{fn} failed: CUDA error {rc} ({msg})")
        self.launches += 1
        if _SEARCHING[0]:
            self.search_launches += 1


def stream_handle(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device:
    one call into PyTorch's CUDA module, with no ``torch.cuda.Stream``
    object built around it (``torch.cuda.current_stream`` builds one). 0
    for a ``meta`` tensor, whose call launches nothing
    (``roofline/costs.py``)."""
    if t.is_meta:
        return 0
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def build_all() -> Dict[str, float]:
    """Build every registered kernel's library at once (one ``nvcc`` per
    source, all started together) and load them; returns the build seconds
    of each library that had to be compiled."""
    owners = {}  # one kernel per library starts its build
    for name, k in KERNELS.items():
        owners.setdefault(k.library, name)
    with contextlib.ExitStack() as locks:
        for library in sorted(owners):  # one order: no two processes deadlock
            locks.enter_context(_file_lock(library))
        procs = {name: KERNELS[name].start_build() for name in owners.values()}
        for name, proc in procs.items():
            KERNELS[name].finish_build(proc)
    for k in KERNELS.values():
        k.lib()
    return {name: KERNELS[name].build_seconds
            for name, proc in procs.items() if proc is not None}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.search_launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def search_counts() -> Dict[str, int]:
    """The part of :func:`launch_counts` made inside :func:`searching`."""
    return {name: k.search_launches for name, k in KERNELS.items()}


@contextlib.contextmanager
def searching():
    """Count the launches of the block in ``search_launches`` too."""
    _SEARCHING[0] += 1
    try:
        yield
    finally:
        _SEARCHING[0] -= 1
