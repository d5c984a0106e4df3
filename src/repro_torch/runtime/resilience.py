"""Fault-tolerance runtime: restart supervisor, straggler monitor, heartbeats
(copy of ``repro/runtime/resilience.py``: numpy and the standard library, no
framework; the port keeps its own copy so it never imports the JAX
package).

At 1000+ nodes the failure model is: a host dies (checkpoint-restart), a host
slows down (straggler mitigation), or the allocation changes size (elastic).
This module provides the coordinator-side logic; it is exercised in tests via
simulated timings and a SIGKILL'd subprocess.

* ``StragglerMonitor`` — per-host step-time EWMA + deviation watchdog; flags
  hosts whose step time exceeds ``threshold × p50``. On a multi-host job, the
  recommended action (returned, not enforced) is "checkpoint + evict + remesh"
  since data-parallel steps are barrier-synchronized and one slow host gates
  the fleet.
* ``HeartbeatFile`` — cheap cross-process liveness protocol (mtime-based),
  standing in for the cluster manager's health service.
* ``run_with_restarts`` — supervises a train function: on crash, restores the
  latest checkpoint and continues; gives up after ``max_restarts``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    step: int
    p50: float
    worst_host: int
    worst_time: float
    stragglers: List[int]
    action: str  # "none" | "warn" | "evict"


class StragglerMonitor:
    def __init__(self, n_hosts: int, window: int = 32,
                 warn_factor: float = 1.5, evict_factor: float = 3.0,
                 min_samples: int = 8):
        self.n_hosts = n_hosts
        self.window = window
        self.warn_factor = warn_factor
        self.evict_factor = evict_factor
        self.min_samples = min_samples
        self.history: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self.step = 0

    def record(self, host_times: Dict[int, float]) -> StragglerReport:
        """host -> seconds for this step. Returns the verdict."""
        self.step += 1
        for h, t in host_times.items():
            self.history[h].append(t)
        means = {h: float(np.mean(v)) for h, v in self.history.items()
                 if len(v) >= min(self.min_samples, self.step)}
        if not means:
            return StragglerReport(self.step, 0.0, -1, 0.0, [], "none")
        p50 = float(np.median(list(means.values())))
        worst = max(means, key=means.get)
        stragglers = [h for h, m in means.items()
                      if m > self.warn_factor * p50]
        action = "none"
        if stragglers:
            action = "warn"
        if any(means[h] > self.evict_factor * p50 for h in stragglers):
            action = "evict"
        return StragglerReport(self.step, p50, worst, means[worst],
                               sorted(stragglers), action)


class HeartbeatFile:
    """mtime-based liveness: hosts touch ``<dir>/host_<id>``; the coordinator
    reports hosts whose heartbeat is older than ``timeout`` seconds."""

    def __init__(self, directory: str, timeout: float = 60.0):
        self.dir = directory
        self.timeout = timeout
        os.makedirs(directory, exist_ok=True)

    def beat(self, host_id: int):
        path = os.path.join(self.dir, f"host_{host_id}")
        with open(path, "a"):
            os.utime(path, None)

    def dead_hosts(self, expected: int, now: Optional[float] = None) -> List[int]:
        now = now or time.time()
        dead = []
        for h in range(expected):
            path = os.path.join(self.dir, f"host_{h}")
            if not os.path.exists(path) or now - os.path.getmtime(path) > self.timeout:
                dead.append(h)
        return dead


def run_with_restarts(train_fn: Callable[[Optional[int]], int],
                      ckpt_mgr, max_restarts: int = 3) -> int:
    """``train_fn(resume_step) -> final_step``; re-invoked from the latest
    checkpoint on any exception. Returns the final step reached."""
    restarts = 0
    while True:
        resume = ckpt_mgr.latest_step()
        try:
            return train_fn(resume)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
