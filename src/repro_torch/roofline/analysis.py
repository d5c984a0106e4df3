"""Roofline terms of a walked step (port of ``repro/roofline/analysis.py``).

    compute    = FLOPs_global / (chips × peak FLOP/s)
    memory     = bytes_global / (chips × HBM bytes/s)
    collective = Σ over link kinds of coll_bytes_global / (chips × link bytes/s)

The counts are one rank's, from ``roofline/costs.py`` (the JAX package
parses them out of the compiled HLO), times the chips for the global
figures.

The constants are an H100 SXM's datasheet figures, not measurements: 989
TFLOP/s of dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 450 GB/s a
card each way over NVLink (900 GB/s in both), and 50 GB/s a card over one
400 Gb/s NIC. The production meshes (``launch/mesh.py``) put one HGX
node's 8 cards on "model", so a collective over "model" alone crosses
NVLink and one that spans "data" or "pod" crosses the NICs: the collective
term is split by the axes each collective spanned (``coll_by_axis``, bytes
per device, as ``coll_breakdown`` is), and ``t_collective`` is the sum of
the two links' times.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12     # bf16 dense, tensor cores, a card
HBM_BW = 3.35e12        # bytes/s, a card
NVLINK_BW = 450e9       # bytes/s a card, one direction, collectives over "model"
NIC_BW = 50e9           # bytes/s a card (400 Gb/s), over "data" and "pod"


def link_bw(axes: str) -> float:
    """The rate of a collective over the comma-joined mesh ``axes``: NVLink
    inside a node ("model" alone), the NIC as soon as it leaves it."""
    return NVLINK_BW if set(axes.split(",")) <= {"model"} else NIC_BW


@dataclasses.dataclass
class Roofline:
    flops_global: float
    bytes_global: float
    coll_bytes_global: Optional[float]
    chips: int
    coll_breakdown: Dict[str, int]
    coll_by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: Optional[float] = 0.0
    t_collective_nvlink: Optional[float] = 0.0
    t_collective_nic: Optional[float] = 0.0
    bottleneck: str = ""

    def finalize(self):
        self.t_compute = self.flops_global / (self.chips * PEAK_FLOPS)
        self.t_memory = self.bytes_global / (self.chips * HBM_BW)
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.coll_bytes_global is None:
            # not modelled (a serving cell the port runs on one device)
            self.t_collective = self.t_collective_nvlink = None
            self.t_collective_nic = None
        else:
            nv = sum(b for a, b in self.coll_by_axis.items()
                     if link_bw(a) == NVLINK_BW)
            nic = sum(b for a, b in self.coll_by_axis.items()
                      if link_bw(a) == NIC_BW)
            # coll_by_axis is per device, as coll_breakdown is
            self.t_collective_nvlink = nv / NVLINK_BW
            self.t_collective_nic = nic / NIC_BW
            self.t_collective = self.t_collective_nvlink + self.t_collective_nic
            terms["collective"] = self.t_collective
        self.bottleneck = max(terms, key=terms.get)
        return self

    def as_dict(self):
        return dataclasses.asdict(self)

    def bound_s(self) -> float:
        """The largest term: no step on these chips can take less."""
        return max(t for t in (self.t_compute, self.t_memory,
                               self.t_collective) if t is not None)


def analyze(costs, chips: int, *, collectives: bool = True) -> Roofline:
    """The roofline of one rank's ``costs.Costs`` on ``chips`` chips;
    ``collectives=False`` leaves the collective term out (None)."""
    return Roofline(
        flops_global=costs.flops * chips,
        bytes_global=costs.bytes * chips,
        coll_bytes_global=costs.coll_bytes * chips if collectives else None,
        chips=chips,
        coll_breakdown={k: int(v) for k, v in costs.coll_by_kind.items()},
        coll_by_axis={k: int(v) for k, v in costs.coll_by_axis.items()},
    ).finalize()


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for a train step; 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
