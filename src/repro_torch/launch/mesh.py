"""Meshes over the initialized ``torch.distributed`` world (port of
``repro/launch/mesh.py``). Functions, not module constants: building a mesh
opens process groups, which needs the world to exist first.

The caller initializes the default process group (its backend, its
rendezvous — ``init_method="file://..."`` or ``tcp://localhost:<port>``
on a machine without a network — the world size and this rank); these
functions only lay the world out.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import AbstractMesh, Mesh, require_process_group

CARDS_PER_NODE = 8
PRODUCTION = {  # the dry run's meshes: (sizes, axis names)
    "single": ((32, CARDS_PER_NODE), ("data", "model")),
    "multi": ((2, 32, CARDS_PER_NODE), ("pod", "data", "model")),
}


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ("data", "model") mesh of ``data`` × ``model`` ranks: the whole
    world, which must hold exactly that many."""
    return Mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The world in the production layout: the cards of one host (at most
    the world) on the tensor-parallel "model" axis, the rest data parallel.
    ``multi_pod`` adds a leading "pod" axis of 2 data-parallel halves (the
    JAX package's two-pod mesh), over which only gradients travel."""
    require_process_group("make_production_mesh")
    world = dist.get_world_size()
    model = max(1, min(world, torch.cuda.device_count()))
    pods = 2 if multi_pod else 1
    if world % (model * pods):
        raise ValueError(f"{pods} pod(s) of a model axis of {model} do not "
                         f"divide the world of {world} ranks")
    data = world // (model * pods)
    if multi_pod:
        return Mesh((pods, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))


def make_abstract_mesh(kind: str = "single") -> AbstractMesh:
    """The production mesh ``kind`` ("single" or "multi", module
    docstring) seen from its first rank, with no process group."""
    if kind not in PRODUCTION:
        raise ValueError(f"mesh kind {kind!r}: expected one of {sorted(PRODUCTION)}")
    sizes, names = PRODUCTION[kind]
    return AbstractMesh(sizes, names)
