"""The port's sharding helpers (``repro_torch.parallel.sharding``) against
the JAX package's ``repro/parallel/sharding.py``, and the tree helpers'
round trips, on the CPU.

JAX's ``batch_axes``, ``dp_shards``, ``act_rules``, ``batch_spec`` and
``tokens_spec`` read only ``mesh.axis_names`` and ``mesh.devices.shape``,
so one stand-in object per layout serves both packages (the port reads
its ``shape`` mapping). Specs compare as tuples (JAX's ``PartitionSpec``
is one). Exact.
"""

import numpy as np
import pytest
import torch

from repro.parallel import sharding as JSH
from repro_torch.parallel import collectives, sharding as SH


class StandIn:
    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(tuple(sizes))
        self.shape = dict(zip(names, sizes))


LAYOUTS = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
           ((4, 1), ("data", "model")), ((1, 4), ("data", "model")),
           ((2, 1, 2), ("pod", "data", "model")),
           ((2, 4, 2), ("pod", "data", "model")),
           ((3, 2), ("data", "model"))]
IDS = ["x".join(map(str, s)) for s, _ in LAYOUTS]


@pytest.mark.parametrize("sizes,names", LAYOUTS, ids=IDS)
def test_batch_axes_dp_shards_act_rules_match_jax(sizes, names):
    mesh = StandIn(sizes, names)
    assert SH.batch_axes(mesh) == JSH.batch_axes(mesh)
    assert SH.dp_shards(mesh) == JSH.dp_shards(mesh)
    assert SH.act_rules(mesh, None) == JSH.act_rules(mesh, None)
    assert SH.param_rules(mesh) == JSH.param_rules(mesh)
    assert SH.param_rules(mesh, fsdp=False) == JSH.param_rules(mesh, fsdp=False)


@pytest.mark.parametrize("sizes,names", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_batch_and_tokens_specs_match_jax(sizes, names, n):
    mesh = StandIn(sizes, names)
    for extra in (1, 2):
        assert SH.batch_spec(mesh, n, extra) == tuple(JSH.batch_spec(mesh, n, extra))
    assert SH.tokens_spec(mesh, None, n) == tuple(JSH.tokens_spec(mesh, None, n))


@pytest.mark.parametrize("sizes,names", LAYOUTS, ids=IDS)
def test_shard_tree_round_trip(sizes, names):
    """Every rank's shards of a tree (one leaf over two mesh axes, the
    batch over ('pod', 'data') when there is a pod axis) put back together
    are the tree."""
    mesh = StandIn(sizes, names)
    world = int(np.prod(sizes))
    rng = np.random.default_rng(0)
    b_ax = SH.batch_axes(mesh)
    tree = {"w": torch.from_numpy(rng.normal(size=(12, 12)).astype(np.float32)),
            "b": {"tok": torch.arange(2 * 24 * 5).reshape(2, 24, 5),
                  "s": torch.tensor(3.0)}}
    specs = {"w": ("data", "model"),
             "b": {"tok": (None, b_ax if len(b_ax) > 1 else b_ax[0], None),
                   "s": ()}}
    shards = [SH.shard_tree(tree, specs, mesh.shape, rank=r) for r in range(world)]
    back = SH.unshard_tree(shards, specs, mesh.shape)
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["b"]["tok"], tree["b"]["tok"])
    assert torch.equal(back["b"]["s"], tree["b"]["s"])
    for sh in shards:
        assert sh["w"].shape == SH.local_shape((12, 12), specs["w"], mesh.shape)
        assert SH.global_shape(sh["w"].shape, specs["w"], mesh.shape) == (12, 12)


def test_tuple_entry_is_pod_major():
    """P(('pod', 'data')) shards over pod × data with the pod major, as
    JAX lays such an axis out: rank (pod p, data d) holds block p·D + d."""
    shape = {"pod": 2, "data": 2, "model": 1}
    full = torch.arange(8)
    blocks = [SH.shard(full, (("pod", "data"),), shape, rank=r) for r in range(4)]
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_spec_axes_and_live_axes():
    assert SH.spec_axes((None, ("pod", "data"), "model")) == ("pod", "data", "model")
    mesh = StandIn((2, 1, 4), ("pod", "data", "model"))
    assert collectives.live_axes(mesh, ("model", "data", "pod")) == ("pod", "model")
    assert collectives.live_axes(mesh, "data") == ()
