"""The port's int8 block-quantized AdamW moments and ``make_fused_step``
against the JAX package's, on the CPU.

* ``quantize_blockwise``: ``q`` bit-equal to JAX's and ``s`` within 1 ulp,
  signed and unsigned, on trailing axes that are and are not multiples of
  256; ``dequantize_blockwise`` equal on the same ``q``/``s``;
* three ``adamw.update`` and three ``fused_update`` steps with
  ``moment_dtype="int8"`` from the same params, moments and gradients:
  params and dequantized moments within 1e-6 (absolute; the values are
  O(1)); ``q`` equal but for under 0.1 % of entries one step apart, where a
  float32 value an ulp away from JAX's lies at a half-integer of its scale
  (one entry in three steps here), and the moments are compared elsewhere;
* ``state_specs`` against JAX's structure;
* ``make_fused_step`` with ``donate=True`` (in place) and ``False`` (the
  caller's tensors untouched), equal to each other;
* the refusal of a mesh whose sharded trailing axis has a per-rank extent
  that is no multiple of 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import types as jtypes
from repro.optim import adamw as jadamw
from repro.optim import fused_step as jfused
from repro_torch import _tree
from repro_torch.configs import types as ttypes
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import fused_step as tfused
from repro_torch.optim import quantize_blockwise, dequantize_blockwise

SHAPES = [(3, 256), (5, 300), (2, 4, 100), (512,), (7, 1000)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_blockwise_matches_jax(shape, signed):
    rng = np.random.default_rng(sum(shape) + signed)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    if not signed:
        x = np.abs(x)
    x.reshape(-1)[::97] = 0.0
    want = _np(jadamw.quantize_blockwise(jnp.asarray(x), signed=signed))
    got = quantize_blockwise(torch.from_numpy(x), signed=signed)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["q"].shape) == want["q"].shape
    assert tuple(got["s"].shape) == want["s"].shape
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_max_ulp(got["s"].numpy(), want["s"], maxulp=1)
    n = shape[-1]
    back = dequantize_blockwise(got, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jadamw.dequantize_blockwise(
            {"q": jnp.asarray(want["q"]), "s": jnp.asarray(got["s"].numpy())},
            n)))


def test_quantize_rounds_half_to_even():
    # 127 · (k + 0.5) / 127.5 lands on exact halves of the scale
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 250])
    q = quantize_blockwise(x)["q"][0, :6]
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def _cfgs(project=False, **kw):
    base = dict(lr=1e-2, total_steps=10, warmup=1, moment_dtype="int8",
                master_dtype="", weight_decay=0.1)
    base.update(kw)
    jspec = tspec = None
    if project:
        jspec = jtypes.ProjectionSpec(pattern=r"w_up", radius=2.0)
        tspec = ttypes.ProjectionSpec(pattern=r"w_up", radius=2.0)
    return (jtypes.TrainConfig(**base, projection=jspec),
            ttypes.TrainConfig(**base, projection=tspec))


def _params(seed=0):
    """A stacked (layers, d, f) leaf (updated a layer at a time), a matrix
    whose trailing axis is no multiple of 256, and a vector."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w_up": rng.normal(size=(3, 64, 300)).astype(np.float32),
                       "ln": np.ones((3, 64), np.float32)},
            "embed": rng.normal(size=(96, 80)).astype(np.float32),
            "b": rng.normal(size=(70,)).astype(np.float32)}


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return {k: (_grads(v, step) if isinstance(v, dict) else
                (rng.normal(size=v.shape) * 0.1).astype(np.float32))
            for k, v in params.items()}


def _t(tree):
    return _tree.tree_map(lambda a: torch.tensor(np.array(a)), tree)


def _hold(jtree, ttree, what):
    for name, t in _tree.leaves_with_paths(ttree):
        w = jtree
        for k in name.split("/"):
            w = w[k]
        w = np.asarray(w)
        if t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, \
                f"{what} {name}"
        else:
            np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=f"{what} {name}")


def _moments(state, params):
    """Dequantized m and v (v from its square-root domain) per leaf."""
    out = {}
    for part in ("m", "v"):
        flat = _tree.leaves_up_to(params, state[part])
        vals = [dequantize_blockwise(q, p.shape[-1]) for q, p in
                zip(flat, _tree.leaves(params))]
        out[part] = _tree.unflatten_like(params, vals)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_three_int8_steps_match_jax(fused):
    jt, tt = _cfgs(project=fused)
    p0 = _params()
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), _t(p0)
    js, ts = jadamw.init(jp, jt), tadamw.init(tp, tt)
    _hold(_np(js), ts, "init")
    for step in range(3):
        g = _grads(p0, step)
        if fused:
            jp, js, jm = jfused.fused_update(
                jax.tree_util.tree_map(jnp.asarray, g), js, jp, jt)
            tp, ts, tm = tfused.fused_update(_t(g), ts, tp, tt)
        else:
            jp, js, jm = jadamw.update(jax.tree_util.tree_map(jnp.asarray, g),
                                       js, jp, jt)
            tp, ts, tm = tadamw.update(_t(g), ts, tp, tt, inplace=step % 2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        _hold(_np(jp), tp, f"step {step + 1} params")
        _hold(_np(js), ts, f"step {step + 1} state")
        jstate = _t(_np(js))
        jmom, tmom = _moments(jstate, tp), _moments(ts, tp)
        for part in ("m", "v"):
            # within 1e-6, except where q took the neighbouring step (its
            # float32 input rounds within an ulp of a half-integer)
            same = [(a["q"] == b["q"]).reshape(a["q"].shape)[..., :p.shape[-1]]
                    for a, b, p in zip(_tree.leaves_up_to(tp, ts[part]),
                                       _tree.leaves_up_to(tp, jstate[part]),
                                       _tree.leaves(tp))]
            for (name, a), b, eq in zip(_tree.leaves_with_paths(tmom[part]),
                                        _tree.leaves(jmom[part]), same):
                np.testing.assert_allclose(
                    a[eq].numpy(), b[eq].numpy(), rtol=0, atol=1e-6,
                    err_msg=f"step {step + 1} {part} {name}")
    assert int(ts["step"]) == 3
    if fused:   # the projection ran on the f32 update, before the cast
        from repro_torch.core import multilevel
        norms = [float(multilevel.multilevel_norm(w, [("inf", 1), ("1", 1)]))
                 for w in tp["blocks"]["w_up"]]
        assert max(norms) <= 2.0 * (1 + 1e-5)


def test_state_specs_structure_matches_jax():
    from jax.sharding import PartitionSpec as P
    jt, tt = _cfgs()
    specs = {"blocks": {"w_up": (None, "data", "model"), "ln": (None, None)},
             "embed": ("model", "data"), "b": (None,)}
    jspecs = jax.tree_util.tree_map(lambda s: P(*s), specs,
                                    is_leaf=lambda x: isinstance(x, tuple))
    want = jadamw.state_specs(jspecs, None, jt)
    got = tadamw.state_specs(specs, None, tt)
    jleaves = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, P))
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jleaves]
    assert names == [n for n, _ in _tree.leaves_with_paths(got)]
    for (path, jsp), (_, tsp) in zip(jleaves, _tree.leaves_with_paths(got)):
        # q takes the parameter's spec in both; the scales' trailing axis
        # is replicated in JAX and shards with q's here
        assert tuple(jsp)[:-1] == tuple(tsp)[:-1]
        if path[-1].key == "q" or tuple(jsp) == ():
            assert tuple(jsp) == tuple(tsp)
    f32 = tadamw.state_specs(specs, None, _cfgs(moment_dtype="float32")[1])
    assert f32["m"] == specs


def test_make_fused_step_donate():
    jt, tt = _cfgs(project=True)
    p0 = _params(1)
    g = _t(_grads(p0, 0))
    base = _t(p0)
    state = tadamw.init(base, tt)
    copy_p = _tree.tree_map(torch.clone, base)
    copy_s = _tree.tree_map(torch.clone, state)
    kept = tfused.make_fused_step(tt, donate=False)(g, state, base)
    # donate=False: the caller's params and state are as they were
    for a, b in zip(_tree.leaves(base), _tree.leaves(copy_p)):
        assert torch.equal(a, b)
    for a, b in zip(_tree.leaves(state), _tree.leaves(copy_s)):
        assert torch.equal(a, b)
    donated = tfused.make_fused_step(tt)(g, state, base)
    # donate=True: the outputs are the caller's tensors, updated in place
    assert donated[0] is base and donated[1] is state
    for a, b in zip(_tree.leaves(kept[0]) + _tree.leaves(kept[1]),
                    _tree.leaves(donated[0]) + _tree.leaves(donated[1])):
        assert torch.equal(a, b)
    want = jfused.make_fused_step(jt)(
        jax.tree_util.tree_map(jnp.asarray, _grads(p0, 0)),
        jadamw.init(jax.tree_util.tree_map(jnp.asarray, p0), jt),
        jax.tree_util.tree_map(jnp.asarray, p0))
    _hold(_np(want[0]), donated[0], "make_fused_step params")


@pytest.mark.parametrize("mesh,ok", [
    ({"data": 2, "model": 2}, False),   # w_up 300 over 2 → 150; embed 80 / 2
    ({"data": 1, "model": 1}, True),
    ({"data": 1, "model": 2}, False),
])
def test_int8_mesh_refuses_a_misaligned_sharded_trailing_axis(mesh, ok):
    _, tt = _cfgs()
    specs = {"blocks": {"w_up": (None, "data", "model"), "ln": (None, None)},
             "embed": ("model", "data"), "b": (None,)}
    shapes = _tree.tree_map(lambda a: a.shape, _params())
    if ok:
        tadamw.check_int8_mesh(shapes, specs, mesh)
    else:
        with pytest.raises(ValueError, match="multiple of 256"):
            tadamw.check_int8_mesh(shapes, specs, mesh)
    # aligned: 1024 over 2 ranks is 512 a rank
    tadamw.check_int8_mesh({"w": (8, 1024)}, {"w": (None, "model")},
                           {"data": 1, "model": 2})


def test_int8_mesh_refusal_reaches_update():
    """The refusal sits in ``update``, which every state passes through,
    whether ``init`` made it or a checkpoint restored it; it raises before
    any collective. One rank on the axis takes any extent."""
    _, tt = _cfgs()
    shard = {"w": torch.zeros(8, 150)}
    specs = {"w": (None, "model")}
    mesh = {"data": 1, "model": 2}
    state = tadamw.init(shard, tt)
    with pytest.raises(ValueError, match="300 over 2 ranks"):
        tadamw.update(shard, state, shard, tt, mesh=mesh, param_specs=specs)
    tadamw.check_int8_mesh([(8, 300)], specs, {"data": 1, "model": 1})


def test_unknown_moment_dtype_raises():
    _, tt = _cfgs(moment_dtype="float16")
    with pytest.raises(ValueError, match="moment_dtype"):
        tadamw.init({"w": torch.zeros(4)}, tt)


def test_int8_moments_on_a_mesh_match_one_device(tmp_path):
    """int8 moments under the sharded step (4 gloo ranks, (2, 2) mesh) at
    widths whose sharded trailing axes hold a multiple of 256 a rank: each
    rank quantizes its own blocks, which are the single-device step's. Two
    steps: losses and gradient norms within 1e-5 relative; the gathered
    ``q`` equal to one device's but on under 0.5 % of entries, at most one
    quantization step apart per training step (each requantization of an
    input that sums in another order may land on the neighbouring step;
    the worst leaf reads 0.1 %, ``ln2``'s 2 of 2048), the scales within
    1e-5 of their largest entry (``test_torch_train_mesh.py``'s bar for
    float32 moments)."""
    import test_torch_bridge as tb

    case = dict(tb.MESH_CASE, name="int8_2x2", moments="int8",
                telemetry_every=0,
                widths=dict(d_model=512, d_ff=512, vocab=512))
    refs, ranks = tb.run_mesh_cases([case], tmp_path)
    _, losses, gnorms, _, opt = refs[case["name"]]
    for res in ranks:
        got = res[case["name"]]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], gnorms, rtol=1e-5)
        for part in ("m", "v"):
            for (name, a), b in zip(_tree.leaves_with_paths(got["moments"][part]),
                                    _tree.leaves(opt[part])):
                assert a.shape == b.shape, name
                if a.dtype == torch.int8:
                    diff = (a.int() - b.int()).abs()
                    assert int(diff.max()) <= case["steps"], name
                    assert float((diff > 0).float().mean()) < 5e-3, name
                else:  # the scales: as test_torch_train_mesh.py's moments
                    torch.testing.assert_close(
                        a, b, rtol=0, atol=1e-5 * float(b.abs().max()),
                        msg=name)
