"""The §7.3 application in the port: the structured-sparsity masks
(``repro_torch.core.masks``), the double-descent schedule
(``repro_torch.runtime.double_descent``) and the 5-method SAE sweep
(``repro_torch.training.sae_tables``), each against the JAX package on the
same numpy data and the same (JAX-drawn, numpy-carried) initial parameters.

The sweep is held against the live ``benchmarks.sae_tables.run_dataset`` at
a tiny size, never against a pinned table. Tolerances: masks exactly;
sparsities within 1e-6 relative (a float32 mean in another order); the
double-descent result of a deterministic descent within 1e-6; per-step
training losses of descent 1 within rtol 1e-5 (float32 matmuls in another
order, 10 AdamW steps); accuracy within one test sample, column sparsity
within one input column (the last step's weights may put one borderline
column on the other side of the ball).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import sae_tables as jtables
from repro.configs import registry as jregistry
from repro.configs.types import ProjectionSpec as JSpec
from repro.core import masks as jmasks
from repro.core import project_l1inf_exact as jexact
from repro.data import classification_synthetic
from repro.models import params as jparams, sae as jsae
from repro.optim.projection_hook import project_tree as jproject_tree
from repro.runtime.double_descent import double_descent as jdouble_descent
from repro_torch import _tree, interop
from repro_torch.configs.types import ProjectionSpec
from repro_torch.core import masks
from repro_torch.runtime import double_descent
from repro_torch.training import sae_tables

SPEC = dict(pattern=r"enc1/w", levels=(("inf", 1), (1, 1)), radius=1.0,
            transpose=True)
TINY = dict(n_samples=120, n_features=64, n_informative=16, class_sep=0.8)
EPOCHS = 10


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return interop.from_numpy_tree(_np_tree(tree), device="cpu")


def _assert_tree_equal(got, want, atol=0.0):
    flat = dict(_tree.leaves_with_paths(got))
    for path, w in _tree.leaves_with_paths(_np_tree(want)):
        np.testing.assert_allclose(flat[path].numpy(), w, atol=atol, rtol=0)


def _weights(seed=0):
    """A (6, 10) weight with three dead columns, and a 1-D leaf."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 10)).astype(np.float32)
    w[:, [1, 4, 7]] = 0.0
    w[2, 3] = 0.0
    return {"dense": {"w": w, "b": rng.normal(size=(10,)).astype(np.float32)}}


@pytest.mark.parametrize("axis", [0, 1])
def test_masks_match_jax(axis):
    params = _weights()
    tp = _torch_tree(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    w = params["dense"]["w"]
    for tol in (0.0, 0.5):
        np.testing.assert_array_equal(
            masks.column_mask(tp["dense"]["w"], axis=axis, tol=tol).numpy(),
            np.asarray(jmasks.column_mask(jnp.asarray(w), axis=axis, tol=tol)))
        assert float(masks.sparsity(tp["dense"]["w"], axis=axis, tol=tol)) \
            == pytest.approx(float(jmasks.sparsity(jnp.asarray(w), axis=axis,
                                                   tol=tol)), rel=1e-6)
        assert float(masks.element_sparsity(tp["dense"]["w"], tol=tol)) \
            == pytest.approx(float(jmasks.element_sparsity(jnp.asarray(w),
                                                           tol=tol)), rel=1e-6)
    got = masks.mask_tree(tp, axis=axis)
    want = jmasks.mask_tree(jp, axis=axis)
    _assert_tree_equal(got, want)
    grads = {"dense": {"w": np.ones((6, 10), np.float32),
                       "b": np.ones((10,), np.float32)}}
    _assert_tree_equal(masks.apply_mask(_torch_tree(grads), got),
                       jmasks.apply_mask(grads, want))
    _assert_tree_equal(masks.apply_mask(tp, got), jmasks.apply_mask(jp, want))


def _sae_init(d=64):
    cfg = dataclasses.replace(jregistry.get_arch("sae-paper"), d_model=d)
    return jparams.init_params(jsae.template(cfg), jax.random.PRNGKey(0))


def _descent():
    """A deterministic stand-in for one descent: each weight scaled and
    shifted (then masked) in elementwise float32 ops, in either package."""
    def run(params, mask):
        out = {k: {n: p * 1.5 + 0.01 for n, p in leaf.items()}
               for k, leaf in params.items()}
        if mask is not None:
            out = {k: {n: p * mask[k][n] for n, p in leaf.items()}
                   for k, leaf in out.items()}
        return out

    return run


@pytest.mark.parametrize("rewind", [True, False])
@pytest.mark.parametrize("exact", [False, True])
def test_double_descent_matches_jax(rewind, exact):
    init = _sae_init()
    jprojector = tprojector = None
    if exact:
        jprojector = lambda p: dict(p, enc1=dict(  # noqa: E731
            p["enc1"], w=jexact(p["enc1"]["w"].T, 1.0).T))
        tprojector = lambda p: sae_tables._exact_enc1(p, 1.0)  # noqa: E731
    jfinal, jmask, jstats = jdouble_descent(init, _descent(), JSpec(**SPEC),
                                            projector=jprojector, rewind=rewind)
    final, mask, stats = double_descent(_torch_tree(init), _descent(),
                                        ProjectionSpec(**SPEC),
                                        projector=tprojector, rewind=rewind)
    _assert_tree_equal(mask, jmask)
    _assert_tree_equal(final, jfinal, atol=1e-6)
    assert stats.keys() == jstats.keys()
    for k, v in jstats.items():
        assert stats[k] == pytest.approx(v, abs=1e-4)
    assert 0.0 < float(masks.sparsity(final["enc1"]["w"], axis=1)) < 100.0


class _RecordingJax:
    """``jax`` as ``benchmarks/sae_tables.py`` sees it, with ``jit`` wrapped
    so each step's loss (the step's third output) is recorded in order."""

    def __init__(self, losses):
        self._losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def step(*args):
            out = jitted(*args)
            self._losses.append(float(out[2]))
            return out

        return step


def _parse(derived):
    acc, sp = derived.split("_colsparsity=")
    return float(acc.removeprefix("acc=").rstrip("%")), float(sp.rstrip("%"))


def test_run_dataset_matches_live_jax(monkeypatch):
    """The 5-method sweep at 120 × 64 and 10 epochs a descent against the
    live JAX sweep on the same data and initial parameters."""
    x, y, _ = classification_synthetic(**TINY)
    jlosses = []
    monkeypatch.setattr(jtables, "jax", _RecordingJax(jlosses))
    jrows = jtables.run_dataset("tiny", x, y, radius=1.0, epochs=EPOCHS)
    init = _sae_init()
    rec = {}
    rows = sae_tables.run_dataset("tiny", x, y, radius=1.0, epochs=EPOCHS,
                                  device="cpu", init=_torch_tree(init),
                                  record=rec)
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    # JAX's steps in order: the baseline's one descent, then two per method
    assert len(jlosses) == EPOCHS * 9
    starts = [0] + [EPOCHS * (1 + 2 * i) for i in range(4)]
    n_test = len(x) - int(0.8 * len(x))
    for (name, _, derived), (_, _, jderived), mname, s in zip(
            rows, jrows, sae_tables.METHODS, starts):
        losses = rec[mname]["losses"]
        assert len(losses) == (1 if mname == "baseline" else 2)
        np.testing.assert_allclose(losses[0], jlosses[s:s + EPOCHS],
                                   rtol=1e-5)
        acc, sp = _parse(derived)
        jacc, jsp = _parse(jderived)
        assert abs(acc - jacc) <= 100.0 / n_test + 0.05, name
        assert abs(sp - jsp) <= 100.0 / x.shape[1] + 0.05, name

    # the masks of projecting the same trained weights (descent 1, which
    # the baseline's run is): each method's own, exactly
    trained = rec["baseline"]["params"]
    jtrained = jax.tree_util.tree_map(
        jnp.asarray, {k: {n: p.numpy() for n, p in leaf.items()}
                      for k, leaf in trained.items()})
    for mname, kw in sae_tables._specs(1.0).items():
        if mname == "baseline":
            continue
        if "exact_radius" in kw:
            jproj = dict(jtrained, enc1=dict(
                jtrained["enc1"], w=jexact(jtrained["enc1"]["w"].T, 1.0).T))
        else:
            jproj = jproject_tree(jtrained, JSpec(**dataclasses.asdict(kw["spec"])))
        jmask = jax.tree_util.tree_map(
            lambda p: (jnp.abs(p) > 0).astype(p.dtype), jproj)
        _assert_tree_equal(rec[mname]["mask"], jmask)
    assert rec["baseline"]["mask"] is None and rec["baseline"]["colsparsity"] == 0.0
    assert rec["bilevel_l1inf"]["colsparsity"] > 0.0


def test_tables_entry_point(capsys, monkeypatch):
    """``python -m repro_torch.training.sae_tables`` prints the header and
    one row per dataset and method; without a card it raises unless asked
    for the CPU."""
    calls = []

    def fake_tables(full=False, device=None, record=None):
        calls.append((full, device))
        return [("sae_synthetic_baseline", 1.5, "acc=50.0%_colsparsity=0.0%")]

    monkeypatch.setattr(sae_tables, "tables", fake_tables)
    assert sae_tables.main(["--full", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived",
                   "sae_synthetic_baseline,1.5,acc=50.0%_colsparsity=0.0%"]
    assert calls == [(True, "cpu")]
    if not torch.cuda.is_available():
        x, y, _ = classification_synthetic(**TINY)
        with pytest.raises(RuntimeError, match="CUDA"):
            sae_tables.run_dataset("tiny", x, y, radius=1.0, epochs=1)
