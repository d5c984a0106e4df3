"""The port's unfused train step (``make_train_step(fused=False)``: AdamW,
then the projection hook, then the master copy) and its gradient
accumulation dtype, against the JAX package's ``make_train_step`` on the
CPU.

* ``grad_allreduce_dtype="bfloat16"``: JAX accumulates the micro-batch
  gradients in bf16 (``repro/training/step.py:165-174``), and so must the
  port. ``smoke_config("granite-3-2b")``, 4 micro-batches, float32
  compute, ``fused=False``, 2 steps. The step-1 gradient norm within 1e-6
  relative, parameters within 1e-6 of the leaf's largest entry plus 1e-6
  relative; the step-2 gradient norm within 2e-6 relative: it is taken on
  the step-1 parameters, which the two packages leave up to 1.1e-6 of a
  leaf's largest entry apart (AdamW's first update g / (|g| + eps) turns on
  the last bits of gradients near eps, which sums in another order move),
  and reads 1.1e-6 apart. Accumulating in float32 instead puts the step-1
  gradient norm 9.2e-5 from JAX's, which the same test checks it would
  miss by more than 10×.
* ``fused=False`` with float32 accumulation against JAX's ``fused=False``
  at the launcher's settings (as ``test_torch_train.py``'s fused steps):
  losses and gradient norms within 1e-5 relative, parameters within 1e-5
  of the leaf's largest entry plus 1e-5 relative.
* ``fused=True`` with a mesh raises JAX's error; so do the telemetry
  arguments, and a mesh without both ``mesh=`` and ``param_specs=``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.configs import types as jtypes
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.training import step as jstep
from repro_torch import _tree, interop
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.configs import types as ttypes
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.optim import adamw as tadamw
from repro_torch.training import step as tstep

ARCH = "granite-3-2b"
SEQ = 24


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run(acc, *, batch, steps, port_acc=None):
    """``steps`` unfused steps in both packages from JAX's init; the port
    accumulates in ``port_acc`` when given (JAX always in ``acc``)."""
    kw = dict(microbatch=2, lr=3e-4, total_steps=steps,
              warmup=min(20, steps // 5 + 1), remat=True, master_dtype="",
              compute_dtype="float32")
    jt = jtypes.TrainConfig(**kw, grad_allreduce_dtype=acc,
                            projection=jtypes.ProjectionSpec(
                                pattern=r"(w_up|w_gate)", radius=1.0))
    tt = ttypes.TrainConfig(**kw, grad_allreduce_dtype=acc if port_acc is None
                            else port_acc,
                            projection=ttypes.ProjectionSpec(
                                pattern=r"(w_up|w_gate)", radius=1.0))
    cfg = jreg.smoke_config(ARCH)
    japi = jmodels.get(cfg)
    jstate = jstep.init_state(cfg, jt, japi, jax.random.PRNGKey(0))
    tp = interop.from_numpy_tree(_np(jstate["params"]), device="cpu")
    tstate = {"params": tp, "opt": tadamw.init(tp, tt)}
    jfn = jax.jit(jstep.make_train_step(cfg, jt, japi, impl="naive", fused=False))
    tcfg = treg.smoke_config(ARCH)
    tfn = tstep.make_train_step(tcfg, tt, tmodels.get(tcfg), impl="flash",
                                fused=False)
    jpipe = JDataPipeline(JDataConfig(vocab=cfg.vocab, seq_len=SEQ + 1,
                                      global_batch=batch, microbatch=2))
    tpipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ + 1,
                                    global_batch=batch, microbatch=2))
    out = []
    for i in range(steps):
        toks = tpipe.batch(i)
        np.testing.assert_array_equal(jpipe.batch(i), toks)
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tfn(tstate, {"tokens": torch.from_numpy(toks)})
        out.append((_np(jstate["params"]), {k: float(v) for k, v in jm.items()},
                    _tree.tree_map(lambda t: t.clone(), tstate["params"]),
                    {k: float(v) for k, v in tm.items()}))
    return out


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def _params_close(jp, tp, tol, what):
    for name, t in _tree.leaves_with_paths(tp):
        want = _get(jp, name)
        np.testing.assert_allclose(t.numpy(), want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()),
                                   err_msg=f"{what} {name}")


def test_bf16_gradient_accumulation_matches_jax():
    steps = _run("bfloat16", batch=8, steps=2)
    (jp1, jm1, tp1, tm1), (jp2, jm2, tp2, tm2) = steps
    np.testing.assert_allclose(tm1["grad_norm"], jm1["grad_norm"], rtol=1e-6)
    np.testing.assert_allclose(tm2["grad_norm"], jm2["grad_norm"], rtol=2e-6)
    for i, (jp, jm, tp, tm) in enumerate(steps):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-6)
        _params_close(jp, tp, 1e-6, f"step {i + 1}")
    # float32 accumulation is what this test exists to catch
    f32 = _run("bfloat16", batch=8, steps=1, port_acc="")[0]
    miss = abs(f32[3]["grad_norm"] - f32[1]["grad_norm"]) / f32[1]["grad_norm"]
    assert miss > 1e-5, miss


def test_unfused_step_matches_jax_float32():
    steps = _run("", batch=4, steps=3)
    for i, (jp, jm, tp, tm) in enumerate(steps):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        _params_close(jp, tp, 1e-5, f"step {i + 1}")
    last = steps[-1][2]["blocks"]["mlp"]
    for leaf in ("w_up", "w_gate"):
        cols = last[leaf].abs().amax(dim=1)
        assert 0 < int((cols == 0).sum()) < cols.numel()


def test_unfused_equals_fused_single_device():
    """Both epilogues are one AdamW step and one projection per leaf, in
    place: the same numbers to the bit on the same inputs."""
    cfg = treg.smoke_config(ARCH)
    api = tmodels.get(cfg)
    tt = ttypes.TrainConfig(microbatch=2, total_steps=2, warmup=1,
                            master_dtype="float32", param_dtype="float32",
                            compute_dtype="float32",
                            projection=ttypes.ProjectionSpec(
                                pattern=r"(w_up|w_gate)", radius=1.0))
    toks = torch.from_numpy(DataPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=SEQ + 1, global_batch=4, microbatch=2)).batch(0))
    out = {}
    for fused in (True, False):
        st = tstep.init_state(cfg, tt, api, 0, device="cpu")
        fn = tstep.make_train_step(cfg, tt, api, impl="naive", fused=fused)
        for _ in range(2):
            st, m = fn(st, {"tokens": toks})
        out[fused] = (st, float(m["grad_norm"]))
    assert out[True][1] == out[False][1]
    for a, b in zip(_tree.leaves(out[True][0]), _tree.leaves(out[False][0])):
        assert torch.equal(a, b)


class _StandIn:
    """A mesh's layout without ranks."""
    shape = {"data": 2, "model": 2}
    axis_names = ("data", "model")


def test_fused_with_a_mesh_raises():
    cfg = treg.smoke_config(ARCH)
    api = tmodels.get(cfg)
    tt = ttypes.TrainConfig(projection=ttypes.ProjectionSpec())
    from repro_torch.models.params import param_specs
    from repro_torch.parallel import sharding

    specs = param_specs(api.template(cfg), sharding.param_rules(_StandIn),
                        _StandIn.shape)
    with pytest.raises(ValueError, match="single-device/GSPMD only"):
        tstep.make_train_step(cfg, tt, api, fused=True, mesh=_StandIn,
                              param_specs=specs)
    with pytest.raises(ValueError, match="both mesh= and param_specs="):
        tstep.make_train_step(cfg, tt, api, mesh=_StandIn)


@pytest.mark.parametrize("kw", [{"telemetry_every": -5},
                                {"telemetry_every": 2.5,
                                 "telemetry_marks": True}])
def test_telemetry_raises(kw):
    cfg = treg.smoke_config(ARCH)
    tt = ttypes.TrainConfig()
    with pytest.raises(ValueError, match="telemetry"):
        tstep.make_train_step(cfg, tt, tmodels.get(cfg), **kw)


def test_a_mesh_without_a_process_group_raises():
    from repro_torch.parallel.mesh import Mesh

    with pytest.raises(RuntimeError, match="process group"):
        Mesh((2, 2), ("data", "model"))
