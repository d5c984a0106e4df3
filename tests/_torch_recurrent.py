"""Shared set-up of the recurrent families' parity tests
(``test_torch_zamba.py``, ``test_torch_xlstm.py``): parameters drawn once
in numpy with the JAX template's init statistics and handed to both
packages, the leaf-by-leaf comparisons, and three projected train steps of
each package from the same state."""

import re

import jax
import jax.numpy as jnp
import numpy as np

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.configs import types as jtypes
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.training import step as jstep
from repro_torch import _tree, interop
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.configs import types as ttypes
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.optim import adamw as tadamw
from repro_torch.training import step as tstep

# the train launcher's: mamba's and the sLSTM's w_in, mLSTM's w_gates too
PATTERN = r"(w_up|w_gate|w_in)"
_CACHE = {}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_params(template, seed):
    """A parameter tree drawn in numpy with ``init_params``' statistics
    (ones, zeros, normal of ``scale``, ``scaled`` = 1/sqrt of every axis
    but the last), leaves in sorted-path order."""
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(
        template, is_leaf=jparams.is_def)
    out = []
    for _, pd in flat:
        if pd.init in ("ones", "zeros"):
            out.append((np.ones if pd.init == "ones" else np.zeros)(
                pd.shape, np.float32))
            continue
        std = (max(np.prod(pd.shape[:-1]), 1) ** -0.5
               if pd.init == "scaled" else pd.scale)
        out.append((rng.standard_normal(pd.shape) * std).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def setup(arch, seed):
    """(JAX cfg, JAX params, port cfg, port params) of the smoke config,
    made once per arch."""
    if arch not in _CACHE:
        cfg = jreg.smoke_config(arch)
        params = numpy_params(jmodels.get(cfg).template(cfg), seed)
        _CACHE[arch] = (cfg, jax.tree_util.tree_map(jnp.asarray, params),
                        treg.smoke_config(arch),
                        interop.from_numpy_tree(params, device="cpu"))
    return _CACHE[arch]


def get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def assert_close_tree(got, want, rel, what=""):
    """Each leaf of the port's tree ``got`` within ``rel`` of the largest
    entry of the JAX tree ``want``'s leaf (same paths, same shapes)."""
    want = dict(_tree.leaves_with_paths(np_tree(want)))
    got = dict(_tree.leaves_with_paths(got))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = want[name]
        assert tuple(t.shape) == w.shape, name
        np.testing.assert_allclose(
            t.detach().float().numpy(), w, rtol=0,
            atol=rel * max(float(np.abs(w).max(initial=0.0)), 1e-30),
            err_msg=f"{what} {name}")


def template_shapes(template, isdef):
    return jax.tree_util.tree_map(lambda d: d.shape, template, is_leaf=isdef)


def _adam_unit(opt, step, tcfg):
    """Each leaf's normalised AdamW update m̂ / (√v̂ + eps) at ``step`` from
    an optimizer state's own moments, as float32 numpy arrays."""
    bc1, bc2 = 1.0 - tcfg.beta1 ** step, 1.0 - tcfg.beta2 ** step
    return {n: (np.asarray(m, np.float32) / bc1)
            / (np.sqrt(np.asarray(v, np.float32) / bc2) + tcfg.eps)
            for (n, m), v in zip(_tree.leaves_with_paths(opt["m"]),
                                 _tree.leaves(opt["v"]))}


def train_parity(arch, seed, radius, *, seq, steps=3, impl="flash",
                 adam_slack=False):
    """``steps`` steps of the port's ``make_train_step`` against JAX's (no
    mesh, float32 compute, remat on, the projection on ``PATTERN``) from
    the same state and batches: losses, gradient norms and learning rates
    within 1e-5 relative (``tests/test_torch_train.py``'s float32 bars),
    parameters within 5e-5 of each leaf's largest entry plus 1e-5 relative
    (``tests/test_torch_moe.py``'s). The gradients agree within 4e-6 of
    each leaf's largest entry, but AdamW's first update lr·g/(|g| + eps)
    turns a rounding difference δg at an entry with |g| near eps = 1e-8
    into lr·eps·δg/(|g| + eps)²: 3.4e-6 measured on ``mamba_super/w_in``,
    whose 1e-5 bar is 1.5e-6.

    ``impl`` is the port's attention (JAX's is ``"chunked"``).

    ``adam_slack`` first holds both moments, m and v, of every leaf after
    every step within 1e-5 of the leaf's largest entry + 1e-5 relative
    (``chip_smoke.py``'s held step holds the first moments so), then adds
    AdamW's sensitivity to the parameters' bar, as that held step does:
    Σ_t lr_t · |Δu_t|, Δu_t the difference of the two runs' normalised
    updates m̂ / (√v̂ + eps) at step t, each from its own (held) moments,
    per entry (3 × the leaf's largest for a projected leaf: its clip moves
    with its column's max and with θ). A leaf that starts at zero (a bias)
    has lr for its largest entry, so 5e-5 of it is 1.5e-8, below one such
    rounding's move. Returns the port's final state."""
    import torch

    cfg, jp0, tcfg, tp0 = setup(arch, seed)
    kw = dict(microbatch=2, lr=3e-4, total_steps=steps, warmup=1, remat=True,
              master_dtype="", compute_dtype="float32")
    jt = jtypes.TrainConfig(**kw, projection=jtypes.ProjectionSpec(
        pattern=PATTERN, radius=radius))
    tt = ttypes.TrainConfig(**kw, projection=ttypes.ProjectionSpec(
        pattern=PATTERN, radius=radius))
    js = {"params": jp0, "opt": jadamw.init(jp0, jt)}
    tp = _tree.tree_map(torch.clone, tp0)
    ts = {"params": tp, "opt": tadamw.init(tp, tt)}
    jfn = jax.jit(jstep.make_train_step(cfg, jt, jmodels.get(cfg),
                                        impl="chunked"))
    # the launcher's default attention: the family gate keeps it from the
    # recurrent forwards, as JAX's keeps its impl
    tfn = tstep.make_train_step(tcfg, tt, tmodels.get(tcfg), impl=impl)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=4, microbatch=2))
    matched = re.compile(PATTERN)
    slack = dict.fromkeys((n for n, _ in _tree.leaves_with_paths(tp0)), 0.0)
    for i in range(steps):
        batch = pipe.batch(i)
        js, jm = jfn(js, {"tokens": jnp.asarray(batch)})
        ts, tm = tfn(ts, {"tokens": torch.from_numpy(batch)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        if adam_slack:
            topt, jopt = _tree.tree_map(lambda x: x.numpy(), ts["opt"]), np_tree(js["opt"])
            for part in ("m", "v"):
                for name, t in _tree.leaves_with_paths(topt[part]):
                    w = get(jopt[part], name)
                    np.testing.assert_allclose(
                        t, w, rtol=1e-5,
                        atol=1e-5 * max(float(np.abs(w).max(initial=0.0)), 1e-30),
                        err_msg=f"step {i + 1} {part} {name}")
            ut, uj = _adam_unit(topt, i + 1, tt), _adam_unit(jopt, i + 1, jt)
            for n, u in ut.items():
                du = float(jm["lr"]) * np.abs(u - uj[n])
                slack[n] = slack[n] + (3 * du.max() if matched.search(n)
                                       and u.ndim >= 2 else du)
        jp = np_tree(js["params"])
        for name, t in _tree.leaves_with_paths(ts["params"]):
            w = get(jp, name)
            atol = 5e-5 * max(float(np.abs(w).max(initial=0.0)), 1e-30)
            if not adam_slack:
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=atol,
                                           err_msg=f"step {i + 1} {name}")
                continue
            past = np.abs(t.numpy() - w) - 1e-5 * np.abs(w) - slack[name]
            assert past.max(initial=0.0) <= atol, (
                f"step {i + 1} {name}: {past.max():.3e} past the AdamW slack, "
                f"bar {atol:.3e}")
    return ts


def sharded_loss_on_meta(arch, impl="chunked", sizes=(2, 2), batch=4, seq=8):
    """The family's sharded loss (``make_loss_fn(mesh=, param_specs=)``),
    forward and backward, on one rank of an abstract ``sizes`` mesh over
    ("data", "model") with ``meta`` shards of the smoke config's
    parameters: returns the mesh's collective counts and
    ``models.lm.sharded_collectives``' model of them (no remat, float32)."""
    import torch

    from repro_torch.models import lm as tlm
    from repro_torch.models import params as tparams
    from repro_torch.parallel import sharding as tsharding
    from repro_torch.parallel.mesh import AbstractMesh

    cfg = treg.smoke_config(arch)
    api = tmodels.get(cfg)
    mesh = AbstractMesh(sizes, ("data", "model"))
    tpl = api.template(cfg)
    specs = tparams.param_specs(tpl, tsharding.param_rules(mesh), mesh.shape)
    table = dict(_tree.leaves_with_paths(specs))
    params = tparams.abstract_params(
        tpl, shape=lambda path, pd: tsharding.local_shape(pd.shape, table[path],
                                                          mesh))
    live = [p.requires_grad_(True) for p in _tree.leaves(params)]
    b_loc = batch // sizes[0]
    tokens = torch.empty((b_loc, seq + 1), dtype=torch.int64, device="meta")
    loss = tstep.make_loss_fn(cfg, api, impl=impl, remat=False,
                              compute_dtype=torch.float32, mesh=mesh,
                              param_specs=specs)(params, tokens)
    torch.autograd.grad(loss, live, allow_unused=True)
    got = {op: c["calls"] for op, c in mesh.counts()["by_op"].items()}
    want = tlm.sharded_collectives(cfg, specs, mesh.shape, b_loc, seq,
                                   remat=False, itemsize=4)["calls"]
    return got, want
