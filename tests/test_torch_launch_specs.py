"""The port's dry-run specs (``repro_torch/launch/specs.py``) against the JAX
package's ``repro/launch/specs.py``, on the CPU.

Held field by field or leaf by leaf: the eleven per-arch config modules;
``Tuning``/``TUNINGS``/``tuning_for``, ``apply_tuning`` (the MoE dispatch,
the xLSTM fields, ``ATTN_TUNE``, restored after each test) and
``train_config`` for every arch; ``cell_skipped`` on all 40 cells;
``abstract_train_state`` at full size for all ten archs (``meta`` tensors
on one side, JAX's ``ShapeDtypeStruct`` tree on the other: nothing is
allocated); the parameter and optimizer specs at (32, 8) and (2, 32, 8)
(a stand-in mesh with ``axis_names`` and ``devices.shape`` on the JAX
side); ``cache_spec_tree`` and ``lm.cache_specs`` on each family's cache.
``attention_chunked`` with ``chunk=256`` and bf16 probabilities is held to
JAX's under the same ``ATTN_TUNE`` within 1e-2 (the probabilities' one
bf16 rounding), and with float32 ones within 1e-5.

The one deliberate difference: an int8 moment's block scales ``s`` take
their parameter's spec in the port (each rank holds its own blocks'
scales, ``optim/adamw.py``), while JAX replicates their trailing axis.

The abstract mesh's collective counts equal ``training.step.
step_collectives`` on smoke train cells, and the mesh, the dry run and the
hillclimb refuse a real tensor. The dry-run CLI runs ``granite-3-2b ×
decode_32k × single`` at full size on ``meta`` and records a
``long_500k`` skip, with the JAX record's keys. JAX's own dry-run cells do
not run under this JAX (ROADMAP.md § 3, items 8 and 9), so they are not a
reference.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.types import SHAPES as JSHAPES
from repro.launch import specs as JSP
from repro.models import layers as JL
from repro_torch.configs import registry as treg
from repro_torch.configs.types import SHAPES
from repro_torch.launch import specs as TSP
from repro_torch.models import layers as TL

ARCHS = list(treg.ARCHS)
ASSIGNED = list(treg.ASSIGNED)
ARCH_MODULES = ["chameleon_34b", "deepseek_v3_671b", "granite_3_2b",
                "h2o_danube_1_8b", "kimi_k2_1t_a32b", "qwen3_32b", "sae_paper",
                "stablelm_1_6b", "whisper_large_v3", "xlstm_1_3b", "zamba2_7b"]
MESHES = {"single": ((32, 8), ("data", "model")),
          "multi": ((2, 32, 8), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _restore_attn_tune():
    saved = dict(TL.ATTN_TUNE), dict(JL.ATTN_TUNE)
    yield
    TL.ATTN_TUNE.clear()
    TL.ATTN_TUNE.update(saved[0])
    JL.ATTN_TUNE.clear()
    JL.ATTN_TUNE.update(saved[1])


def _jmesh(kind):
    sizes, names = MESHES[kind]
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=sizes))


def _tmesh(kind):
    return dict(zip(MESHES[kind][1], MESHES[kind][0]))


def _jax_leaves(tree):
    """``{path: leaf}`` of a JAX tree, paths joined by '/' as the port's."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _torch_leaves(tree):
    from repro_torch import _tree

    return dict(_tree.leaves_with_paths(tree))


# ------------------------------------------------------------- the configs
@pytest.mark.parametrize("module", ARCH_MODULES)
def test_per_arch_modules(module):
    import importlib

    t = importlib.import_module(f"repro_torch.configs.{module}")
    j = importlib.import_module(f"repro.configs.{module}")
    assert t.ARCH_ID == j.ARCH_ID
    assert dataclasses.asdict(t.CONFIG) == dataclasses.asdict(j.CONFIG)
    assert dataclasses.asdict(t.SMOKE) == dataclasses.asdict(j.SMOKE)
    if module == "qwen3_32b":
        assert t.CONFIG.name == "qwen3-32b"
    if module == "sae_paper":
        assert t.SMOKE.family == "sae"


@pytest.mark.parametrize("arch", ARCHS)
def test_tuning_and_train_config_equal_jax(arch):
    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    assert dataclasses.asdict(TSP.tuning_for(tcfg)) == \
        dataclasses.asdict(JSP.tuning_for(jcfg))
    assert [f.name for f in dataclasses.fields(TSP.Tuning)] == \
        [f.name for f in dataclasses.fields(JSP.Tuning)]
    assert dataclasses.asdict(TSP.Tuning()) == dataclasses.asdict(JSP.Tuning())
    shape = SHAPES["train_4k"]
    t = TSP.train_config(tcfg, shape, TSP.tuning_for(tcfg))
    j = JSP.train_config(jcfg, JSHAPES["train_4k"], JSP.tuning_for(jcfg))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_tunings_table_equal_jax():
    assert set(TSP.TUNINGS) == set(JSP.TUNINGS)
    for k in TSP.TUNINGS:
        assert dataclasses.asdict(TSP.TUNINGS[k]) == dataclasses.asdict(JSP.TUNINGS[k])


@pytest.mark.parametrize("arch,over", [
    ("kimi-k2-1t-a32b", dict(moe_dispatch="scatter")),
    ("deepseek-v3-671b", dict(moe_dispatch="scatter", attn_chunk=2048)),
    ("xlstm-1.3b", dict(xlstm_chunk=128)),
    ("xlstm-1.3b", dict(xlstm_shard_r=True, xlstm_chunk=256)),
    ("stablelm-1.6b", dict(attn_probs_bf16=True, attn_chunk=512)),
    ("granite-3-2b", dict()),
])
def test_apply_tuning_equal_jax(arch, over):
    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    t = TSP.apply_tuning(tcfg, dataclasses.replace(TSP.tuning_for(tcfg), **over))
    j = JSP.apply_tuning(jcfg, dataclasses.replace(JSP.tuning_for(jcfg), **over))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TL.ATTN_TUNE["chunk"] == JL.ATTN_TUNE["chunk"]
    pd = TL.ATTN_TUNE["probs_dtype"]
    assert (pd is None) == (JL.ATTN_TUNE["probs_dtype"] is None)
    if pd is not None:
        assert pd == torch.bfloat16 and JL.ATTN_TUNE["probs_dtype"] == jnp.bfloat16
    TSP.reset_attn_tune()
    assert TL.ATTN_TUNE == {"chunk": 1024, "probs_dtype": None}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("probs", [None, "bfloat16"])
def test_attention_chunked_under_attn_tune(probs, causal):
    rng = np.random.default_rng(3 + 2 * causal)
    q = rng.normal(size=(2, 600, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 600, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 600, 2, 16)).astype(np.float32)
    TL.ATTN_TUNE.update(chunk=256, probs_dtype=getattr(torch, probs) if probs else None)
    JL.ATTN_TUNE.update(chunk=256, probs_dtype=getattr(jnp, probs) if probs else None)
    got = TL.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal, impl="chunked")
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, impl="chunked")
    tol = 1e-2 if probs else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    if probs:   # the knob reaches the P·V product
        TL.ATTN_TUNE.update(probs_dtype=None)
        f32 = TL.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, impl="chunked")
        assert not torch.equal(f32, got)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cell_skipped_equal_jax(arch):
    for name in SHAPES:
        assert TSP.cell_skipped(treg.get_arch(arch), SHAPES[name]) == \
            JSP.cell_skipped(jreg.get_arch(arch), JSHAPES[name])
    assert TSP.FULL_ATTENTION_500K_SKIP == JSP.FULL_ATTENTION_500K_SKIP


# --------------------------------------------------------- abstract state
@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_train_state_equal_jax(arch):
    from repro import models as jmodels
    from repro_torch import models as tmodels

    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    t_tc = TSP.train_config(tcfg, SHAPES["train_4k"], TSP.tuning_for(tcfg))
    j_tc = JSP.train_config(jcfg, JSHAPES["train_4k"], JSP.tuning_for(jcfg))
    t = _torch_leaves(TSP.abstract_train_state(tcfg, t_tc, tmodels.get(tcfg)))
    j = _jax_leaves(JSP.abstract_train_state(jcfg, j_tc, jmodels.get(jcfg)))
    assert list(t) == list(j)
    for path in t:
        assert t[path].is_meta
        assert tuple(t[path].shape) == tuple(j[path].shape), path
        assert str(t[path].dtype)[6:] == j[path].dtype.name, path


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_state_specs_equal_jax(arch, kind):
    from repro import models as jmodels
    from repro.models import params as JPM
    from repro.optim import adamw as jadamw
    from repro.parallel import sharding as JSH
    from repro_torch import models as tmodels

    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    t_tc = TSP.train_config(tcfg, SHAPES["train_4k"], TSP.tuning_for(tcfg))
    j_tc = JSP.train_config(jcfg, JSHAPES["train_4k"], JSP.tuning_for(jcfg))
    got = TSP.state_shardings(tcfg, t_tc, tmodels.get(tcfg), _tmesh(kind))
    # JAX's state_shardings without its NamedSharding step (no devices here)
    jm = _jmesh(kind)
    rules = JSH.param_rules(jm, fsdp=True)
    if "pod" in jm.axis_names and jcfg.name.startswith(("kimi", "deepseek")):
        rules = dict(rules, embed=("pod", "data"))
    tpl = jmodels.get(jcfg).template(jcfg)
    pspecs = JPM.param_specs(tpl, rules, JSH.mesh_shape_dict(jm))
    want = {"params": pspecs, "opt": jadamw.state_specs(pspecs, tpl, j_tc)}
    t, j = _torch_leaves(got), _jax_leaves(want)
    assert list(t) == list(j)
    int8 = t_tc.moment_dtype == "int8"
    for path in t:
        if int8 and path.endswith("/s"):
            # the documented difference (module docstring)
            param = t[path[:-1] + "q"]
            assert t[path] == param
            assert tuple(j[path]) == tuple(param[:-1]) + (None,)
            continue
        assert t[path] == tuple(j[path]), path


FAMILY_CACHES = ["granite-3-2b", "h2o-danube-1.8b", "deepseek-v3-671b",
                 "zamba2-7b", "xlstm-1.3b", "whisper-large-v3"]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", FAMILY_CACHES)
def test_cache_spec_tree_equal_jax(arch, shape):
    from repro import models as jmodels
    from repro.models import lm as jlm
    from repro.parallel import sharding as JSH
    from repro_torch import models as tmodels
    from repro_torch.models import lm as tlm
    from repro_torch.parallel import sharding as TSH

    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    sh = SHAPES[shape]
    cache = tmodels.get(tcfg).make_cache(tcfg, sh.global_batch, sh.seq_len,
                                         dtype=torch.bfloat16, device="meta")
    jcache = jax.eval_shape(lambda: jmodels.get(jcfg).make_cache(
        jcfg, sh.global_batch, sh.seq_len, dtype=jnp.bfloat16))
    assert {k: tuple(v.shape) for k, v in _torch_leaves(cache).items()} == \
        {k: tuple(v.shape) for k, v in _jax_leaves(jcache).items()}
    for kind in MESHES:
        t = _torch_leaves(TSH.cache_spec_tree(tcfg, _tmesh(kind), cache, sh))
        j = _jax_leaves(JSH.cache_spec_tree(jcfg, _jmesh(kind), jcache,
                                            JSHAPES[shape]))
        assert t == {k: tuple(v) for k, v in j.items()}
        if tcfg.family in ("dense", "moe", "vlm"):
            rules = TSH.act_rules(_tmesh(kind))
            jrules = JSH.act_rules(_jmesh(kind), JSHAPES[shape])
            assert _torch_leaves(tlm.cache_specs(tcfg, rules, _tmesh(kind))) == {
                k: tuple(v) for k, v in _jax_leaves(
                    jlm.cache_specs(jcfg, jrules, _tmesh(kind))).items()}


# ------------------------------------------------------- the abstract mesh
@pytest.mark.parametrize("sizes,names", [((2, 2), ("data", "model")),
                                         ((2, 1, 2), ("pod", "data", "model"))])
def test_abstract_mesh_counts_equal_step_collectives(sizes, names):
    from repro_torch.parallel.mesh import AbstractMesh
    from repro_torch.training import step as TS

    cfg = treg.smoke_config("granite-3-2b")
    mesh = AbstractMesh(sizes, names)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    tune = dataclasses.replace(TSP.tuning_for(cfg), microbatch=4)
    cell = TSP.train_cell(cfg, shape, mesh, tune=tune)
    state, batch = cell["args"]
    assert all(t.is_meta for t in _torch_leaves(state).values())
    mesh.reset_counts()
    cell["fn"](state, batch)
    model = TS.step_collectives(cfg, cell["tcfg"], cell["specs"]["state"]["params"],
                                mesh, tuple(batch["tokens"].shape))
    got = mesh.counts()["by_op"]
    assert {op: c["calls"] for op, c in got.items()} == model["calls"]
    assert {op: c["bytes"] for op, c in got.items()} == model["bytes"]
    assert sum(mesh.axis_bytes().values()) == mesh.counts()["bytes"]


@pytest.mark.parametrize("arch", ["whisper-large-v3", "zamba2-7b", "xlstm-1.3b"])
def test_abstract_mesh_train_cell_of_each_family(arch):
    """The audio, hybrid and recurrent families' train cells walk on
    ``meta`` under a (2, 2) abstract mesh (the smoke configs, 8 × 16 tokens
    in micro-batches of 4): the walk's collectives by op, calls and bytes,
    equal ``step_collectives``' model."""
    from repro_torch.parallel.mesh import AbstractMesh
    from repro_torch.training import step as TS

    cfg = treg.smoke_config(arch)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    tune = dataclasses.replace(TSP.tuning_for(cfg), microbatch=4)
    cell = TSP.train_cell(cfg, shape, mesh, tune=tune)
    state, batch = cell["args"]
    mesh.reset_counts()
    cell["fn"](state, batch)
    model = TS.step_collectives(cfg, cell["tcfg"], cell["specs"]["state"]["params"],
                                mesh, tuple(batch["tokens"].shape))
    got = mesh.counts()["by_op"]
    assert {op: c["calls"] for op, c in got.items()} == model["calls"]
    assert {op: c["bytes"] for op, c in got.items()} == model["bytes"]
    assert got["psum"]["calls"] > 0 and got["all_gather"]["calls"] > 0


def test_abstract_mesh_refuses_real_tensors():
    from repro_torch.parallel.mesh import AbstractMesh

    mesh = AbstractMesh((2, 4), ("data", "model"), coords={"data": 1, "model": 3})
    assert mesh.rank == 7 and mesh.axis_index("model") == 3 and mesh.size == 8
    x = torch.ones(4, 3)
    for call in (lambda: mesh.psum(x, "model"), lambda: mesh.pmax(x, "data"),
                 lambda: mesh.all_gather(x, "model", 0)):
        with pytest.raises(ValueError, match="meta tensors"):
            call()
    assert mesh.counts()["calls"] == 0
    out = mesh.all_gather(torch.empty(4, 3, device="meta"), "model", 0)
    assert out.is_meta and out.shape == (16, 3)
    assert mesh.psum(torch.empty(4, 3, device="meta"), ("data", "model")).is_meta
    assert mesh.counts()["by_op"]["all_gather"] == {"calls": 1, "bytes": 16 * 3 * 4}
    with pytest.raises(ValueError, match="not a rank"):
        AbstractMesh((2, 4), ("data", "model"), coords={"data": 2, "model": 0})


# ------------------------------------------------------------ the dry run
JAX_RECORD_KEYS = {"arch", "shape", "mesh", "time", "status", "lower_s",
                   "compile_s", "chips", "memory", "roofline", "model_flops",
                   "params_total", "params_active", "useful_ratio"}


def test_dryrun_cli_records_a_decode_cell_and_a_skip(tmp_path, capsys):
    import repro.roofline.analysis as jan
    from repro_torch.launch import dryrun

    rc = dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                      "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "granite-3-2b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and JAX_RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "generated_code_bytes"}
    assert rec["memory"]["generated_code_bytes"] is None
    assert {f.name for f in dataclasses.fields(jan.Roofline)} <= set(rec["roofline"])
    assert rec["chips"] == 256 and rec["roofline"]["chips"] == 256
    # a serving cell: the single-device step per chip, no collective term
    assert rec["roofline"]["t_collective"] is None and "one device" in rec["note"]
    assert rec["roofline"]["bottleneck"] == "memory"
    # every chip reads at least its share of the bf16 weights
    n = rec["params_total"]
    assert rec["roofline"]["bytes_global"] >= 2 * n
    assert rec["memory"]["argument_bytes"] > 2 * n / 8
    assert rec["model_flops"] == 2.0 * rec["params_active"] * 128
    rc = dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                      "--mesh", "single", "--out", str(tmp_path)])
    skip = json.loads((tmp_path / "granite-3-2b__long_500k__single.json").read_text())
    assert rc == 0 and skip["status"] == "skipped"
    assert skip["reason"] == JSP.cell_skipped(jreg.get_arch("granite-3-2b"),
                                              JSHAPES["long_500k"])
    out = capsys.readouterr().out
    assert "dry-run sweep done: 1 ok/skip, 0 failed" in out


def test_dryrun_records_the_mesh_refusal(tmp_path):
    """The MoE family runs under a mesh: deepseek-v3's decode cell on the
    multi-pod mesh walks to a roofline, as JAX's does. Its train cells
    (int8 AdamW moments, JAX's tuning) meet the one refusal left, int8
    blocks that a sharded trailing axis splits (``adamw.check_int8_mesh``),
    when the step is built, before any walk."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh

    rec = dryrun.run_cell("deepseek-v3-671b", "decode_32k", "multi",
                          verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["bottleneck"] == "memory"
    cfg = treg.smoke_config("deepseek-v3-671b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=128)
    tune = dataclasses.replace(
        TSP.tuning_for(treg.get_arch("deepseek-v3-671b")), microbatch=64)
    assert tune.moment_dtype == "int8"
    with pytest.raises(ValueError, match="int8 moments quantize"):
        TSP.train_cell(cfg, shape, make_abstract_mesh("single"), tune=tune)


def test_dryrun_and_hillclimb_refuse_real_tensors(tmp_path):
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.parallel.mesh import AbstractMesh

    cfg = treg.smoke_config("granite-3-2b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    cell = TSP.train_cell(cfg, shape, AbstractMesh((2, 2), ("data", "model")),
                          tune=dataclasses.replace(TSP.Tuning(), microbatch=4))
    state, batch = cell["args"]
    bad = dict(cell, args=(state, {"tokens": torch.zeros(2, 4, 17, dtype=torch.int32)}))
    with pytest.raises(ValueError, match="meta tensors"):
        dryrun.walk_cell(bad)
    # the MoE variants get past the mesh (their sharded forward) and end in
    # the int8 refusal, when the step is built; a failed variant counts
    with pytest.raises(ValueError, match="int8 moments quantize"):
        hillclimb.run_variant("kimi_scatter", str(tmp_path))
    rec = json.loads((tmp_path / "kimi_scatter.json").read_text())
    assert rec["status"] == "error" and "int8" in rec["error"]
    assert hillclimb.main(["--cell", "deepseek_scatter,xlstm_chunk128",
                           "--out", str(tmp_path)]) == 1
