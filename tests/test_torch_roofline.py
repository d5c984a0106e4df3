"""The port's cost walk and roofline (``repro_torch/roofline``) on the CPU.

* The walk of the smoke granite forward (one device, ``impl="chunked"``)
  counts the FLOPs that ``repro.roofline.hlo_parse.analyze_text`` counts in
  JAX's compiled forward, within 1 %: both count matmul-class operations
  only, and both forwards run the same contractions (the chunked
  attention's per-chunk einsums, which XLA keeps inside its scan and
  ``hlo_parse`` multiplies by the trip count). Bytes are not compared: XLA
  fuses, eager PyTorch does not.
* A walk of a train step on CPU tensors equals the walk of the same step on
  ``meta`` tensors, FLOPs and bytes exactly; a walk under inference mode
  equals one with autograd on.
* One walked micro-batch counted three times (``Costs.repeat``) equals the
  walk of a three-micro-batch step: FLOPs, bytes, collectives by op and by
  axis, and the peak.
* The kernels' wrappers declare their table's costs inside a walk on
  ``meta`` and launch nothing; outside a walk a ``meta`` tensor still
  raises.
* ``roofline_table``, ``dryrun_table`` and ``perf_table`` render the
  strings JAX's ``repro.roofline.report`` renders for the same records
  (that module imports no JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.types import SHAPES
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import costs as C


def _smoke_params(cfg, seed=0):
    from repro_torch import models
    from repro_torch.models import params as PM

    return PM.init_params(models.get(cfg).template(cfg), seed, device="cpu")


def test_forward_flops_equal_hlo_parse():
    import jax
    import jax.numpy as jnp

    from repro import models as jm
    from repro.configs import registry as jreg
    from repro.models import params as JPM
    from repro.roofline import hlo_parse
    from repro_torch import interop, models as tm

    jcfg, tcfg = jreg.smoke_config("granite-3-2b"), treg.smoke_config("granite-3-2b")
    params = JPM.init_params(jm.get(jcfg).template(jcfg), jax.random.PRNGKey(0),
                             jnp.float32)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
    fwd = jax.jit(lambda p, t: jm.get(jcfg).forward(p, t, jcfg, impl="chunked",
                                                    remat=False)[0])
    want = hlo_parse.analyze_text(fwd.lower(params, jnp.asarray(tokens))
                                  .compile().as_text())
    tparams = interop.from_numpy_tree(jax.tree_util.tree_map(np.asarray, params),
                                      device="cpu")
    with C.walk() as w:
        tm.get(tcfg).forward(tparams, torch.from_numpy(tokens).long(), tcfg,
                             impl="chunked", remat=False)
    assert want.flops > 0
    assert abs(w.costs.flops / want.flops - 1) < 0.01
    assert w.costs.bytes > 0 and w.costs.coll_bytes == 0


def _smoke_step(device, fused, n_micro=2, mb=2, seq=16):
    from repro_torch import models
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.launch import specs as SP
    from repro_torch.training import step as TS

    cfg = treg.smoke_config("granite-3-2b")
    tcfg = TrainConfig(microbatch=mb, remat=True, projection=ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=5.0))
    api = models.get(cfg)
    if device == "meta":
        state = SP.abstract_train_state(cfg, tcfg, api)
        tokens = torch.empty((n_micro, mb, seq + 1), dtype=torch.int32,
                             device="meta")
    else:
        state = TS.init_state(cfg, tcfg, api, 0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (n_micro, mb, seq + 1)).astype(np.int32))
    return TS.make_train_step(cfg, tcfg, api, impl="chunked", fused=fused), \
        state, tokens


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_walk_equals_meta_walk(fused):
    walks = {}
    for device in ("cpu", "meta"):
        step, state, tokens = _smoke_step(device, fused)
        with C.walk() as w:
            step(state, {"tokens": tokens})
        walks[device] = w.costs
    cpu, meta = walks["cpu"], walks["meta"]
    assert cpu.flops == meta.flops > 0
    assert cpu.bytes == meta.bytes > 0
    assert dict(cpu.dot_flops_by_shape) == dict(meta.dot_flops_by_shape)
    assert cpu.peak_bytes == meta.peak_bytes > 0


def test_inference_mode_walk_equals_grad_mode_walk():
    from repro_torch import models

    cfg = treg.smoke_config("granite-3-2b")
    params = _smoke_params(cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)))
    out = {}
    for inference in (False, True):
        with C.walk() as w, torch.inference_mode(inference):
            models.get(cfg).forward(params, tokens, cfg, impl="chunked",
                                    remat=False)
        out[inference] = (w.costs.flops, w.costs.bytes)
    assert out[True] == out[False]


@pytest.mark.parametrize("sizes,names", [((2, 2), ("data", "model")),
                                         ((2, 1, 2), ("pod", "data", "model"))])
def test_one_micro_batch_repeated_equals_a_full_walk(sizes, names):
    from repro_torch.launch import specs as SP
    from repro_torch.parallel.mesh import AbstractMesh

    cfg = treg.smoke_config("granite-3-2b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=12)
    tune = dataclasses.replace(SP.Tuning(), microbatch=4)
    got = {}
    for n in (1, 3):
        mesh = AbstractMesh(sizes, names)
        cell = SP.train_cell(cfg, shape, mesh, tune=tune)
        state, batch = cell["args"]
        assert cell["n_micro"] == 3
        with C.walk(mesh=mesh) as w:
            cell["fn"](state, {"tokens": batch["tokens"][:n]})
        got[n] = w.costs
    assert got[3].passes == {"micro_batch": 3}
    full, rep = got[3], got[1].repeat("micro_batch", 3)
    assert rep.flops == full.flops > 0
    assert rep.bytes == full.bytes
    assert rep.coll_bytes == full.coll_bytes > 0
    assert dict(rep.coll_by_kind) == dict(full.coll_by_kind)
    assert dict(rep.coll_by_axis) == dict(full.coll_by_axis)
    assert rep.peak_bytes == full.peak_bytes > 0
    with pytest.raises(ValueError, match="did not run"):
        got[1].repeat("nothing", 2)


def test_walk_counts_collectives_by_op_and_axis():
    from repro_torch.parallel.mesh import AbstractMesh

    mesh = AbstractMesh((2, 4), ("data", "model"))
    x = torch.empty(8, 16, device="meta")
    with C.walk(mesh=mesh) as w:
        mesh.psum(x, "model")
        mesh.pmax(x, ("data", "model"))
        mesh.all_gather(x, "data", 0)
    c = w.costs
    assert c.coll_by_kind == {"all-reduce": 2 * 2 * 512, "all-gather": 1024}
    assert dict(c.coll_by_axis) == {"model": 1024, "data,model": 1024,
                                    "data": 1024}
    roof = TA.analyze(c, mesh.size)
    assert roof.t_collective_nvlink == 1024 / TA.NVLINK_BW
    assert roof.t_collective_nic == 2048 / TA.NIC_BW
    assert roof.t_collective == roof.t_collective_nvlink + roof.t_collective_nic
    assert roof.coll_bytes_global == 3072 * 8


def test_h100_constants_and_terms():
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.NVLINK_BW, TA.NIC_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    c = C.Costs(flops=989e12, bytes=3.35e12 * 2)
    r = TA.analyze(c, 4)
    assert r.t_compute == 1.0 and r.t_memory == 2.0 and r.t_collective == 0.0
    assert r.bottleneck == "memory" and r.bound_s() == 2.0
    r = TA.analyze(c, 4, collectives=False)
    assert r.t_collective is None and r.bottleneck == "memory"
    assert TA.model_flops(10, 3, "train") == 180.0
    assert TA.model_flops(10, 3, "serve") == 60.0


def test_kernels_declare_their_costs_on_meta():
    from repro_torch.core import schedule
    from repro_torch.kernels import _build, flash_attention as fa, l1ball
    from repro_torch.kernels.codegen import lowering, tiling

    _build.reset_launches()
    q = torch.empty(2, 4, 128, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2, 128, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        fa.flash_attention(q, k, k)
    with C.walk() as w:
        o, lse = fa.flash_attention(q, k, k)
        q.requires_grad_(True)
        out = fa.flash(q, k.requires_grad_(True), k)
        out.sum().backward()
    assert o.is_meta and lse.shape == (2, 4, 128)
    kern = w.costs.kernels
    assert kern["flash_fwd"]["calls"] == 2 and kern["flash_bwd_dq"]["calls"] == 1
    assert kern["flash_bwd_dkv"]["calls"] == 1
    fwd = C.flash_fwd(q, k, True)
    # bytes: q, k, v, o once each and the float32 lse; FLOPs 4 a pair and dim
    assert fwd == (2 * (2 * q.numel() + 2 * k.numel()) + 4 * 2 * 4 * 128,
                   4 * 2 * 4 * 64 * 128 * 128 / 2)
    assert kern["flash_fwd"]["bytes"] == 2 * fwd[0]
    assert w.costs.flops >= 2 * fwd[1] + C.flash_bwd_dq(q, k)[1] \
        + C.flash_bwd_dkv(q, k)[1]
    sched = schedule.compile_schedule((64, 96), [("inf", 1), ("1", 1)])
    tp = tiling.plan_tiles(sched, torch.float32)
    y = torch.empty((3,) + tp.canon_shape, device="meta")
    with C.walk() as w:
        aggs, vfin = lowering.codegen_reduce(y, tp, ["inf"])
        u = l1ball.project_l1_batched(vfin, torch.empty(3, device="meta"))
        x = lowering.codegen_apply(y, aggs, vfin, u, tp, ["inf"])
    assert x.is_meta and vfin.shape == (3, 96)
    kern = w.costs.kernels
    assert kern["codegen_reduce"]["bytes"] == C.codegen_reduce(3 * 64 * 96, 0, 3, 96)[0]
    assert kern["l1ball"]["ops"] == C.l1ball(3, 96)[1]
    assert kern["codegen_apply"]["bytes"] == \
        C.codegen_apply(3 * 64 * 96, 0, 3, 96, False)[0]
    assert w.costs.flops == 0   # the projection kernels' operations are not matmuls
    assert sum(_build.launch_counts().values()) == 0


# ----------------------------------------------------------------- reports
RECORDS = [
    {"arch": "a-1b", "shape": "train_4k", "mesh": "single", "status": "ok",
     "compile_s": 12.3, "chips": 256,
     "memory": {"argument_bytes": 3 * 2**30, "output_bytes": 2**30,
                "temp_bytes": 5 * 2**30, "generated_code_bytes": None},
     "roofline": {"flops_global": 3.2e15, "bytes_global": 1e14,
                  "coll_bytes_global": 4e12, "chips": 256,
                  "coll_breakdown": {"all-reduce": 3e9, "all-gather": 1.5e9},
                  "t_compute": 0.0126, "t_memory": 0.1166, "t_collective": 0.31,
                  "bottleneck": "collective"},
     "useful_ratio": 0.61},
    {"arch": "a-1b", "shape": "decode_32k", "mesh": "single", "status": "ok",
     "compile_s": 0.4, "chips": 256,
     "memory": {"argument_bytes": 2**29, "output_bytes": 0, "temp_bytes": 2**20,
                "generated_code_bytes": None},
     "roofline": {"flops_global": 1e12, "bytes_global": 3e12,
                  "coll_bytes_global": None, "chips": 256, "coll_breakdown": {},
                  "t_compute": 4e-6, "t_memory": 0.0035, "t_collective": None,
                  "bottleneck": "memory"},
     "useful_ratio": None},
    {"arch": "a-1b", "shape": "long_500k", "mesh": "single", "status": "skipped",
     "reason": "skip: pure full-attention arch at 524k decode (sub-quadratic "
               "required; see DESIGN.md §5)"},
    {"arch": "b-7b", "shape": "train_4k", "mesh": "multi", "status": "error",
     "error": "ValueError: b-7b: the sharded forward covers the dense family; "
              "the sharded recurrent step waits"},
    {"arch": "b-7b", "shape": "train_4k", "mesh": "single", "status": "ok",
     "compile_s": 40.0, "chips": 256,
     "memory": {"argument_bytes": 9 * 2**30, "temp_bytes": 80 * 2**30},
     "roofline": {"flops_global": 5e16, "bytes_global": 2e15,
                  "coll_bytes_global": 1e13, "chips": 256,
                  "coll_breakdown": {"all-reduce": 4e10},
                  "t_compute": 0.2, "t_memory": 2.3, "t_collective": 12.5,
                  "bottleneck": "collective"},
     "useful_ratio": 0.02},
]


def test_report_tables_equal_jax():
    from repro.roofline import report as jrep
    from repro_torch.roofline import report as trep

    recs = sorted(RECORDS, key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    for mesh in ("single", "multi"):
        assert trep.roofline_table(recs, mesh) == jrep.roofline_table(recs, mesh)
    assert trep.dryrun_table(recs) == jrep.dryrun_table(recs)
    ok = [r for r in recs if r["status"] == "ok" and r["roofline"]["t_collective"]]
    assert trep.pick_hillclimb(ok) == jrep.pick_hillclimb(ok)
    worst, coll = trep.pick_hillclimb(recs)   # None terms count as 0
    assert coll["arch"] == "b-7b" and worst["shape"] == "decode_32k"


def test_perf_table_equals_jax_and_memory_rows(tmp_path):
    import json

    from repro.roofline import fill_experiments as jfill
    from repro_torch.roofline import fill_experiments as tfill

    base = RECORDS[0]
    variants = [dict(RECORDS[0], variant="v_a"),
                dict(RECORDS[4], variant="v_b")]
    notes = {"v_a": "a note"}
    assert tfill.perf_table(base, variants, notes) == \
        jfill.perf_table(base, variants, notes)
    assert tfill.perf_table(base, variants) == jfill.perf_table(base, variants, {})
    rows = tfill.memory_rows(RECORDS)
    assert "| a-1b × train_4k | 3.0GB | 5.0GB | ✓ |" in rows
    assert "| b-7b × train_4k | 9.0GB | 80.0GB | ✗ (89.0GB) |" in rows
    assert "fits 80 GB?" in rows and not hasattr(tfill, "NOTES")
    dr, hc = tmp_path / "dr", tmp_path / "hc"
    dr.mkdir()
    hc.mkdir()
    for i, r in enumerate(RECORDS):
        (dr / f"{i}.json").write_text(json.dumps(r))
    (hc / "stablelm_x.json").write_text(json.dumps(dict(RECORDS[4], variant="stablelm_x")))
    (dr / "base.json").write_text(json.dumps(dict(RECORDS[0], arch="stablelm-1.6b")))
    tpl = tmp_path / "t.md"
    tpl.write_text("<!-- DRYRUN_MEMORY -->\n<!-- ROOFLINE_TABLE -->\n<!-- PERF_STABLELM -->\n")
    tfill.main([str(tpl), str(tmp_path / "out.md"), "--dryrun", str(dr),
                "--hillclimb", str(hc)])
    text = (tmp_path / "out.md").read_text()
    assert "<!--" not in text and "| stablelm_x |" in text
