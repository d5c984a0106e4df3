"""The port stands alone and never falls back: ``import repro_torch`` pulls in
neither JAX nor the JAX package; no file of the port imports them; and
without a CUDA device every entry point that was not asked for the CPU
raises instead of running the plain path, as does every kernel wrapper
given a tensor that is neither on the CPU nor on a CUDA device."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
BILEVEL = [("inf", 1), ("1", 1)]


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)|"
    r".*torch\.compile|.*os\.environ)", re.M)


def test_no_file_of_the_port_imports_jax_or_repro():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("*.py")))
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; these checks are for hosts "
                    "without one")


def test_entry_points_raise_without_cuda(tmp_path):
    _no_cuda()
    from repro_torch import interop
    from repro_torch.core import plan, schedule
    from repro_torch.kernels import codegen
    from repro_torch.kernels.codegen import lowering
    from repro_torch.launch import sae_factory as cli
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import CheckpointManager
    from repro_torch.models import lm, params
    from repro_torch.serving.engine import ProjectionEngine
    from repro_torch.training import sae_factory as F

    fcfg = F.SAEFactoryConfig(layers=(0,), harvest_steps=1, seq_len=8,
                              lm_batch=2, train_steps=1, sae_batch=8,
                              microbatch=8)

    sched = schedule.compile_schedule((8, 16), BILEVEL)
    calls = [
        lambda: plan.make_plan((8, 16), torch.float32, BILEVEL),
        lambda: plan.make_plan((8, 16), torch.float32, BILEVEL,
                               method="codegen", device="cuda"),
        lambda: plan.validate_backend((8, 16), torch.float32, BILEVEL, "bisect"),
        lambda: ProjectionEngine(),
        lambda: ProjectionEngine(device="cuda", start=False),
        lambda: lowering.generate(sched, torch.float32),
        lambda: lowering.generate_batched(sched, torch.float32, device="cuda"),
        lambda: codegen.build((8, 16), BILEVEL, torch.float32),
        lambda: codegen.build_batched((8, 16), BILEVEL, torch.float32),
        lambda: interop.from_numpy_tree({"w": [1.0]}),
        lambda: params.init_params(lm.template(F._arch(fcfg)), 0),
        lambda: F.lm_for(fcfg),
        lambda: F.harvest_activations(fcfg, tmp_path / "h"),
        lambda: F.train_sae(tmp_path / "h", 0, fcfg),
        lambda: F.run_factory(fcfg, tmp_path / "r"),
        lambda: cli.main(["--out", str(tmp_path / "cli"), "--layers", "0"]),
        lambda: train_cli.main(["--smoke", "--steps", "1"]),
        lambda: train_cli.main(["--smoke", "--steps", "1", "--device", "cuda"]),
        lambda: CheckpointManager(tmp_path / "ck").restore(0),
    ]
    CheckpointManager(tmp_path / "ck").save(0, {"w": torch.zeros(1)})
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_codegen_backends_are_not_offered_on_cpu():
    from repro_torch.core import plan

    with pytest.raises(ValueError, match="not available"):
        plan.make_plan((8, 16), torch.float32, BILEVEL, method="codegen",
                       device="cpu")
    with pytest.raises(ValueError, match="not available"):
        plan.make_plan((8, 16), torch.float32, BILEVEL, radius_kind="batch",
                       method="codegen_batch", device="cpu")
    p = plan.make_plan((8, 16), torch.float32, BILEVEL, device="cpu")
    assert p.method in ("sort", "bisect", "filter")
    with pytest.raises(ValueError, match="device"):
        p(torch.empty(8, 16, device="meta"), 1.0)


def test_kernel_wrappers_launch_or_raise():
    """A tensor that is not on the CPU never reaches a plain version."""
    from repro_torch.core import schedule
    from repro_torch.kernels import l1ball
    from repro_torch.kernels.codegen import lowering, tiling

    tp = tiling.plan_tiles(schedule.compile_schedule((8, 16), BILEVEL),
                           torch.float32)
    y = torch.empty(1, 8, 16, device="meta")
    row = torch.empty(1, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        l1ball.project_l1_batched(row, torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        lowering.codegen_reduce(y, tp, ["inf"])
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        lowering.codegen_apply(y, [], row, row, tp, ["inf"])
    from repro_torch.kernels import flash_attention, ops
    qkv = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        flash_attention.flash_attention(qkv, qkv, qkv)
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        ops.attention(qkv, qkv, qkv)
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        flash_attention.flash_attention(*(t.to(torch.bfloat16) for t in (qkv,) * 3))
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        flash_attention.flash_attention_bwd(qkv, qkv, qkv, qkv, lse, qkv)
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        flash_attention.flash(qkv, qkv, qkv)
    for k in (flash_attention.KERNEL, flash_attention.TF32_KERNEL,
              flash_attention.DQ_KERNEL, flash_attention.DKV_KERNEL,
              flash_attention.DQ_TF32_KERNEL, flash_attention.DKV_TF32_KERNEL):
        assert k.launches == 0
    fn = lowering.generate_batched(schedule.compile_schedule((8, 16), BILEVEL),
                                   torch.float32, device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        fn(y, torch.ones(1, device="meta"))


def test_a_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build, l1ball

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(l1ball.KERNEL, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        l1ball.KERNEL.lib()
    assert l1ball.KERNEL.launches == 0


@pytest.mark.parametrize("name", ["KERNEL", "TF32_KERNEL", "DQ_KERNEL", "DKV_KERNEL",
                                  "DQ_TF32_KERNEL", "DKV_TF32_KERNEL"])
def test_flash_kernels_without_a_build_raise(monkeypatch, tmp_path, name):
    """The bf16 and float32 forward and both backward kernels in both types:
    a call that reaches the launch without a built library raises (no nvcc
    here), counts nothing."""
    from repro_torch.kernels import _build, flash_attention

    kern = getattr(flash_attention, name)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kern, "_lib", None)
    fn = next(iter(kern.functions))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kern.launch(fn, *([0] * len(kern.functions[fn])))
    assert kern.launches == 0


def test_flash_backward_kernels_share_one_source():
    """dQ and dK/dV in bf16 and in float32 (3×TF32): one source, one
    library, four launch counts; each type's pair shares its exports."""
    from repro_torch.kernels import _build, flash_attention as fa

    kerns = (fa.DQ_KERNEL, fa.DKV_KERNEL, fa.DQ_TF32_KERNEL, fa.DKV_TF32_KERNEL)
    assert {k.source for k in kerns} == {_build.CSRC / "flash_bwd.cu"}
    assert len({k.library for k in kerns}) == 1
    assert fa.DQ_KERNEL.functions == fa.DQ_TF32_KERNEL.functions
    assert fa.DKV_KERNEL.functions == fa.DKV_TF32_KERNEL.functions
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tf32",
            "flash_bwd_dkv_tf32"} <= set(_build.launch_counts())


def test_flash_forward_kernels_share_one_source_and_count_apart():
    """The bf16 and the float32 (3×TF32) forward: one export of
    csrc/flash_fwd.cu, one library, two launch counts."""
    from repro_torch.kernels import _build, flash_attention

    bf16, f32 = flash_attention.KERNEL, flash_attention.TF32_KERNEL
    assert bf16.source == f32.source == _build.CSRC / "flash_fwd.cu"
    assert bf16.library == f32.library
    assert bf16.functions == f32.functions
    assert {"flash_fwd", "flash_fwd_tf32"} <= set(_build.launch_counts())


GOLDEN_WRAPPERS = ("colmax", "clip", "trilevel_reduce", "trilevel_apply",
                   "bilevel_l1inf_fused", "trilevel_l1infinf_fused")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", GOLDEN_WRAPPERS)
def test_golden_wrappers_launch_or_raise(name, dtype):
    """The golden kernels' wrappers: a tensor that is not on the CPU never
    reaches a plain version (the fused pipelines take bf16 too)."""
    from repro_torch.kernels import bilevel_l1inf as bi, trilevel_l1infinf as tri

    y2 = torch.empty(8, 16, device="meta", dtype=dtype)
    y3 = torch.empty(2, 8, 16, device="meta", dtype=dtype)
    row = torch.empty(16, device="meta", dtype=dtype)
    calls = {
        "colmax": lambda: bi.colmax(y2),
        "clip": lambda: bi.clip(y2, row),
        "trilevel_reduce": lambda: tri.trilevel_reduce(y3),
        "trilevel_apply": lambda: tri.trilevel_apply(y3, y2, row),
        "bilevel_l1inf_fused": lambda: bi.bilevel_l1inf_fused(y2, 1.0),
        "trilevel_l1infinf_fused": lambda: tri.trilevel_l1infinf_fused(y3, 1.0),
    }
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        calls[name]()
    for k in (bi.COLMAX, bi.CLIP, tri.REDUCE, tri.APPLY):
        assert k.launches == 0


@pytest.mark.parametrize("module,name", [
    ("bilevel_l1inf", "COLMAX"), ("bilevel_l1inf", "CLIP"),
    ("trilevel_l1infinf", "REDUCE"), ("trilevel_l1infinf", "APPLY")])
def test_golden_kernels_without_a_build_raise(monkeypatch, tmp_path, module,
                                              name):
    """Each golden kernel: a call that reaches the launch without a built
    library raises (no nvcc here) and counts nothing."""
    import importlib

    from repro_torch.kernels import _build

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    kern = getattr(mod, name)
    assert kern.source == _build.CSRC / f"{module}.cu"
    assert kern.name in _build.launch_counts()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kern, "_lib", None)
    fn = next(iter(kern.functions))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kern.launch(fn, *([0] * len(kern.functions[fn])))
    assert kern.launches == 0


@pytest.mark.parametrize("module", ["repro_torch.runtime",
                                    "repro_torch.launch.train",
                                    "repro_torch.kernels.bilevel_l1inf",
                                    "repro_torch.kernels.trilevel_l1infinf",
                                    "repro_torch.core.exact_l1inf"])
def test_training_modules_import_neither_jax_nor_repro(module):
    code = (f"import sys, importlib; importlib.import_module({module!r})\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


class _Layout:
    """A mesh layout with no ranks behind it."""

    shape = {"data": 1, "model": 4}
    axis_names = ("data", "model")
    size = 4


def test_sharded_calls_raise_without_a_process_group():
    """A sharded entry point never runs quietly as one rank."""
    import torch.distributed as dist

    from repro_torch.core import sharded
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.parallel.mesh import Mesh

    assert not dist.is_initialized()
    calls = [
        lambda: Mesh((1, 4), ("data", "model")),
        lambda: launch_mesh.make_host_mesh(1, 4),
        lambda: launch_mesh.make_production_mesh(),
        lambda: sharded.multilevel_project_sharded(
            torch.zeros(8, 4), BILEVEL, 1.0, mesh=_Layout, spec=(None, "model")),
        lambda: sharded.multilevel_project_sharded(
            torch.zeros(8, 4), BILEVEL, 1.0, mesh=_Layout, spec=(None, "model"),
            backend="codegen"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="process group"):
            call()


def test_codegen_body_refuses_an_unshardable_design():
    """An intermediate reduce axis sharded: no splice point, so
    backend="codegen" raises instead of running the plain body."""
    from repro_torch.core import schedule
    from repro_torch.kernels.codegen import distributed

    levels = [("inf", 1), ("inf", 1), ("1", 1)]
    spec = ("model", None, None)
    assert not distributed.shardable((4, 16, 64), levels, spec, _Layout,
                                     torch.float32)
    sched = schedule.compile_schedule((4, 16, 64), levels)
    with pytest.raises(ValueError, match="no sharded codegen lowering"):
        distributed.make_codegen_schedule_body(sched, spec, _Layout,
                                               torch.float32)


def test_partial_apply_runs_its_plain_version_only_on_the_cpu(monkeypatch):
    from repro_torch.core import schedule
    from repro_torch.kernels.codegen import lowering, tiling

    def no_launch(*args):
        raise AssertionError("the kernel was launched for a CPU tensor")

    monkeypatch.setattr(lowering.PARTIAL_APPLY, "launch", no_launch)
    levels = [("inf", 1), ("1", 1), ("1", 1)]
    tp = tiling.plan_tiles(schedule.compile_schedule((4, 8, 16), levels),
                           torch.float32)
    gen = torch.Generator().manual_seed(0)
    yc = torch.randn((2,) + tp.canon_shape, generator=gen)
    aggs, _ = lowering.codegen_reduce(yc, tp, ["inf", "1"])
    w = torch.rand(aggs[-1].shape, generator=gen)
    got = lowering.codegen_partial_apply(yc, aggs, w, tp, ["inf", "1"])
    assert torch.equal(got, lowering.partial_apply_plain(yc, aggs, w, ["inf", "1"]))
    assert lowering.PARTIAL_APPLY.launches == 0
    meta = [t.to("meta") for t in (yc, aggs[0], w)]
    with pytest.raises(ValueError, match="CUDA kernel needs a CUDA tensor"):
        lowering.codegen_partial_apply(meta[0], [meta[1]], meta[2], tp,
                                       ["inf", "1"])


def test_partial_apply_shares_the_apply_source():
    from repro_torch.kernels import _build
    from repro_torch.kernels.codegen import lowering

    assert lowering.PARTIAL_APPLY.source == lowering.APPLY.source \
        == _build.CSRC / "codegen_apply.cu"
    assert {"codegen_apply", "codegen_partial_apply"} <= set(_build.launch_counts())


@pytest.mark.parametrize("module", ["repro_torch.core.sharded",
                                    "repro_torch.kernels.codegen.distributed",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.parallel.sharding",
                                    "repro_torch.optim.projection_hook"])
def test_mesh_modules_import_neither_jax_nor_repro(module):
    test_training_modules_import_neither_jax_nor_repro(module)
    worker = ROOT / "tests" / "_torch_sharded_worker.py"
    assert not _FORBIDDEN.findall(worker.read_text())


# ------------------------------------------------ the cached launch path
def _stand_in(monkeypatch, kern, rc):
    """Bind a stand-in ctypes function in place of ``kern``'s first export,
    as a load binds the real one, and libc's ``strerror`` as its error
    string: the launch path runs with no nvcc and no card. Returns the
    export's name and the list of argument tuples it was called with."""
    import ctypes

    from repro_torch.kernels import _build

    fn = next(iter(kern.functions))
    calls = []

    def body(*args):
        calls.append(args)
        return rc

    stand_in = ctypes.CFUNCTYPE(ctypes.c_int, *kern.functions[fn])(body)
    strerror = ctypes.CDLL(None).strerror
    strerror.argtypes, strerror.restype = [ctypes.c_int], ctypes.c_char_p

    def no_lib():
        raise AssertionError("a launch after the load went through lib()")

    monkeypatch.setattr(kern, "_lib", object())  # loaded
    monkeypatch.setattr(kern, "_fns", {fn: stand_in, _build.ERROR_STRING: strerror})
    monkeypatch.setattr(kern, "lib", no_lib)
    monkeypatch.setattr(kern, "launches", 0)
    return fn, calls


@pytest.mark.parametrize("module,name", [
    ("bilevel_l1inf", "CLIP"), ("bilevel_l1inf", "COLMAX"),
    ("flash_attention", "DQ_KERNEL"), ("flash_attention", "DKV_KERNEL")])
def test_cached_launch_raises_on_an_error_code(monkeypatch, module, name):
    """A non-zero return code raises with the library's own error string
    and counts nothing, through the function bound at load."""
    import importlib

    kern = getattr(importlib.import_module(f"repro_torch.kernels.{module}"), name)
    fn, calls = _stand_in(monkeypatch, kern, 2)
    with pytest.raises(RuntimeError, match=r"CUDA error 2 \(No such file"):
        kern.launch(fn, *([0] * len(kern.functions[fn])))
    assert len(calls) == 1 and kern.launches == 0


@pytest.mark.parametrize("module,name", [
    ("bilevel_l1inf", "CLIP"), ("flash_attention", "DQ_KERNEL")])
def test_cached_launch_counts_each_launch(monkeypatch, module, name):
    import importlib

    kern = getattr(importlib.import_module(f"repro_torch.kernels.{module}"), name)
    fn, calls = _stand_in(monkeypatch, kern, 0)
    n_args = len(kern.functions[fn])
    for i in range(3):
        kern.launch(fn, *([i] * n_args))
    assert kern.launches == 3
    assert [c[-2] for c in calls] == [0, 1, 2]  # each call's arguments passed on


def _reach_the_launch(monkeypatch):
    """Let a meta tensor through the wrappers' CUDA gate and stream lookup,
    so a call reaches ``Kernel.launch`` on a host with no card."""
    from repro_torch import _device
    from repro_torch.kernels import _build

    monkeypatch.setattr(_device, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "stream_handle", lambda t: 0)


def _spy_on_to(monkeypatch):
    """Record every ``Tensor.to`` call (the radius's cast to Y's type)."""
    calls = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        calls.append((self.dtype, args, kwargs))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    return calls


def test_clip_wrapper_launches_its_cached_shape(monkeypatch):
    """The clip wrapper makes one export call with Y's dtype code and the
    shape the uncached ``stream_shape`` gives (aligned: meta tensors start
    at 0), for aligned and ragged widths; it casts a float32 radius to a
    bf16 Y's type and makes no ``.to`` call when the radius is in Y's type
    already."""
    from repro_torch.kernels import bilevel_l1inf as bi

    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, bi.CLIP, 0)
    to_calls = _spy_on_to(monkeypatch)
    for dtype in (torch.float32, torch.bfloat16):
        for n, m in ((1000, 10000), (8192, 2048), (37, 1001), (1, 128), (5, 7)):
            y = torch.empty(n, m, device="meta", dtype=dtype)
            for u_dtype in (torch.float32, dtype):
                del to_calls[:]
                before = len(calls)
                x = bi.clip(y, torch.empty(m, device="meta", dtype=u_dtype))
                assert x.shape == (n, m) and x.dtype == dtype
                assert len(calls) == before + 1
                vec, _ = bi.stream_shape.__wrapped__(1, n, m, y.element_size(),
                                                     True)
                assert calls[-1][3:-1] == (bi.DTYPE_CODES[dtype], vec, n, m)
                assert len(to_calls) == (u_dtype != dtype)
    assert bi.CLIP.launches == len(calls) == 20


def test_trilevel_apply_wrapper_launches_its_cached_shape(monkeypatch):
    """The tri-level apply makes one export call with Y's dtype code and
    ``stream_shape``'s pack width and plane groups (cached), and no
    ``.to`` call when u1 is in Y's type already; a float32 u1 with a bf16
    Y is cast once."""
    from repro_torch.kernels import bilevel_l1inf as bi
    from repro_torch.kernels import trilevel_l1infinf as tri

    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, tri.APPLY, 0)
    to_calls = _spy_on_to(monkeypatch)
    shapes = [(256, 32, 2048), (32, 1000, 2000), (3, 8, 1001), (3, 17, 130),
              (1, 64, 257), (2, 1, 9)]
    for dtype in (torch.float32, torch.bfloat16):
        for c, n, m in shapes:
            y = torch.empty(c, n, m, device="meta", dtype=dtype)
            v2 = torch.empty(n, m, device="meta", dtype=dtype)
            for u_dtype in (torch.float32, dtype):
                del to_calls[:]
                before = len(calls)
                x = tri.trilevel_apply(y, v2, torch.empty(m, device="meta",
                                                          dtype=u_dtype))
                assert x.shape == (c, n, m) and x.dtype == dtype
                assert len(calls) == before + 1
                shape = bi.stream_shape.__wrapped__(c, n, m, y.element_size(),
                                                    True)
                assert calls[-1][4:-1] == (bi.DTYPE_CODES[dtype], shape[0], c,
                                           n, m, *shape[1:])
                assert len(to_calls) == (u_dtype != dtype)
    assert tri.APPLY.launches == len(calls) == 4 * len(shapes)


def test_colmax_wrapper_launches_one_kernel_with_its_shape(monkeypatch):
    """The colmax wrapper makes one launch, hands the kernel Y's dtype code
    and ``colmax_shape``'s packs, and returns its one allocation: whole
    columns per CTA, at most ``COLMAX_CTAS`` of them (one wave) where the
    packs allow, each warp load at least ``COLMAX_SEGMENT`` bytes of a row."""
    import math

    from repro_torch.kernels import bilevel_l1inf as bi

    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, bi.COLMAX, 0)
    for dtype in (torch.float32, torch.bfloat16):
        for n, m in ((1000, 10000), (8192, 2048), (37, 1001), (1, 128)):
            y = torch.empty(n, m, device="meta", dtype=dtype)
            v = bi.colmax(y)
            assert v.shape == (m,) and v.dtype == dtype
            es = y.element_size()
            vec = 16 // es if m % (16 // es) == 0 else 1
            packs, ctas = bi.colmax_shape.__wrapped__(m, vec, es)
            assert calls[-1][2:-1] == (bi.DTYPE_CODES[dtype], vec, n, m, packs)
            assert packs & (packs - 1) == 0 and bi.COLMAX_THREADS % packs == 0
            assert ctas == math.ceil(math.ceil(m / vec) / packs)
            assert ctas <= bi.COLMAX_CTAS or packs == bi.COLMAX_THREADS
            assert packs * vec * es >= min(bi.COLMAX_SEGMENT, m * es)
    assert bi.COLMAX.launches == 8


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.empty(4, 8, device="meta", dtype=torch.float16),),
     "float32 or bfloat16"),
    (lambda: (torch.empty(4, 8, device="meta"),
              torch.empty(8, device="meta", dtype=torch.bfloat16)),
     "every operand must be"),
    (lambda: (torch.empty(4, 8, device="meta"), torch.empty(8)),
     "every operand must be"),
    (lambda: (torch.empty(8, 4, device="meta").t(),), "contiguous"),
    (lambda: (torch.empty(0, 8, device="meta"),), "non-empty"),
], ids=["dtype", "mixed_dtype", "mixed_device", "strided", "empty"])
def test_golden_operand_checks_refuse(monkeypatch, make, match):
    """``check_operands``, shared by the four golden wrappers, refuses what
    the kernels cannot take: another dtype, operands of two dtypes or two
    devices (compared by index: a meta tensor stands in for device 0),
    strides, no elements."""
    from repro_torch.kernels import bilevel_l1inf as bi

    _reach_the_launch(monkeypatch)
    monkeypatch.setattr(torch.Tensor, "get_device",
                        lambda t: -1 if t.is_cpu else 0)
    with pytest.raises(ValueError, match=match):
        bi.check_operands("golden", *make())


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_golden_operand_checks_return_the_dtype_code(monkeypatch, dtype, code):
    from repro_torch.kernels import bilevel_l1inf as bi

    _reach_the_launch(monkeypatch)
    y = torch.empty(4, 8, device="meta", dtype=dtype)
    assert bi.check_operands("golden", y, torch.empty(8, device="meta", dtype=dtype)) == code


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_without_a_build_raise(monkeypatch, tmp_path, dtype):
    """A CUDA-typed call (a meta tensor let through the CUDA gate) that
    reaches the lean launch path without a built library raises and counts
    nothing: clip, and the bf16 and float32 (3×TF32) dQ."""
    from repro_torch.kernels import _build, bilevel_l1inf as bi
    from repro_torch.kernels import flash_attention as flash

    _reach_the_launch(monkeypatch)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    qkv = torch.empty(1, 2, 8, 16, device="meta", dtype=dtype)
    lse = torch.empty(1, 2, 8, device="meta")
    dq = flash.DQ_TF32_KERNEL if dtype == torch.float32 else flash.DQ_KERNEL
    calls = {bi.CLIP: lambda: bi.clip(qkv[0, 0], qkv[0, 0, 0]),
             dq: lambda: flash.flash_bwd_dq(qkv, qkv, qkv, qkv, lse, lse)}
    for kern, call in calls.items():
        monkeypatch.setattr(kern, "_lib", None)
        monkeypatch.setattr(kern, "_fns", {})
        monkeypatch.setattr(kern, "launches", 0)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
        assert kern.launches == 0


def test_trilevel_reduce_wrapper_launches_one_kernel_with_its_shape(monkeypatch):
    """The tri-level reduce makes one export call per reduce with
    ``reduce_shape``'s packs, groups and cluster size (cached), takes no
    scratch (its export has three pointers: Y, v2, v1), and returns its two
    allocations. Each strip of columns belongs to one cluster of at most 8
    CTAs, one wave of the card where the strips allow; a row's slice groups
    stay inside one warp, fit its slices, and share one step of the
    cluster's lanes."""
    import math

    from repro_torch.kernels import _build, bilevel_l1inf as bi
    from repro_torch.kernels import trilevel_l1infinf as tri

    assert tri.REDUCE.functions["golden_trilevel_reduce"].count(_build.PTR) == 4
    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, tri.REDUCE, 0)
    shapes = [(256, 32, 2048), (32, 1000, 2000), (2, 8, 128), (3, 17, 130),
              (8, 250, 64), (1, 64, 257), (4, 300, 700), (3, 9, 1001)]
    for dtype in (torch.float32, torch.bfloat16):
        for c, n, m in shapes:
            y = torch.empty(c, n, m, device="meta", dtype=dtype)
            v2, v1 = tri.trilevel_reduce(y)
            assert v2.shape == (n, m) and v1.shape == (m,)
            assert v2.dtype == v1.dtype == dtype
            es = y.element_size()
            vec = 16 // es if m % (16 // es) == 0 else 1
            shape = tri.reduce_shape.__wrapped__(c, n, m, vec, es)
            assert tri.reduce_shape(c, n, m, vec, es) == shape
            packs, groups, cluster, ctas = shape
            assert calls[-1][3:-1] == (bi.DTYPE_CODES[dtype], vec, c, n, m,
                                       packs, groups, cluster)
            strips = math.ceil(math.ceil(m / vec) / packs)
            assert ctas == strips * cluster
            assert cluster in (1, 2, 4, 8) and (ctas <= tri.REDUCE_CTAS or cluster == 1)
            assert packs & (packs - 1) == 0 and packs * vec * es <= tri.REDUCE_SEGMENT
            assert groups & (groups - 1) == 0 and groups <= max(1, c)
            assert groups == 1 or (packs * groups <= tri.WARP and groups * n
                                   <= cluster * tri.REDUCE_THREADS // packs)
    assert tri.REDUCE.launches == len(calls) == 2 * len(shapes)
    # the main path: W2 fills 128 CTAs with 128-byte strips, 2 CTAs a
    # cluster and 4 slice groups a row; W4 with the widest 512-byte strips
    # and 8 CTAs a cluster splitting its 1000 rows
    assert tri.reduce_shape(256, 32, 2048, 4, 4) == (8, 4, 2, 128)
    assert tri.reduce_shape(32, 1000, 2000, 4, 4) == (32, 1, 8, 128)


@pytest.mark.parametrize("c,n,m,vec", [
    (256, 32, 256, 4), (32, 100, 200, 4), (2, 8, 128, 4), (3, 17, 130, 1),
    (1, 64, 257, 1), (3, 9, 1001, 1), (5, 3, 64, 8), (7, 5, 48, 4),
    (32, 1000, 64, 4)])
def test_trilevel_reduce_lanes_cover_every_element_once(c, n, m, vec):
    """The reduce kernel's index arithmetic (csrc/trilevel_l1infinf.cu:
    reduce_kernel) replayed on the host: over every cluster, CTA and
    thread, each element of Y is loaded once, each (row, column) of v2
    stored once (by the group's first lane, after the group's butterfly,
    whose partners share the row), and each column of v1 written once, by
    one CTA of its strip's cluster."""
    import numpy as np

    from repro_torch.kernels import trilevel_l1infinf as tri

    packs, groups, cl, ctas = tri.reduce_shape(c, n, m, vec, 4)
    threads = tri.REDUCE_THREADS
    lanes = threads // packs
    t = np.arange(threads)
    p = t % packs
    o = packs   # butterfly partners (offsets packs, 2·packs, …): one warp, one row
    while o < packs * groups:
        q = t ^ o
        assert (q // 32 == t // 32).all() and (q % packs == p).all()
        assert ((q // packs) // groups == (t // packs) // groups).all()
        o <<= 1
    slots = cl * lanes // groups
    loads = np.zeros((c, n, m), np.int64)
    stores = np.zeros((n, m), np.int64)
    written = np.zeros(m, np.int64)
    width = packs * vec
    for b in range(ctas):
        rank, strip = b % cl, b // cl
        lane = rank * lanes + t // packs
        g, slot = lane % groups, lane // groups
        j0 = (strip * packs + p) * vec
        for i0 in range(0, n, slots):
            i = i0 + slot
            for tt in np.nonzero((j0 < m) & (i < n))[0]:
                cols = slice(j0[tt], j0[tt] + vec)
                loads[g[tt]::groups, i[tt], cols] += 1
                if g[tt] == 0:
                    stores[i[tt], cols] += 1
        for tt in range(threads):
            for col in range(rank + tt * cl, width, threads * cl):
                if strip * width + col < m:
                    written[strip * width + col] += 1
    assert (loads == 1).all() and (stores == 1).all() and (written == 1).all()


def test_project_l1_launches_without_a_copy_to_the_device(monkeypatch):
    """A number radius reaches the l1ball export by value with a null radii
    pointer: no ``torch.as_tensor`` to the device (a pageable host-to-device
    copy that may synchronize the stream) on the golden pipelines' θ-solve."""
    from repro_torch.kernels import l1ball

    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, l1ball.KERNEL, 0)
    as_tensor = torch.as_tensor

    def no_device_copy(data, *args, **kwargs):
        if kwargs.get("device") is not None and torch.device(
                kwargs["device"]).type != "cpu":
            raise AssertionError("project_l1 copied its radius to the device")
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", no_device_copy)
    v = torch.empty(2048, device="meta")
    for method, code in (("bisect", 0), ("filter", 1)):
        x = l1ball.project_l1(v, 1.5, method=method)
        assert x.shape == (2048,)
        assert calls[-1][1] is None and calls[-1][2] == 1.5
        assert calls[-1][4:-1] == (1, 2048, code, l1ball._iters(method, 2048), 0)
        l1ball.outer_l1_solve(v, 2.5, method=method)
        assert calls[-1][1] is None and calls[-1][2] == 2.5
    assert l1ball.KERNEL.launches == 4
