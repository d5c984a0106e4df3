"""``repro_torch.obs.profile.device_summary``: the device work of one step
of a ``torch.profiler`` Chrome trace of the train launcher, on a trace
written here by hand (the CPU has no device events to record)."""

import json

import pytest

from repro_torch.obs import profile


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(tmp_path):
    """Two steps, each ended by the launcher's cudaDeviceSynchronize; the
    second has two overlapping kernels on two streams and an idle gap."""
    events = [
        _x("aten::mm", "cpu_op", 0, 5),
        _x("sm90_xmma_gemm_bf16bf16", "kernel", 10, 100),
        _x("cudaDeviceSynchronize", "cuda_runtime", 50, 70),       # step 0 ends at 120
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 130, 10),
        _x("void flash_bwd_dq_wgmma<64>(...)", "kernel", 150, 300),
        _x("nvjet_tst_128x256", "kernel", 200, 400),              # overlaps the flash kernel
        _x("void at::native::vectorized_elementwise_kernel<4, silu>", "kernel", 700, 50),
        _x("void at::native::reduce_kernel<512, 1>", "kernel", 760, 20),
        _x("cudaDeviceSynchronize", "cuda_runtime", 600, 400),     # step 1 ends at 1000
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1010, 5),  # the loss readback
        _x("cudaDeviceSynchronize", "cuda_runtime", 1020, 10),     # no kernel: not a step
        {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_last_step_by_kind_and_busy_time(tmp_path):
    s = profile.device_summary(_trace(tmp_path))
    assert (s["step"], s["steps"], s["operations"]) == (1, 2, 5)
    assert s["window_ms"] == pytest.approx(0.880)
    # union of [130,140), [150,600), [700,750), [760,780): 10 + 450 + 50 + 20
    assert s["device_busy_ms"] == pytest.approx(0.530)
    assert s["idle_share"] == pytest.approx(1 - 0.530 / 0.880)
    assert s["device_ms"] == pytest.approx(0.780)
    assert {k: v["ms"] for k, v in s["by_kind"].items()} == pytest.approx(
        {"matmul": 0.4, "flash": 0.3, "elementwise": 0.05, "reduction": 0.02,
         "copy": 0.01})
    assert [e["kind"] for e in s["top"]] == ["matmul", "flash", "elementwise",
                                              "reduction", "copy"]


def test_first_step_and_top(tmp_path):
    s = profile.device_summary(_trace(tmp_path), step=0, top=1)
    assert s["step"] == 0 and s["operations"] == 1
    assert s["window_ms"] == pytest.approx(0.120)
    assert s["top"] == [{"name": "sm90_xmma_gemm_bf16bf16", "kind": "matmul",
                         "ms": pytest.approx(0.1), "count": 1}]


def test_cli_prints_the_summary_last(tmp_path, capsys):
    assert profile.main([str(_trace(tmp_path)), "--top", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step 1 of 2: window 0.880 ms")
    assert json.loads(out[-1])["top"][0]["kind"] == "matmul"


@pytest.mark.parametrize("events", [
    [_x("aten::mm", "cpu_op", 0, 5)],
    [_x("aten::mm", "cpu_op", 0, 5), _x("cudaDeviceSynchronize", "cuda_runtime", 5, 5)],
], ids=["no_sync", "no_kernel"])
def test_a_trace_without_steps_raises(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    with pytest.raises(ValueError, match="cudaDeviceSynchronize"):
        profile.device_summary(path)


@pytest.mark.parametrize("name,kind", [
    ("void flash_fwd_wgmma<64>(CUtensorMap)", "flash"),
    ("void (anonymous namespace)::clip_kernel<float, 4>", "projection"),
    ("void (anonymous namespace)::apply_kernel<2>", "projection"),
    ("void (anonymous namespace)::reduce_kernel<1, 4>(float const*)", "projection"),
    ("void (anonymous namespace)::colmax_kernel<float, 4>", "projection"),
    ("void (anonymous namespace)::trilevel_reduce_kernel<float, 4>", "projection"),
    ("void (anonymous namespace)::l1ball_kernel<8>", "projection"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "matmul"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>", "softmax/loss"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float, sum>>", "reduction"),
    ("void at::native::multi_tensor_apply_kernel<...>", "optimizer"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "copy"),
    ("void at::native::indexSelectLargeIndex<float>", "index"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>", "index"),
    ("void at::native::index_elementwise_kernel<128, 4>", "index"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "copy"),
    ("void concat_rows<float>", "other"),
    ("void at::native::vectorized_elementwise_kernel<4, mul>", "elementwise"),
    ("some_other_kernel", "other"),
])
def test_kind_of(name, kind):
    assert profile.kind_of(name) == kind
