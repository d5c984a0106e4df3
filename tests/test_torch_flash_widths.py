"""The flash kernels' head dims (``repro_torch.kernels.flash_attention``):
every multiple of 8 up to 128, the widths of h2o-danube-1.8b (80) and
zamba2-7b's shared attention (112), on the CPU, against the JAX package's
Pallas kernels in interpret mode.

On the CPU the wrappers run the plain versions, which take any width; on
the card the kernels of the next instantiated width up (16, 32, 64, 128)
run on the true one, reading the columns past it as 0 (held to the plain
versions there by ``chip_smoke.py``, phase 15). Here: the plain forward and
gradients at 80 and 112 against ``_fwd_call`` and ``jax.grad`` through
JAX's differentiable ``flash_attention`` (both ``interpret=True``) on GQA,
causal, windowed and ragged cases; a smoke danube with 80-wide heads
through ``lm.forward(impl="flash")`` against JAX's forward; and the kernel
contract on ``meta`` tensors (the launch gate lifted, the launches
recorded in place of the kernels').

Inputs come from a seeded numpy generator. Tolerances: tests/test_torch_
flash.py's and tests/test_torch_flash_backward.py's: o within 2e-5 and lse
within 1e-5 (float32, sums in another order); float32 gradients within
1e-5 + 1e-5 |want|; bf16 within 2**-7 |want| + 2**-9 of the gradient's
largest entry (one bf16 rounding, and o's rounding moving delta); logits
within 2e-5 (tests/test_torch_lm.py's).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.flash_attention import _fwd_call
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import lm as tlm

# (name, q shape, kv shape, causal, window, block_q, block_k) at 80 and 112
CASES = [
    ("window_112", (1, 2, 100, 112), (1, 2, 100, 112), True, 24, 32, 32),
    ("sq_gt_sk_80", (1, 4, 70, 80), (1, 1, 45, 80), True, None, 16, 16),
    ("cross_ragged_112", (1, 2, 40, 112), (1, 2, 77, 112), False, None, 16, 32),
    ("window_gqa_ragged_80", (2, 4, 57, 80), (2, 2, 57, 80), True, 9, 16, 16),
]
BF16_TOL = 2.0 ** -7


def _ids(case):
    return case[0]


def _inputs(qs, ks, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (qs, ks, ks, qs)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_forward_matches_tpu_kernel_interpret(case):
    _, qs, ks, causal, window, bq, bk = case
    q, k, v, _ = _inputs(qs, ks, 1)
    jo, jl = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, scale=qs[-1] ** -0.5,
                       block_q=bq, block_k=bk, interpret=True)
    to, tl = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, window=window, block_q=bq,
                                    block_k=bk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_function_gradients_match_jax_grad(case, dtype):
    """Autograd through ``FlashAttention`` (the forward and
    ``flash_attention_bwd``'s plain version) against ``jax.grad`` through
    JAX's forward and its custom VJP's dQ and dK/dV kernels."""
    _, qs, ks, causal, window, bq, bk = case
    q, k, v, cot = _inputs(qs, ks, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(q, k, v):
        o = jflash(q, k, v, causal=causal, window=window, block_q=bq,
                   block_k=bk, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    want = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)))]
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    o = tflash.flash(*leaves, causal=causal, window=window, block_q=bq, block_k=bk)
    assert o.dtype == tdt and o.shape == qs
    (o.float() * torch.from_numpy(cot)).sum().backward()
    for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else
               dict(atol=2.0 ** -9 * float(np.abs(w).max()), rtol=BF16_TOL))
        np.testing.assert_allclose(t.grad.float().numpy(), w, err_msg=name, **tol)


def test_danube_shaped_lm_forward_matches_jax():
    """The smoke h2o-danube-1.8b (GQA 4 over 1, window 16) with 80-wide
    heads: ``lm.forward(impl="flash")`` against JAX's forward, whose
    Pallas CPU oracle takes MHA only (tests/test_torch_lm.py): its
    "naive" attention, the same function."""
    arch = "h2o-danube-1.8b"
    jcfg = dataclasses.replace(jreg.smoke_config(arch), head_dim=80)
    tcfg = dataclasses.replace(treg.smoke_config(arch), head_dim=80)
    assert tcfg.resolved_head_dim == 80 and tcfg.n_kv_heads < tcfg.n_heads
    jp = jparams.init_params(jlm.template(jcfg), jax.random.PRNGKey(0))
    tp = interop.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    jl, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, impl="naive", remat=False)
    with torch.no_grad():
        tl, _ = tlm.forward(tp, torch.from_numpy(toks), tcfg, impl="flash",
                            remat=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)


# ------------------------------------------------------------ the contract


def _record_launches(monkeypatch):
    monkeypatch.setattr(tflash._device, "require_cuda", lambda t, what: None)
    calls = []
    for kern in (tflash.KERNEL, tflash.TF32_KERNEL, tflash.DQ_KERNEL,
                 tflash.DKV_KERNEL, tflash.DQ_TF32_KERNEL, tflash.DKV_TF32_KERNEL):
        monkeypatch.setattr(kern, "launch", lambda fn, *a, k=kern:
                            calls.append((k.name, a)))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 112])
def test_kernel_contract_takes_80_and_112(monkeypatch, d, dtype):
    """The forward and both backward kernels take 80 and 112 on a device
    tensor (recorded launches, each given the true head dim and a scratch
    sized at it; the export runs the 128 instantiation on it)."""
    calls = _record_launches(monkeypatch)
    b, hq, hkv, sq, sk = 2, 8, 2, 64, 96
    q = torch.empty(b, hq, sq, d, device="meta", dtype=dtype)
    k = torch.empty(b, hkv, sk, d, device="meta", dtype=dtype)
    lse = torch.empty(b, hq, sq, device="meta")
    tflash.flash_attention(q, k, k, causal=True)
    tflash.flash_bwd_dq(q, k, k, q, lse, lse)
    tflash.flash_bwd_dkv(q, k, k, q, lse, lse)
    bf16 = dtype == torch.bfloat16
    names = (("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if bf16 else
             ("flash_fwd_tf32", "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32"))
    assert [c[0] for c in calls] == list(names)
    fwd, dq, dkv = (c[1] for c in calls)
    assert fwd[7:13] == (b, hq, hkv, sq, sk, d)
    assert fwd[6] == (0 if bf16 else tflash.tf32_work_floats(b, hq, hkv, sq, sk, d))
    assert dq[9:15] == dkv[10:16] == (b, hq, hkv, sq, sk, d)
    assert dq[8] == tflash.bwd_work_floats(b, hq, hkv, sq, sk, d, dkv=False, bf16=bf16)
    assert dkv[9] == tflash.bwd_work_floats(b, hq, hkv, sq, sk, d, dkv=True, bf16=bf16)


@pytest.mark.parametrize("d", [20, 136, 4])
def test_kernel_contract_refuses_other_widths_by_name(monkeypatch, d):
    """A width that is no multiple of 8, or past 128, raises and names the
    width before anything launches: no fallback to the plain version."""
    calls = _record_launches(monkeypatch)
    q = torch.empty(1, 2, 16, d, device="meta")
    lse = torch.empty(1, 2, 16, device="meta")
    for call in (lambda: tflash.flash_attention(q, q, q),
                 lambda: tflash.flash_bwd_dq(q, q, q, q, lse, lse),
                 lambda: tflash.flash_bwd_dkv(q, q, q, q, lse, lse)):
        with pytest.raises(ValueError, match=f"multiple of 8 from 8 to 128, got {d}"):
            call()
    assert calls == [] and _build.KERNELS["flash_fwd"].launches == 0


def test_contract_is_the_sources():
    """``KERNEL_HEAD_DIMS`` is the domain of ``flash::padded_width``
    (``csrc/flash_common.cuh``), which both sources dispatch on: the next
    of 16, 32, 64 and 128 up runs each width."""
    csrc = Path(tflash.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "flash_common.cuh").read_text()
    assert "if (d < 8 || d > 128 || d % 8) return 0;" in text
    assert "return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;" in text
    for src, switches in (("flash_fwd.cu", 2), ("flash_bwd.cu", 4)):
        body = (csrc / src).read_text()  # one switch per export and type
        assert not re.search(r"switch \(d\)", body)
        assert body.count("switch (flash::padded_width(d))") == switches
    assert list(tflash.KERNEL_HEAD_DIMS) == list(range(8, 129, 8))
