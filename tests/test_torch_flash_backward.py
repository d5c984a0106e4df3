"""Parity of the port's flash-attention backward (``repro_torch.kernels.
flash_attention``: ``flash_attention_bwd_plain``, ``flash_attention_bwd`` and
the ``FlashAttention`` autograd Function) with the JAX package's, on the CPU.

The reference is ``jax.grad`` through the JAX package's differentiable
``flash_attention(..., interpret=True)``: the TPU forward and its custom VJP
(``_bwd_call``'s dQ and dK/dV kernels) in Pallas interpret mode. The cases
are ``tests/test_flash_backward.py``'s ``CONFIGS`` (its blocks of 16), plus
Sq != Sk (right-aligned q; causal Sq > Sk, whose leading rows no key
reaches) and ragged tails at the default blocks of 128.

Inputs and the cotangent come from a seeded numpy generator. Tolerances:
float32 gradients within 1e-5 + 1e-5 |want| (sums in another order);
bf16 inputs (the trainer's compute type) within 2**-7 |want| plus 2**-9 of
the gradient's largest entry. Both packages compute in float32 and round
each gradient to bf16 once (the relative term), but the forward's o is
bf16 too: where an element of o rounds the other way, delta = rowsum(dO ∘
O) moves for its whole row, and a gradient that is a sum of cancelling
terms moves by a small fraction of the gradient's scale (at most 4.6e-4
of it over these cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from test_flash_backward import CONFIGS

# (name, q shape, kv shape, causal, window, block_q, block_k)
CASES = [(name, (b, hq, s, d), (b, hkv, s, d), causal, window, 16, 16)
         for name, b, hq, hkv, s, d, causal, window in CONFIGS] + [
    ("cross_sq_lt_sk", (1, 4, 40, 16), (1, 2, 100, 16), True, None, 16, 16),
    ("cross_sq_lt_sk_full", (1, 2, 48, 16), (1, 2, 80, 16), False, None, 16, 32),
    ("sq_gt_sk_dead_rows", (1, 4, 70, 16), (1, 1, 30, 16), True, None, 16, 16),
    ("sq_gt_sk_window", (1, 2, 60, 16), (1, 2, 35, 16), True, 7, 16, 16),
    ("ragged_default_blocks", (1, 4, 257, 32), (1, 2, 257, 32), True, None,
     128, 128),
    ("ragged_window_default", (1, 2, 200, 16), (1, 2, 333, 16), False, 40,
     128, 128),
]

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _tol(dtype, want):
    if dtype == "float32":
        return F32_TOL
    return dict(atol=2.0 ** -9 * float(np.abs(want).max()), rtol=2.0 ** -7)


def _inputs(qs, ks, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=qs).astype(np.float32)
    k = rng.normal(size=ks).astype(np.float32)
    v = rng.normal(size=ks).astype(np.float32)
    cot = rng.normal(size=qs).astype(np.float32)
    return q, k, v, cot


def _jax_grads(q, k, v, cot, *, causal, window, block_q, block_k, dtype):
    def loss(q, k, v):
        o = jflash(q, k, v, causal=causal, window=window, block_q=block_q,
                   block_k=block_k, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _ids(case):
    return case[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_grad(case, dtype):
    _, qs, ks, causal, window, bq, bk = case
    q, k, v, cot = _inputs(qs, ks, 11)
    want = _jax_grads(q, k, v, cot, causal=causal, window=window, block_q=bq,
                      block_k=bk, dtype=getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    o, lse = tflash.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    block_q=bq, block_k=bk)
    assert o.dtype == tdt and lse.dtype == torch.float32
    do = torch.from_numpy(cot).to(tdt)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, do,
                                           causal=causal, window=window,
                                           block_q=bq, block_k=bk)
    same = tflash.flash_attention_bwd(tq, tk, tv, o, lse, do, causal=causal,
                                      window=window, block_q=bq, block_k=bk)
    for g, s, w, name in zip(got, same, want, ("dq", "dk", "dv")):
        assert g.dtype == tdt and g.shape == s.shape
        torch.testing.assert_close(s, g, rtol=0, atol=0)  # the CPU path is plain
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name,
                                   **_tol(dtype, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_function_gradients_match_jax_grad(case, dtype):
    """Autograd through ``FlashAttention`` (and ``ops.attention``, which the
    LM calls) on CPU tensors gives JAX's gradients."""
    _, qs, ks, causal, window, bq, bk = case
    q, k, v, cot = _inputs(qs, ks, 12)
    want = _jax_grads(q, k, v, cot, causal=causal, window=window, block_q=bq,
                      block_k=bk, dtype=getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    o = tflash.flash(*leaves, causal=causal, window=window, block_q=bq,
                     block_k=bk)
    (o.float() * torch.from_numpy(cot)).sum().backward()
    for t, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.float().numpy(), w, err_msg=name,
                                   **_tol(dtype, w))
    if (bq, bk) == (tflash.DEFAULT_BLOCK_Q, tflash.DEFAULT_BLOCK_K):
        again = [x.detach().clone().requires_grad_(True) for x in leaves]
        (tops.attention(*again, causal=causal, window=window).float()
         * torch.from_numpy(cot)).sum().backward()
        for a, t in zip(again, leaves):
            torch.testing.assert_close(a.grad, t.grad, rtol=0, atol=0)


def test_rows_no_key_reaches_get_zero_gradient():
    """Causal Sq > Sk: the first Sq - Sk rows see no key. Their forward output
    follows the TPU kernel (V averaged over the live slots), but the backward
    masks them out entirely, as the TPU's _bwd_call does: dq is 0 there and
    they add nothing to dk/dv."""
    q, k, v, cot = _inputs((1, 2, 50, 16), (1, 2, 20, 16), 13)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tflash.flash_attention(tq, tk, tv, causal=True)
    do = torch.from_numpy(cot)
    dq, dk, dv = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, do,
                                                  causal=True)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert float(dq[:, :, :30].abs().max()) == 0.0
    do_live = do.clone()
    do_live[:, :, :30] = 0
    _, dk2, dv2 = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, do_live,
                                                   causal=True)
    torch.testing.assert_close(dk2, dk, rtol=0, atol=0)
    torch.testing.assert_close(dv2, dv, rtol=0, atol=0)


def test_backward_does_not_depend_on_blocks():
    """A dead block's mask is all false, so the plain backward at other TPU
    blocks (and the CUDA kernels' own 64-row tiles) computes the same
    gradients up to summation order."""
    q, k, v, cot = _inputs((1, 4, 150, 16), (1, 2, 150, 16), 14)
    tq, tk, tv, do = (torch.from_numpy(x) for x in (q, k, v, cot))
    o, lse = tflash.flash_attention(tq, tk, tv, causal=True, window=33)
    a = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, do, causal=True,
                                         window=33)
    b = tflash.flash_attention_bwd_plain(tq, tk, tv, o, lse, do, causal=True,
                                         window=33, block_q=64, block_k=16)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, **F32_TOL)


def test_backward_wrapper_rejects_bad_operands():
    q = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="must match q"):
        tflash.flash_attention_bwd(q, q, q, q[:, :, :4], lse, q)
    with pytest.raises(ValueError, match="must match q"):
        tflash.flash_attention_bwd(q, q, q, q, lse[:, :, :4], q)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tflash.flash_attention_bwd(torch.zeros(1, 3, 8, 16), q, q,
                                   torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8),
                                   torch.zeros(1, 3, 8, 16))


@pytest.mark.parametrize("sq,causal", [(48, False), (96, False), (96, True)])
def test_function_gradients_hold_float64_on_common_keys(sq, causal):
    """Keys that share most of their value (k = k̄ + 0.01·ε: whisper's
    cross-attention over the encoder states of silent audio), 96 of them
    against fewer or as many queries: the Function's float32 gradients hold
    a float64 autograd reference within 1e-5 of each gradient's largest
    entry. dq sums dS (K - k̄); the kernels' arithmetic against K itself
    would carry the rounding of dS's rows, which sum to 0 in exact
    arithmetic, times k̄ (``test_torch_flash_split.py`` and
    ``test_torch_flash_bwd_tf32.py`` model both)."""
    rng = np.random.default_rng(15)
    b, h, sk, d = 1, 2, 96, 16
    # float32 operands; the reference takes the same values in float64
    q, v, cot = (rng.normal(size=s_).astype(np.float32)
                 for s_ in ((b, h, sq, d), (b, h, sk, d), (b, h, sq, d)))
    k = (rng.normal(size=(b, h, 1, d)) * 2
         + 0.01 * rng.normal(size=(b, h, sk, d))).astype(np.float32)
    ref = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    s = ref[0] @ ref[1].transpose(-1, -2) * d ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(sq, sk, dtype=torch.bool).triu(sk - sq + 1),
                          -torch.inf)
    (torch.softmax(s, -1) @ ref[2] * torch.from_numpy(cot).double()
     ).sum().backward()
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (tflash.flash(*leaves, causal=causal) * torch.from_numpy(cot)).sum().backward()
    for t, r, name in zip(leaves, ref, ("dq", "dk", "dv")):
        w = r.grad.numpy()
        np.testing.assert_allclose(t.grad.double().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
