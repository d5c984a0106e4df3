"""Parity of the port's flash-attention forward (``repro_torch.kernels.
flash_attention``) with the JAX package's, on the CPU.

The port's CPU path is the kernel's plain version. It is held to the TPU
kernel itself in Pallas interpret mode (``_fwd_call(..., interpret=True)``,
which returns o and lse) and, where every row has a valid key, to the
unblocked oracle ``ref.flash_attention_ref`` (with kv heads repeated for
GQA). The cases mirror ``tests/test_kernels.py``'s flash tests plus
Sq > Sk under a causal mask, whose leading rows no key reaches: there the
port must reproduce the TPU kernel's output (V averaged over the live
blocks' slots, lse = -1e30 + log(count)), not a "fixed" one.

Inputs are float32 from a seeded numpy generator. Tolerance: atol 2e-5 on o
(the oracle tests' own) and 1e-5 on lse (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import _fwd_call
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (q shape, kv shape, causal, window, block_q, block_k)
CASES = [
    ((1, 1, 128, 64), (1, 1, 128, 64), True, None, 128, 128),
    ((2, 4, 256, 64), (2, 2, 256, 64), True, None, 128, 128),     # GQA 2
    ((1, 8, 384, 32), (1, 2, 384, 32), True, None, 128, 128),     # GQA 4
    ((2, 2, 257, 16), (2, 2, 257, 16), True, None, 128, 128),     # ragged
    ((1, 2, 256, 64), (1, 2, 256, 64), False, None, 128, 128),    # non-causal
    ((1, 2, 384, 16), (1, 2, 384, 16), True, 32, 128, 128),       # windows
    ((1, 2, 384, 16), (1, 2, 384, 16), True, 128, 128, 128),
    ((1, 2, 384, 16), (1, 2, 384, 16), True, 1000, 128, 128),
    ((1, 2, 128, 64), (1, 2, 512, 64), False, None, 128, 128),    # Sq < Sk
    ((1, 2, 100, 16), (1, 2, 300, 16), True, None, 128, 128),     # right-aligned
    ((1, 2, 200, 16), (1, 2, 333, 16), False, 40, 128, 128),      # unaligned
    ((1, 2, 512, 16), (1, 2, 512, 16), True, None, 64, 256),      # block sweep
    ((1, 2, 512, 16), (1, 2, 512, 16), True, None, 256, 64),
    ((1, 2, 300, 16), (1, 2, 100, 16), True, None, 128, 128),     # Sq > Sk
    ((1, 2, 300, 16), (1, 2, 130, 16), True, 50, 128, 128),
    ((1, 2, 300, 16), (1, 2, 100, 16), False, None, 128, 128),
]


def _ids(case):
    q, k, causal, window, bq, bk = case
    return (f"q{q[1]}x{q[2]}-kv{k[1]}x{k[2]}-d{q[3]}-"
            f"{'causal' if causal else 'full'}-w{window}-b{bq}x{bk}")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plain_matches_tpu_kernel_interpret(case):
    qs, ks, causal, window, bq, bk = case
    q, k, v = _rand(qs, 1), _rand(ks, 2), _rand(ks, 3)
    jo, jl = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, scale=qs[-1] ** -0.5,
                       block_q=bq, block_k=bk, interpret=True)
    to, tl = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window, block_q=bq, block_k=bk)
    assert to.shape == qs and tl.shape == qs[:3]
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("case", [c for c in CASES if c[1][2] >= c[0][2]
                                  or not c[2]], ids=_ids)
def test_plain_matches_unblocked_oracle(case):
    """Every row reaches a key: the blocked result is plain softmax
    attention, which both packages' oracles compute."""
    qs, ks, causal, window, bq, bk = case
    q, k, v = _rand(qs, 4), _rand(ks, 5), _rand(ks, 6)
    g = qs[1] // ks[1]
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 1),
                                    jnp.repeat(jnp.asarray(v), g, 1),
                                    causal=causal, window=window)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got, _ = tflash.flash_attention(torch.from_numpy(q), kt, vt, causal=causal,
                                    window=window, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    ref_t = tref.flash_attention_ref(torch.from_numpy(q),
                                     kt.repeat_interleave(g, 1),
                                     vt.repeat_interleave(g, 1),
                                     causal=causal, window=window)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(
        tops.attention(torch.from_numpy(q), kt, vt, causal=causal,
                       window=window).numpy(),
        tflash.flash_attention(torch.from_numpy(q), kt, vt, causal=causal,
                               window=window)[0].numpy())


def test_rows_no_key_reaches_follow_the_tpu_kernel():
    """Causal Sq > Sk: the first Sq - Sk rows see no key. The TPU kernel
    gives them lse = -1e30 + log(count) and the mean of V over the live
    blocks' slots; the plain version must give the same."""
    q, k, v = _rand((1, 1, 300, 16), 7), _rand((1, 1, 100, 16), 8), \
        _rand((1, 1, 100, 16), 9)
    jo, jl = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=None, scale=0.25, block_q=128,
                       block_k=128, interpret=True)
    to, tl = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True,
                                    scale=0.25)
    dead = slice(0, 200)
    assert float(tl[0, 0, dead].max()) == pytest.approx(-1e30, rel=1e-6)
    np.testing.assert_allclose(tl.numpy()[0, 0, dead], np.asarray(jl)[0, 0, dead],
                               rtol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    assert np.isfinite(to.numpy()).all()


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tflash.flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="disagree"):
        tflash.flash_attention(q, torch.zeros(2, 3, 8, 16), torch.zeros(2, 3, 8, 16))
