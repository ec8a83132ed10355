"""The v2 short-attention forward's training form on the CPU.

``short_attention_train_forward_plain`` is the oracle of the CUDA forward's
training form (``msa_short_attention_fwd`` and ``_packed_fwd`` with an lse:
ctx and the row lse in log2 units that the CUDA-core v2 backward reads).
It is held against JAX's ``short_attention_v2`` and ``short_attention_v2p``
(their Pallas kernels in interpret mode) on inputs with a fully masked, a
partly masked and a live batch row.

Tolerances:
  * f32 ctx: atol = rtol = 1e-5 on rows with a live key (the same math in
    another summation order), 5e-3 on the fully masked row (every score
    carries the -10000 fill, whose f32 ulp 2^-10 quantises the scores
    differently in JAX's base-2 domain and the natural one here);
  * bf16 ctx: 3e-2, as test_torch_ops.py (JAX and the port round q, k, v,
    p and the output to bf16), and within one bf16 ulp of JAX's on live
    rows: both round p to bf16, sum P V in f32 and round once, and their
    softmaxes differ by f32 ulps, which can move a p or the result across
    a bf16 rounding boundary;
  * lse: atol = rtol = 1e-5 against the logsumexp of the same f32 scores
    over ln 2 (the fully masked row's lse sits near -14427, whose f32 ulp
    is 2^-10: inside the relative bound);
  * with a keep mask: ctx equal to ``short_attention_plain`` given the
    mask, bit for bit in f32 and within one bf16 ulp in bf16 (the plain
    attention sums P V in bf16 on the CPU).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msa_tpu.ops.short_attention import short_attention_v2, short_attention_v2p
from msa_tpu_torch.ops import short_attention as sa
from test_torch_ops import attention_inputs

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

HEADS = 2
H = 128
F32_TOL = 1e-5
MASKED_ROW_ATOL = 5e-3
BF16_TOL = 3e-2
LSE_TOL = 1e-5
RATE = 26 / 256
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def cases(s, dtype):
    """(q, k, v, bias) as numpy f32 (the values of ``dtype``) and JAX's v2
    ctx on them, f32."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, bias = attention_inputs(3, s, H, seed=40 + s)
    q, k, v = (torch.from_numpy(x).to(tdt).float().numpy() for x in (q, k, v))
    out = short_attention_v2(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                             jnp.asarray(bias), None, HEADS, 0.0, True)
    return q, k, v, bias, np.asarray(out, np.float32)


def port_inputs(s, dtype):
    q, k, v, bias, _ = cases(s, dtype)
    tdt = DTYPES[dtype][1]
    return (*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
            torch.from_numpy(bias))


def bf16_ulp(x):
    """One bf16 ulp of each value of x (numpy f32)."""
    exp = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 40])
def test_train_forward_ctx_matches_jax(s, dtype):
    ref = cases(s, dtype)[4]
    ctx, lse = sa.short_attention_train_forward_plain(
        *port_inputs(s, dtype), HEADS)
    assert ctx.dtype == DTYPES[dtype][1]
    assert lse.shape == (3, HEADS, s) and lse.dtype == torch.float32
    ctx = ctx.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ctx[1:], ref[1:], atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(ctx[0], ref[0], atol=MASKED_ROW_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(ctx, ref, atol=BF16_TOL, rtol=BF16_TOL)
        live = slice(1, None)
        np.testing.assert_array_less(np.abs(ctx[live] - ref[live]),
                                     bf16_ulp(ref[live]) * (1 + 1e-6) + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 40])
def test_lse_is_log2_sum_exp2_of_the_scores(s, dtype):
    q, k, v, bias = port_inputs(s, dtype)
    lse = sa.short_attention_train_forward_plain(q, k, v, bias, HEADS)[1]
    split = lambda x: x.float().numpy().reshape(3, s, HEADS, -1)  # noqa: E731
    scores = (np.einsum("bqnd,bknd->bnqk", split(q), split(k)) / 8.0
              + bias.numpy()[:, None, None, :]).astype(np.float64)
    top = scores.max(-1)
    want = (top + np.log(np.exp(scores - top[..., None]).sum(-1))) / np.log(2.0)
    np.testing.assert_allclose(lse.numpy(), want, atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 40])
def test_keep_mask_ctx_equals_plain(s, dtype):
    q, k, v, bias = port_inputs(s, dtype)
    keep = torch.from_numpy(
        np.random.default_rng(s).random((3, HEADS, s, s)) >= RATE)
    ctx, _ = sa.short_attention_train_forward_plain(
        q, k, v, bias, HEADS, RATE, keep)
    want = sa.short_attention_plain(q, k, v, bias, HEADS, RATE, keep)
    if dtype == "float32":
        assert torch.equal(ctx, want)
    else:
        got, want = ctx.float(), want.float()
        assert (got - want).abs().le(torch.from_numpy(
            bf16_ulp(want.numpy()))).all()
    # the dropout reaches the output: without the mask it differs
    assert not torch.equal(
        ctx, sa.short_attention_train_forward_plain(q, k, v, bias, HEADS)[0])


@pytest.mark.parametrize("s", [12, 40])
def test_packed_thirds_give_the_same_outputs(s):
    q, k, v, bias = port_inputs(s, "bfloat16")
    qkv = torch.cat([q, k, v], dim=-1)
    packed = sa.short_attention_train_forward_plain(*sa._thirds(qkv), bias,
                                                    HEADS)
    split = sa.short_attention_train_forward_plain(q, k, v, bias, HEADS)
    assert all(torch.equal(a, b) for a, b in zip(packed, split))
    ref = short_attention_v2p(jnp.asarray(qkv.float().numpy(), jnp.bfloat16),
                              jnp.asarray(bias.numpy()), None, HEADS, 0.0, True)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(ref, cases(s, "bfloat16")[4])
    np.testing.assert_allclose(packed[0].float().numpy(), ref, atol=BF16_TOL,
                               rtol=BF16_TOL)
