"""msa_tpu_torch's v1 short attention (kernel row 7) on the CPU against the
JAX package.

``short_attention_v1`` is the counterpart of JAX's ``short_attention`` (the
v1 pair ``_fwd_kernel`` / ``_bwd_kernel``; the port's ``short_attention`` is
JAX's ``short_attention_v2``).  On the CPU it runs its plain versions (the
CUDA kernels of ``csrc/short_attention_v1.cu`` build and run only on a
card; chip_smoke.py holds them against these plain versions there): the
plain forward and, under autograd, ``short_attention_v1_backward_plain``,
which follows ``_bwd_kernel`` (the softmax recomputed from the inputs,
delta = rowsum(p * dpm)).  The JAX side runs ``short_attention`` in
interpret mode, as ``tests/test_short_attention.py`` runs it, at B=6 as its
bf16 test does.  Inputs come from numpy seeds.

Tolerances: JAX's own bounds, f32 forward 1e-5 and gradients 2e-4 (the same
math summed in another order); bf16 2e-2 absolute and relative (JAX rounds
dS and the dropped probabilities to bf16 before its products, the plain
version computes in f32 from the bf16 inputs and rounds once: a few bf16
ulps of values of order one).  The port against itself: 2e-5.  As in
JAX's ``test_short_attention.py``, no row has every key masked: there JAX's
base-2 softmax and the plain natural one quantise the -10000 fill
differently (f32 ulp 2^-10), ~1e-3 apart; chip_smoke.py bounds the kernels
on such rows apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.ops import short_attention as jax_sa
from msa_tpu_torch.ops import short_attention as sa
from msa_tpu_torch.ops.dropout import keep_mask_plain

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
BF16_TOL = 2e-2
SELF_TOL = 2e-5
B, HEADS, H = 6, 2, 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(s, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, s, H)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((B, s), np.float32)
    mask[0, s // 2:] = 0
    mask[1, 3:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, dout, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 40, 80])
def test_short_attention_v1_matches_jax_v1(s, dtype):
    """Forward and gradients against jax.vjp through JAX's v1
    ``short_attention`` (its Pallas ``_fwd_kernel`` / ``_bwd_kernel`` in
    interpret mode), both sides on the same values in ``dtype``."""
    q, k, v, dout, bias = inputs(s, seed=s)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, dout))

    def jax_fwd(q, k, v):
        return jax_sa.short_attention(q, k, v, jnp.asarray(bias), None, HEADS,
                                      0.0, True)

    ref, vjp = jax.vjp(jax_fwd, jq, jk, jv)
    ref_grads = vjp(jdo)
    qq, kk, vv, do = (torch.from_numpy(np.array(x, np.float32)).to(tdt)
                      for x in (jq, jk, jv, jdo))
    qq, kk, vv = (x.requires_grad_() for x in (qq, kk, vv))
    out = sa.short_attention_v1(qq, kk, vv, torch.from_numpy(bias), HEADS)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    fwd_tol, grad_tol = ((FWD_TOL, GRAD_TOL) if dtype == "float32"
                         else (BF16_TOL, BF16_TOL))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=fwd_tol,
                               rtol=fwd_tol)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   atol=grad_tol, rtol=grad_tol, err_msg=name)


def test_short_attention_v1_saves_only_its_inputs():
    """Under autograd the v1 pair keeps q, k, v and the bias -- the very
    tensors it was given -- and nothing the forward computed (no f32 output,
    no lse), where v2 also keeps its f32 output and row lse."""
    q, k, v, _, bias = (torch.from_numpy(x) for x in inputs(40, seed=1))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x) or x, lambda x: x):
        out = sa.short_attention_v1(q, k, v, bias, HEADS)
    assert out.grad_fn is not None
    assert len(saved) == 4
    for x, inp in zip(saved, (q, k, v, bias)):
        assert x is inp or (x.data_ptr() == inp.data_ptr()
                            and x.shape == inp.shape)


@pytest.mark.parametrize("rate", [0.0, 26 / 256])
def test_v1_backward_plain_matches_autograd(rate):
    """The v1 rule (softmax recomputed from the inputs, delta = rowsum(p *
    dpm)) equals autograd through the plain forward, with and without a keep
    mask."""
    q, k, v, dout, bias = (torch.from_numpy(x) for x in inputs(24, seed=2))
    keep = keep_mask_plain(5, rate, B, HEADS, 24) if rate else None
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = sa.short_attention_plain(qq, kk, vv, bias, HEADS, rate, keep)
    ref = torch.autograd.grad(out, (qq, kk, vv), dout)
    got = sa.short_attention_v1_backward_plain(q, k, v, bias, dout, HEADS,
                                               rate, keep)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(g, r, atol=SELF_TOL, rtol=SELF_TOL,
                                   msg=name)


def test_v1_equals_v2_on_the_cpu():
    """v1 and v2 compute one function: the same forward, and gradients
    within f32 rounding (the v2 backward's oracle is autograd)."""
    q, k, v, dout, bias = (torch.from_numpy(x) for x in inputs(40, seed=3))
    runs = []
    for entry in (sa.short_attention_v1, sa.short_attention):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out = entry(qq, kk, vv, bias, HEADS)
        runs.append((out, *torch.autograd.grad(out, (qq, kk, vv), dout)))
    for name, a, b in zip(("out", "dq", "dk", "dv"), *runs):
        torch.testing.assert_close(a, b, atol=SELF_TOL, rtol=SELF_TOL, msg=name)


def test_short_attention_v1_cpu_refuses_in_kernel_dropout():
    q = torch.zeros(1, 8, H)
    with pytest.raises(ValueError, match="needs a seed"):
        sa.short_attention_v1(q, q, q, torch.zeros(1, 8), HEADS, 26 / 256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.short_attention_v1(q, q, q, torch.zeros(1, 8), HEADS, 26 / 256,
                              seed=3)
    # any rate in [0, 1) is the kernels' (0.1 by the word rule); 1 is not
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.short_attention_v1(q, q, q, torch.zeros(1, 8), HEADS, 0.1, seed=3)
    with pytest.raises(ValueError, match=r"outside \[0, 1\)"):
        sa.short_attention_v1(q, q, q, torch.zeros(1, 8), HEADS, 1.0, seed=3)


def test_short_attention_v1_kernel_entries_refuse_cpu_tensors():
    """The kernel backward raises on CPU tensors rather than fall back."""
    q = torch.zeros(1, 8, H)
    with pytest.raises(ValueError, match="no kernel"):
        sa.short_attention_v1_backward(q, q, q, torch.zeros(1, 8), q, HEADS)
