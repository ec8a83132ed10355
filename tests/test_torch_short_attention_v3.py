"""The v3 short-attention backward (JAX's ``_USE_V3_BWD``) on the CPU.

* ``short_attention_v3_backward_plain`` (the oracle of the CUDA kernel
  ``msa_short_attention_v3_bwd``) against jax.grad through
  ``short_attention_v2`` with JAX's switch ``_USE_V3_BWD`` flipped by
  monkeypatch (its Pallas ``_bwd_kernel_v3`` in interpret mode), each fed
  its own forward's ctx: in f32 within the v2 parity tests' 2e-5
  (test_torch_ops_grad.py: the same math in another summation order); in
  bf16 within 2e-3 absolute and 8e-3 relative (two bf16 ulps): both round
  dS and the dropped probabilities to bf16 before their products, and
  read their own bf16 ctx; a sum taken in another order can move a
  rounded dS to its neighbour (one bf16 ulp of dq at S = 40).
* The v3 rule in f32 equals the v1 rule (delta = rowsum(p * dpm), not
  dO . o) within 2e-6, with and without a keep mask: one gradient, delta
  taken two ways.
* ``backward_launches``: one launch for bf16 at S <= 128 (the whole-row
  tensor-core kernel), two otherwise (bf16: the tiled tensor-core pair;
  f32: the CUDA-core pair).
* The port's switch ``USE_V3_BWD``: ``short_attention`` on CPU tensors
  runs the v3 plain backward (the same values as autograd through the
  plain attention, f32 within 2e-5), and every named remat policy with the
  short route forced equals the no-remat step with v3 off (f32, 2e-6: the
  two backwards differ only in how delta is summed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.ops import short_attention as jax_sa
from msa_tpu_torch.models import bert as port_bert
from msa_tpu_torch.ops import attention as port_attention
from msa_tpu_torch.ops import short_attention as sa
from msa_tpu_torch.ops.dropout import keep_mask_plain
from test_torch_remat import POLICIES, port_loss_and_grads, setup  # noqa: F401
from test_torch_ops_grad import GRAD_TOL, attention_inputs

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

BF16_TOL = (2e-3, 8e-3)  # (atol, rtol)
V3_SAME_TOL = 2e-6
HEADS = 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 40, 130, 200])
def test_v3_backward_plain_matches_jax_v3(monkeypatch, s, dtype):
    """At S = 130 and 200 the rule of the tiled pair, which JAX's kernel
    runs on rows padded to 256 lanes."""
    monkeypatch.setattr(jax_sa, "_USE_V3_BWD", True)
    q, k, v, dout, bias = attention_inputs(3, s, 128, seed=20 + s)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, dout))

    def jax_loss(q, k, v):
        out = jax_sa.short_attention_v2(q, k, v, jnp.asarray(bias), None,
                                        HEADS, 0.0, True)
        return jnp.sum((out * jdo).astype(jnp.float32))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x, np.float32)).to(tdt)
                       for x in (jq, jk, jv, jdo))
    tb = torch.from_numpy(bias)
    out = sa.short_attention_plain(tq, tk, tv, tb, HEADS)
    got = sa.short_attention_v3_backward_plain(tq, tk, tv, tb, out, tdo, HEADS)
    atol, rtol = (GRAD_TOL, GRAD_TOL) if dtype == "float32" else BF16_TOL
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == tdt, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), atol=atol,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 26 / 256])
def test_v3_plain_equals_v1_plain_in_f32(rate):
    """delta = dO . o (v3, o the forward's ctx under the same keep mask)
    and delta = rowsum(p * dpm) (v1) are one number: the two plain rules
    agree in f32 within 2e-6."""
    b, s = 3, 40
    q, k, v, dout, bias = (torch.from_numpy(x)
                           for x in attention_inputs(b, s, 128, seed=7))
    keep = keep_mask_plain(11, rate, b, HEADS, s) if rate else None
    out = sa.short_attention_plain(q, k, v, bias, HEADS, rate, keep)
    v3 = sa.short_attention_v3_backward_plain(q, k, v, bias, out, dout,
                                              HEADS, rate, keep)
    v1 = sa.short_attention_v1_backward_plain(q, k, v, bias, dout, HEADS,
                                              rate, keep)
    for name, g3, g1 in zip(("dq", "dk", "dv"), v3, v1):
        torch.testing.assert_close(g3, g1, atol=V3_SAME_TOL, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("dtype,seq,launches", [
    (torch.bfloat16, 1, 1), (torch.bfloat16, 128, 1),
    (torch.bfloat16, 129, 2), (torch.bfloat16, 1023, 2),
    (torch.float32, 8, 2), (torch.float32, 128, 2), (torch.float32, 129, 2)])
def test_v3_backward_launches(dtype, seq, launches):
    """bf16 at S <= 128 is one tensor-core launch; bf16 above 128 keys is
    the tiled tensor-core dq and dk/dv pair, f32 the CUDA-core pair."""
    assert sa.backward_launches(seq, dtype, 64) == launches
    assert sa.backward_route(seq, dtype, 64) == (
        sa.CUDA_CORES if dtype == torch.float32 else
        sa.WHOLE_ROW if seq <= 128 else sa.TILED)


def test_v3_switch_on_cpu_tensors(monkeypatch):
    """With USE_V3_BWD, short_attention on CPU tensors that need a gradient
    runs the autograd pair of plain forward and v3 plain backward: its
    gradients are the v3 plain backward's bit for bit, and autograd's
    through the plain attention within 2e-5.  Without the switch it is the
    plain attention itself; the switch is read in the forward."""
    q, k, v, dout, bias = (torch.from_numpy(x)
                           for x in attention_inputs(3, 40, 128, seed=5))
    calls = []
    plain_bwd = sa.short_attention_v3_backward_plain
    monkeypatch.setattr(sa, "short_attention_v3_backward_plain",
                        lambda *a, **kw: calls.append(1) or plain_bwd(*a, **kw))

    def grads(v3):
        monkeypatch.setattr(sa, "USE_V3_BWD", v3)
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out = sa.short_attention(qq, kk, vv, bias, HEADS)
        monkeypatch.setattr(sa, "USE_V3_BWD", not v3)  # the forward decided
        return out, torch.autograd.grad(out, (qq, kk, vv), dout)

    out3, got = grads(True)
    assert len(calls) == 1
    want = plain_bwd(q, k, v, bias, out3.detach(), dout, HEADS)
    out2, ref = grads(False)
    assert len(calls) == 1
    assert torch.equal(out3, out2)
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, ref):
        assert torch.equal(g, w), name
        torch.testing.assert_close(g, r, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_run_the_v3_backward(setup, monkeypatch, policy):  # noqa: F811
    """The short route forced on CPU tensors with USE_V3_BWD on (attention
    dropout off: the kernels' dropout needs the card), under every policy
    of test_torch_remat.py: every short-route attention's backward is the
    v3 one (4 calls: two encoder calls of two layers) except under
    '+probs' and save_pack, whose pairs keep their own backwards, as in
    JAX; and the policy's loss and gradients equal the no-remat step with
    v3 off.  save_ctx keeps the ctx and recomputes q, k, v, which is all
    v3 reads."""
    for mod in (port_attention, port_bert):
        monkeypatch.setattr(mod, "attention_route",
                            lambda use_flash, seq, on_cuda: "short")
    ref_loss, ref_grads = port_loss_and_grads(setup, "none", dropout=True,
                                              attention_dropout=False)
    calls, pair = [], sa._ShortAttention

    class Counted(pair):
        @staticmethod
        def backward(ctx, dout):
            calls.append(ctx.v3)
            return pair.backward(ctx, dout)

    monkeypatch.setattr(sa, "_ShortAttention", Counted)
    monkeypatch.setattr(sa, "USE_V3_BWD", True)
    loss, grads = port_loss_and_grads(setup, policy, dropout=True,
                                      attention_dropout=False)
    assert calls == ([] if "+probs" in policy or policy == "save_pack"
                     else [True] * 4)
    assert loss == pytest.approx(ref_loss, abs=V3_SAME_TOL)
    for key, g in grads.items():
        torch.testing.assert_close(g, ref_grads[key], atol=V3_SAME_TOL,
                                   rtol=0, msg=key)
