"""The v2 short-attention backward's rule (kernel row 3) on the CPU.

* ``short_attention_v1_backward_plain`` is the oracle of the CUDA v2
  backward ``msa_short_attention_bwd``: JAX's ``_bwd_kernel_v2`` recomputes
  p from q and k, takes delta = rowsum(p * dpm) and rounds dS and the
  dropped p to the input dtype before their products, which is v1's rule
  (``_bwd_kernel``).  It is held against ``jax.vjp`` of
  ``short_attention_v2`` (JAX's switch ``_USE_V3_BWD`` off, its Pallas
  kernels in interpret mode) on inputs with a fully masked, a partly
  masked and a live batch row, at head dim 64 and (``-d32``, H = 64) 32:
  in f32 within the v2 parity tests' 2e-5
  (test_torch_ops_grad.py: the same math in another summation order); in
  bf16 within 2e-3 absolute and 8e-3 relative (two bf16 ulps, as
  test_torch_short_attention_v3.py): both sides round the same products,
  and a sum taken in another order can move a rounded dS to its
  neighbour.
* The rounding is what holds it there: the same rule without it (the f32
  gradient of the bf16 inputs) lies further from JAX's bf16 gradients.
* ``tensor_core_backward`` / ``backward_launches``: the v2, v2p and v2s
  backwards, like v3's, are one tensor-core launch for bf16 at S <= 128
  and the CUDA-core pair otherwise, the bound the CUDA template states.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.ops import short_attention as jax_sa
from msa_tpu_torch import _build
from msa_tpu_torch.ops import short_attention as sa
from test_torch_ops_grad import GRAD_TOL, attention_inputs

BF16_TOL = (2e-3, 8e-3)  # (atol, rtol)
HEADS = 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jax_v2_grads(s, dtype, seed, h=128):
    """The inputs ([3, s, h], HEADS heads) as torch tensors of ``dtype``
    (the values JAX sees) and JAX's v2 gradients of them, f32."""
    q, k, v, dout, bias = attention_inputs(3, s, h, seed=seed)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, dout))
    _, vjp = jax.vjp(lambda *x: jax_sa.short_attention_v2(
        *x, jnp.asarray(bias), None, HEADS, 0.0, True), jq, jk, jv)
    ref = [np.asarray(r, np.float32) for r in vjp(jdo)]
    port = [torch.from_numpy(np.array(x, np.float32)).to(tdt)
            for x in (jq, jk, jv, jdo)]
    return (*port, torch.from_numpy(bias)), ref


# (S, H): head dim 64, and 32 at the tiny preset's H = 64
SHAPES = [pytest.param(12, 128, id="12"), pytest.param(40, 128, id="40"),
          pytest.param(40, 64, id="40-d32")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s, h", SHAPES)
def test_v2_backward_rule_matches_jax_v2(monkeypatch, s, h, dtype):
    monkeypatch.setattr(jax_sa, "_USE_V3_BWD", False)
    (q, k, v, dout, bias), ref = jax_v2_grads(s, dtype, seed=30 + s, h=h)
    got = sa.short_attention_v1_backward_plain(q, k, v, bias, dout, HEADS)
    atol, rtol = (GRAD_TOL, GRAD_TOL) if dtype == "float32" else BF16_TOL
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == q.dtype, name
        np.testing.assert_allclose(g.float().numpy(), r, atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("s, h", SHAPES)
def test_v2_backward_rounding_is_jax_s(monkeypatch, s, h):
    """In bf16 the rule with its roundings lies closer to JAX's gradients
    than the same rule without them (the f32 gradient of the bf16 inputs),
    for every gradient: the roundings are JAX's, not noise around them."""
    monkeypatch.setattr(jax_sa, "_USE_V3_BWD", False)
    (q, k, v, dout, bias), ref = jax_v2_grads(s, "bfloat16", seed=30 + s,
                                              h=h)
    rounded = sa.short_attention_v1_backward_plain(q, k, v, bias, dout, HEADS)
    wide = sa.short_attention_v1_backward_plain(
        *(x.float() for x in (q, k, v)), bias, dout.float(), HEADS)
    for name, g, w, r in zip(("dq", "dk", "dv"), rounded, wide, ref):
        err = np.abs(g.float().numpy() - r).max()
        err_wide = np.abs(w.to(torch.bfloat16).float().numpy() - r).max()
        assert err < err_wide, (name, err, err_wide)


@pytest.mark.parametrize("entry", ["short_attention_backward",
                                   "short_attention_packed_backward",
                                   "short_attention_probs_backward"])
@pytest.mark.parametrize("dtype,seq,launches", [
    (torch.bfloat16, 1, 1), (torch.bfloat16, 80, 1), (torch.bfloat16, 128, 1),
    (torch.bfloat16, 129, 2), (torch.bfloat16, 1023, 2),
    (torch.float32, 40, 2), (torch.float32, 128, 2)])
def test_v2_backward_launches(entry, dtype, seq, launches):
    """bf16 at S <= 128 is one tensor-core launch (the forward then keeps
    no lse); f32 and bf16 above 128 keys are the CUDA-core dq and dk/dv
    pair.  Each entry counts its launches by this rule
    (test_torch_head_dims.py runs the v2s entry's count)."""
    assert sa.tensor_core_backward(seq, dtype) == (launches == 1), entry
    assert sa.backward_launches(seq, dtype) == launches, entry


def test_tensor_core_bound_matches_the_template():
    """The Python rule's S bound is the one the CUDA template takes
    (``short_bwd_tc.cuh``'s kMaxSeq, which ``bwd_dispatch`` tests)."""
    text = (_build.CSRC / "short_bwd_tc.cuh").read_text()
    (bound,) = re.findall(r"constexpr int kMaxSeq = (\d+);", text)
    assert int(bound) == sa.TC_BWD_MAX_SEQ
    source = (_build.CSRC / "short_attention.cu").read_text()
    assert "seq <= msa_short_bwd::kMaxSeq" in source
