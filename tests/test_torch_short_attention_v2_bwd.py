"""The v2 short-attention backward's rule (kernel row 3) on the CPU.

* ``short_attention_v1_backward_plain`` is the oracle of the CUDA v2
  backward ``msa_short_attention_bwd``: JAX's ``_bwd_kernel_v2`` recomputes
  p from q and k, takes delta = rowsum(p * dpm) and rounds dS and the
  dropped p to the input dtype before their products, which is v1's rule
  (``_bwd_kernel``).  It is held against ``jax.vjp`` of
  ``short_attention_v2`` (JAX's switch ``_USE_V3_BWD`` off, its Pallas
  kernels in interpret mode) on inputs with a fully masked, a partly
  masked and a live batch row, at head dim 64 and (``-d32``, H = 64) 32,
  at S up to 128 (the whole-row kernel's range) and at S = 130 and 200
  (the tiled pair's: JAX's kernel pads those rows to 256 lanes):
  in f32 within the v2 parity tests' 2e-5
  (test_torch_ops_grad.py: the same math in another summation order); in
  bf16 within 2e-3 absolute and 8e-3 relative (two bf16 ulps, as
  test_torch_short_attention_v3.py): both sides round the same products,
  and a sum taken in another order can move a rounded dS to its
  neighbour.
* The rounding is what holds it there: the same rule without it (the f32
  gradient of the bf16 inputs) lies further from JAX's bf16 gradients.
* ``backward_route`` / ``backward_launches``: the v2, v2p and v2s
  backwards, like v3's, are one tensor-core launch for bf16 at S <= 128,
  the tiled tensor-core pair for bf16 above, and the CUDA-core pair for
  f32; the bounds are the ones the CUDA templates state.
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

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

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
          pytest.param(40, 64, id="40-d32"), pytest.param(130, 128, id="130"),
          pytest.param(200, 128, id="200"),
          pytest.param(200, 64, id="200-d32")]


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
    no lse); bf16 above 128 keys is the tiled tensor-core dq and dk/dv
    pair, f32 the CUDA-core pair.  Each entry counts its launches by this
    rule, and its tiled route's apart (test_torch_head_dims.py runs the v2s
    entry's counts)."""
    route = (sa.WHOLE_ROW if launches == 1 else
             sa.TILED if dtype == torch.bfloat16 else sa.CUDA_CORES)
    assert sa.backward_route(seq, dtype, 64) == route, entry
    assert sa.tensor_core_backward(seq, dtype, 64) == (dtype == torch.bfloat16)
    assert sa.backward_launches(seq, dtype, 64) == launches, entry
    assert getattr(sa, entry).tiled.launches >= 0


def test_tensor_core_bound_matches_the_template():
    """The Python rule's one-launch S bound is the one the CUDA template
    takes (``short_bwd_tc.cuh``'s kMaxSeq, which ``tc_backward`` tests)."""
    text = (_build.CSRC / "short_bwd_tc.cuh").read_text()
    (bound,) = re.findall(r"constexpr int kMaxSeq = (\d+);", text)
    assert int(bound) == sa.WHOLE_ROW_BWD_MAX_SEQ
    source = (_build.CSRC / "short_attention.cu").read_text()
    assert "seq <= msa_short_bwd::kMaxSeq" in source


def test_tiled_range_matches_the_template():
    """The tiled route's S range is the one ``short_bwd_tiled.cuh`` states
    (kMinSeq .. kMaxSeq): from one past the whole-row kernel's bound to the
    last S of the short kernels, where the flash kernels take over."""
    text = (_build.CSRC / "short_bwd_tiled.cuh").read_text()
    (low,) = re.findall(r"constexpr int kMinSeq = (\d+);", text)
    (high,) = re.findall(r"constexpr int kMaxSeq = (\d+);", text)
    assert int(low) == sa.WHOLE_ROW_BWD_MAX_SEQ + 1
    assert int(high) == sa.TC_BWD_MAX_SEQ == sa.MAX_SEQ
    for seq in (int(low) - 1, int(low), int(high)):
        want = sa.WHOLE_ROW if seq < int(low) else sa.TILED
        assert sa.backward_route(seq, torch.bfloat16, 64) == want, seq
    source = (_build.CSRC / "short_attention.cu").read_text()
    assert '#include "short_bwd_tiled.cuh"' in source
    assert "MSA_TC(msa_short_bwd_tiled, true)" in source
