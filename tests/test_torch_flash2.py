"""msa_tpu_torch's flash2 module on the CPU against the JAX package.

On the CPU the flash2 wrapper runs its plain PyTorch version (the CUDA
kernels of ``csrc/flash2.cu`` build and run only on a card; chip_smoke.py
holds them against this plain version there).  The JAX side runs its
Pallas flash2 kernels in interpret mode, as ``tests/test_flash2.py`` runs
them, with both of its backward routes.  Inputs come from numpy seeds.

Tolerances (JAX's own ``test_flash2.py`` bounds): forward atol = rtol =
1e-5 in f32, gradients 2e-4 -- the same function summed in another order
(JAX in base-2 blocks with an online softmax, the port in one einsum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msa_tpu.ops.flash2 as jax_flash2
from msa_tpu.configs import build_experiment
from msa_tpu.utils.flops import mmbert_step_flops as jax_step_flops
from msa_tpu_torch.configs import ExperimentConfig as PortExperimentConfig
from msa_tpu_torch.ops import flash2 as F2
from msa_tpu_torch.ops.attention import attention_route, multi_head_attention
from msa_tpu_torch.ops.short_attention import short_attention
from msa_tpu_torch.utils.flops import mmbert_step_flops

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
HEADS = 2


def inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, s, h)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0            # key padding across a block boundary
    mask[1, 3:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, dout, bias


@pytest.fixture
def small_blocks(monkeypatch):
    """JAX's flash2 blocks at 128, so S=300 runs 3 x 3 tiles."""
    for name in ("_BQ", "_BK", "_BWD_BQ", "_BWD_BK"):
        monkeypatch.setattr(jax_flash2, name, 128)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("s,blocks", [(200, "default"), (300, "128")])
def test_flash2_plain_matches_jax_kernels(s, blocks, fused, monkeypatch,
                                          request):
    """flash_attention2_plain's forward and gradients against JAX's
    flash_attention2 in interpret mode: S=200 pads one block, S=300 with
    128-blocks runs multi-block tiles; the backward through the fused
    kernel and, with ``_FUSED_BWD=False``, through the split pair."""
    if blocks == "128":
        request.getfixturevalue("small_blocks")
    monkeypatch.setattr(jax_flash2, "_FUSED_BWD", fused)
    q, k, v, dout, bias = inputs(2, s, 128, seed=s)

    def jax_fwd(q, k, v):
        return jax_flash2.flash_attention2(q, k, v, jnp.asarray(bias), None,
                                           HEADS, 0.0, True)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref, vjp = jax.vjp(jax_fwd, jq, jk, jv)
    ref_grads = vjp(jnp.asarray(dout))

    qq, kk, vv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = F2.flash_attention2(qq, kk, vv, torch.from_numpy(bias), HEADS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FWD_TOL, rtol=FWD_TOL)
    grads = torch.autograd.grad(out, (qq, kk, vv), torch.from_numpy(dout))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("dtype,s,fused", [
    (torch.bfloat16, 1024, True),
    (torch.bfloat16, 2048, True),    # bk capped to 512 from S=2048
    (torch.bfloat16, 4096, False),
    (torch.float32, 1024, False),
    (torch.float32, 768, True),      # "always" sends 512 < S < 1024 here
    (torch.bfloat16, 512, True),
])
def test_use_fused_backward_takes_jax_route(dtype, s, fused):
    """The fused-or-split rule at bert-large's d=64 (2 heads per 128-lane
    group), the routes JAX's _flash2_bwd takes at these lengths."""
    assert F2.use_fused_backward(s, 1024, 16, dtype) is fused


@pytest.mark.parametrize("s", [40, 200, 300, 536, 1024, 1536, 2048, 3000,
                               4096])
def test_flash2_blocks_match_jax(s):
    assert F2._blocks_for(s) == jax_flash2._blocks_for(
        s, jax_flash2._BQ, jax_flash2._BK)
    assert F2._blocks_for(s) == jax_flash2._blocks_for(
        s, jax_flash2._BWD_BQ, jax_flash2._BWD_BK)


@pytest.mark.parametrize("use_flash,s,on_cuda,route", [
    ("auto", 40, True, "short"),
    ("auto", 768, True, "short"),      # JAX: XLA; the port keeps its kernel
    ("auto", 1023, True, "short"),
    ("auto", 1024, True, "flash2"),
    ("auto", 4096, True, "flash2"),
    ("always", 512, True, "short"),
    ("always", 513, True, "flash2"),
    ("always", 1024, True, "flash2"),
    ("never", 4096, True, "plain"),
    ("auto", 1024, False, "plain"),
    ("always", 768, False, "plain"),
])
def test_attention_route(use_flash, s, on_cuda, route):
    assert attention_route(use_flash, s, on_cuda) == route


def test_attention_route_rejects_unknown_use_flash():
    with pytest.raises(ValueError):
        attention_route("sometimes", 1024, True)


def test_multi_head_attention_long_cpu_is_plain():
    """S >= 1024 on CPU tensors: the plain path, no kernel launch counted."""
    q, k, v, _, bias = (torch.from_numpy(x) for x in inputs(2, 1024, 128, 3))
    before = (F2.flash_attention2.launches, short_attention.launches)
    out = multi_head_attention(q, k, v, bias[:, None, None, :],
                               num_heads=HEADS)
    torch.testing.assert_close(
        out, F2.flash_attention2_plain(q, k, v, bias, HEADS), atol=0, rtol=0)
    assert (F2.flash_attention2.launches, short_attention.launches) == before


def test_flash2_cpu_refuses_in_kernel_dropout():
    q = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="needs a seed"):
        F2.flash_attention2(q, q, q, torch.zeros(1, 8), HEADS, 0.1015625)
    with pytest.raises(ValueError, match="CUDA tensors"):
        F2.flash_attention2(q, q, q, torch.zeros(1, 8), HEADS, 0.1015625,
                            seed=3)


@pytest.mark.parametrize("lp", [None, 24, 984])
def test_step_flops_frame_level_match_jax(lp):
    """mmbert_step_flops with and without the frame-level pair length: the
    port's copy against JAX's, at bert-large widths (the port's config
    built from the JAX one)."""
    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
    cfg = PortExperimentConfig.from_json(exp.to_json()).model
    for b, l in ((16, 40), (96, 40), (2, 12)):
        assert mmbert_step_flops(cfg, b, l, pair_seq=lp) == jax_step_flops(
            exp.model, b, l, pair_seq=lp)


@pytest.mark.parametrize("s,dtype,fused,want", [
    (1024, torch.bfloat16, None, "fused"),
    (4096, torch.bfloat16, None, "split"),
    (1024, torch.float32, None, "split"),
    (1024, torch.bfloat16, False, "split"),
    (4096, torch.bfloat16, True, "fused"),
])
def test_flash_attention2_backward_takes_the_route(s, dtype, fused, want,
                                                   monkeypatch):
    """``fused=None`` follows use_fused_backward at bert-large's widths;
    True / False force one kernel (the kernels are stubbed: they run only
    on a card)."""
    calls = []
    for route in ("fused", "split"):
        monkeypatch.setattr(F2, f"flash2_bwd_{route}",
                            lambda *a, route=route: calls.append(route))
    q = torch.empty(1, s, 1024, dtype=dtype)
    F2.flash_attention2_backward(q, q, q, None, None, None, None, 16,
                                 fused=fused)
    assert calls == [want]
