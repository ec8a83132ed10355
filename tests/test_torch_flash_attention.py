"""msa_tpu_torch's head-split flash attention (kernel row 13) on the CPU
against the JAX package.

On the CPU ``flash_attention`` runs its plain PyTorch versions (the CUDA
kernels of ``csrc/flash_attention.cu`` build and run only on a card;
chip_smoke.py holds them against these plain versions there): the forward
and, under autograd, ``flash_attention_backward_plain``, which follows
JAX's ``_flash_dq_kernel`` / ``_flash_dkv_kernel`` (p from the saved lse,
delta = rowsum(dO * o)).  The JAX side runs ``_flash_attention`` in
interpret mode, as ``tests/test_flash_attention.py`` runs it.  Inputs come
from numpy seeds.

Tolerances (JAX's own ``test_flash_attention.py`` bounds): forward and lse
atol = rtol = 1e-5 in f32, gradients 2e-4 -- the same function summed in
another order (JAX in blocks with an online softmax, the port in one
einsum).  The port against itself (the plain backward against autograd
through the plain forward, the dispatch against the plain attention):
2e-5, f32 rounding of the same math in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.ops import attention as jax_attention
from msa_tpu_torch.ops import attention as A
from msa_tpu_torch.ops.dropout import keep_mask_plain

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
SELF_TOL = 2e-5
B, HEADS, D = 2, 2, 64


def inputs(s, seed, b=B, d=D):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, HEADS, s, d)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0            # key padding across a block boundary
    mask[1, 3:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, dout, bias


def jax_blocks(s, block):
    """The dispatcher's blocks (min(512, round_up(S, 128))) or ``block``."""
    b = block or min(jax_attention._FLASH_BQ, -(-s // 128) * 128)
    return b, b


# S=300 with 128-blocks runs 3 x 3 tiles; the others one or two
CASES = [(8, None), (40, None), (200, None), (300, 128)]


@pytest.mark.parametrize("s,block", CASES)
def test_flash_attention_plain_forward_and_lse_match_jax(s, block):
    """The plain forward and its natural-log lse against
    ``_flash_forward_dispatch(..., with_lse=True)`` (interpret mode), the
    lse sliced to S."""
    q, k, v, _, bias = inputs(s, seed=s)
    bq, bk = jax_blocks(s, block)
    ref, ref_lse = jax_attention._flash_forward_dispatch(
        *(jnp.asarray(x) for x in (q, k, v, bias)), None, bq, bk, 0.0,
        with_lse=True, interpret=True)
    out, lse = A.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, bias)), with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0, :s],
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("s,block", CASES)
def test_flash_attention_gradients_match_jax(s, block):
    """flash_attention's output and gradients (the autograd pair with the
    plain backward on CPU tensors) against jax.vjp through
    ``_flash_attention`` (its dq and dk/dv Pallas kernels in interpret
    mode)."""
    check_against_jax(s, block, D)


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("s", [127, 129])
def test_flash_attention_gradients_match_jax_at_block_edges(s, d):
    """The same one row short of and one past a 128-row block, where the
    CUDA forward and dq launch end a query block and the dk/dv launch's
    ring ends a query tile, at head dim 64 and 32."""
    check_against_jax(s, None, d)


def check_against_jax(s, block, d):
    """flash_attention's output and gradients against jax.vjp through
    ``_flash_attention`` at B=2, S=s, head dim d."""
    q, k, v, dout, bias = inputs(s, seed=100 + s, d=d)
    bq, bk = jax_blocks(s, block)

    def jax_fwd(q, k, v):
        return jax_attention._flash_attention(q, k, v, jnp.asarray(bias), None,
                                              bq, bk, 0.0, True)

    ref, vjp = jax.vjp(jax_fwd, *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(dout))
    qq, kk, vv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = A.flash_attention(qq, kk, vv, torch.from_numpy(bias))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FWD_TOL, rtol=FWD_TOL)
    grads = torch.autograd.grad(out, (qq, kk, vv), torch.from_numpy(dout))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 26 / 256])
def test_flash_attention_backward_plain_matches_autograd(rate):
    """JAX's backward rule (p from the lse, delta = rowsum(dO * o) with o the
    dropped, rescaled output) equals autograd through the plain forward,
    with and without a keep mask."""
    q, k, v, dout, bias = (torch.from_numpy(x) for x in inputs(70, seed=7))
    keep = keep_mask_plain(11, rate, B, HEADS, 70) if rate else None
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = A.flash_attention_plain(qq, kk, vv, bias, rate, keep,
                                       with_lse=True)
    ref = torch.autograd.grad(out, (qq, kk, vv), dout)
    got = A.flash_attention_backward_plain(q, k, v, bias, out.detach(),
                                           lse.detach(), dout, rate, keep)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(g, r, atol=SELF_TOL, rtol=SELF_TOL,
                                   msg=name)


def test_flash_attention_saves_jax_residuals():
    """Under autograd the pair keeps q, k, v, the bias, the output and the
    row lse (``_flash_fwd``'s residuals); with ``recompute`` the q, k and v
    are not kept and the gradients are unchanged."""
    q, k, v, dout, bias = (torch.from_numpy(x) for x in inputs(24, seed=5))
    runs = {}
    for rec in (False, True):
        saved = []
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x) or x, lambda x: x):
            out = A.flash_attention(
                qq, kk, vv, bias,
                recompute=(lambda: (q, k, v)) if rec else None)
        runs[rec] = torch.autograd.grad(out, (qq, kk, vv), dout)
        shapes = sorted(tuple(x.shape) for x in saved)
        want = [(B, 24), (B, HEADS, 24)] + [(B, HEADS, 24, D)] * (1 if rec else 4)
        assert shapes == sorted(want)
    for a, b in zip(runs[False], runs[True]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.fixture
def long_route(monkeypatch):
    """The long route on CPU tensors (it takes a kernel only on CUDA), with
    the entries it calls recorded."""
    calls = []
    monkeypatch.setattr(A, "attention_route", lambda *a: "flash2")
    for name in ("flash_attention", "flash_attention2"):
        real = getattr(A, name)

        def record(*args, real=real, name=name, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(A, name, record)
    return calls


@pytest.mark.parametrize("use_flash2,entry", [
    (True, "flash_attention2"), (False, "flash_attention")])
def test_use_flash2_picks_the_long_route_kernel(long_route, monkeypatch,
                                               use_flash2, entry):
    """``USE_FLASH2`` read at call time: True hands the long route to
    flash_attention2, False to the head-split flash_attention between head
    transposes.  Either way the output and gradients are the plain
    attention's."""
    monkeypatch.setattr(A, "USE_FLASH2", use_flash2)
    rng = np.random.default_rng(9)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (B, 60, HEADS * D)).astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(inputs(60, seed=9)[4])
    runs = []
    for route in ("kernel", "plain"):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        if route == "kernel":
            out = A.multi_head_attention(qq, kk, vv, bias[:, None, None, :],
                                         num_heads=HEADS)
        else:
            out = A.short_attention_plain(qq, kk, vv, bias, HEADS)
        runs.append((out, *torch.autograd.grad(out, (qq, kk, vv), dout)))
    assert long_route == [entry]
    for name, a, b in zip(("out", "dq", "dk", "dv"), *runs):
        torch.testing.assert_close(a, b, atol=SELF_TOL, rtol=SELF_TOL, msg=name)


def test_use_flash2_off_passes_recompute(long_route, monkeypatch):
    """The save_ctx rung's ``recompute`` reaches the head-split entry: q, k,
    v ([B, S, H]) are given back and split again in the backward, and the
    gradients equal those of a run that saves them."""
    monkeypatch.setattr(A, "USE_FLASH2", False)
    q, k, v = (torch.randn(B, 20, HEADS * D, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    bias = torch.zeros(B, 1, 1, 20)
    grads = {}
    for rec in (False, True):
        w = torch.ones(HEADS * D, requires_grad=True)
        calls = []

        def proj(w=w):
            return q * w, k * w, v * w

        def recompute(proj=proj, calls=calls):
            calls.append(1)
            return proj()

        out = A.multi_head_attention(*proj(), bias, num_heads=HEADS,
                                     recompute=recompute if rec else None)
        (grads[rec],) = torch.autograd.grad(out.square().sum(), (w,))
        assert calls == ([1] if rec else [])
    torch.testing.assert_close(grads[True], grads[False], atol=0, rtol=0)


@pytest.mark.parametrize("use_flash2", [True, False])
def test_long_route_matches_jax_dispatch(long_route, monkeypatch, use_flash2):
    """multi_head_attention on the long route against JAX's with its own
    switch flipped alike (``use_flash="always"`` at S=520 > 512: JAX's
    flash route in interpret mode), forward and gradients."""
    monkeypatch.setattr(A, "USE_FLASH2", use_flash2)
    monkeypatch.setattr(jax_attention, "_USE_FLASH2", use_flash2)
    s, h = 520, HEADS * D
    rng = np.random.default_rng(12)
    q, k, v, dout = (rng.standard_normal((B, s, h)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((B, s), np.float32)
    mask[0, 300:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)[:, None, None, :]

    def jax_fwd(q, k, v):
        return jax_attention.multi_head_attention(
            q, k, v, jnp.asarray(bias), num_heads=HEADS, use_flash="always")

    ref, vjp = jax.vjp(jax_fwd, *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(dout))
    qq, kk, vv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = A.multi_head_attention(qq, kk, vv, torch.from_numpy(bias),
                                 num_heads=HEADS, use_flash="always")
    assert long_route == ["flash_attention2" if use_flash2 else
                          "flash_attention"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FWD_TOL, rtol=FWD_TOL)
    grads = torch.autograd.grad(out, (qq, kk, vv), torch.from_numpy(dout))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_flash_attention_cpu_refuses_in_kernel_dropout():
    q = torch.zeros(1, HEADS, 8, D)
    with pytest.raises(ValueError, match="needs a seed"):
        A.flash_attention(q, q, q, torch.zeros(1, 8), 26 / 256)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.flash_attention(q, q, q, torch.zeros(1, 8), 26 / 256, seed=3)
    with pytest.raises(ValueError, match="multiple of 1/256"):
        A.flash_attention(q, q, q, torch.zeros(1, 8), 0.1, seed=3)


def test_flash_attention_kernel_entries_refuse_cpu_tensors():
    """The kernel entries raise on CPU tensors rather than fall back."""
    q = torch.zeros(1, HEADS, 8, D)
    lse = torch.zeros(1, HEADS, 8)
    with pytest.raises(ValueError, match="no kernel"):
        A.flash_attention_backward(q, q, q, torch.zeros(1, 8), q, lse, q)
    with pytest.raises(ValueError, match="no kernel"):
        A._check_heads(q, q, q, None, "flash_attention")


@pytest.mark.parametrize("dtype,code", [
    pytest.param(torch.bfloat16, 1, id="bf16"),
    pytest.param(torch.float32, 0, id="f32")])
def test_flash_attention_backward_wrapper_hands_the_dq_launch_its_delta(
        dtype, code, monkeypatch):
    """The backward pair's host side (its kernels run only on a card): one
    call of the C entry, its arguments in ``_SIGNATURES`` order, with the
    delta scratch [B, heads, S] f32 that the dq launch writes for the dk/dv
    launch, counted as two launches; dq, dk and dv come back in q's dtype
    and layout."""
    calls, scratch = [], []

    class Lib:
        def msa_flash_attention_bwd(self, *args):
            calls.append(args)
            return 0

    def record(lse):
        scratch.append(torch.empty_like(lse))
        return scratch[-1]

    monkeypatch.setattr(A._build, "load", lambda name, sigs: Lib())
    monkeypatch.setattr(A, "_check_heads", lambda *a, **kw: None)
    monkeypatch.setattr(A, "_stream", lambda x: 0)
    monkeypatch.setattr(A, "delta_scratch", record)
    b, s, d = 2, 20, 32
    q, k, v, out, dout = (torch.zeros(b, HEADS, s, d, dtype=dtype)
                          for _ in range(5))
    lse = torch.zeros(b, HEADS, s)
    before = A.flash_attention_backward.launches
    bias = torch.zeros(b, s)
    dq, dk, dv = A.flash_attention_backward(q, k, v, bias, out, lse, dout,
                                            seed=5, rate=26 / 256)
    assert A.flash_attention_backward.launches == before + 2
    (args,) = calls
    assert len(args) == len(A._SIGNATURES["msa_flash_attention_bwd"])
    (delta,) = scratch
    assert delta.shape == (b, HEADS, s) and delta.dtype == torch.float32
    assert args[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr())
    assert args[7:11] == (delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr())
    assert args[11:16] == (b, HEADS, s, d, code)
    assert args[-4:-1] == (5, 0, 26)  # the seed's words, the rate's threshold
    for g in (dq, dk, dv):
        assert g.shape == q.shape and g.dtype == dtype
