"""msa_tpu_torch's flash2 module on the CPU against the JAX package.

On the CPU the flash2 wrapper runs its plain PyTorch version (the CUDA
kernels of ``csrc/flash2.cu`` build and run only on a card; chip_smoke.py
holds them against this plain version there).  The JAX side runs its
Pallas flash2 kernels in interpret mode, as ``tests/test_flash2.py`` runs
them, with both of its backward routes.  Inputs come from numpy seeds.

Tolerances (JAX's own ``test_flash2.py`` bounds): forward atol = rtol =
1e-5 in f32, gradients 2e-4 -- the same function summed in another order
(JAX in base-2 blocks with an online softmax, the port in one einsum).
The rounded backward rule ``flash_attention2_backward_plain`` (the CUDA
kernels' oracle) against JAX's bf16 gradients within 2e-3 absolute and
8e-3 relative, two bf16 ulps (as test_torch_short_attention_v2_bwd.py):
both sides round dS and pd to bf16, and a sum taken in another order can
move a rounded dS to its neighbour.  Head dim 64 (H = 128) and 32 (H =
64, ``-d32``).  Under dropout the two frameworks draw other masks, so the
rule's dropout order is held here against a dense copy of JAX's fused
backward in jnp on one shared mask, and against the kernels by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msa_tpu.ops.flash2 as jax_flash2
from msa_tpu.configs import build_experiment
from msa_tpu.utils.flops import mmbert_step_flops as jax_step_flops
from msa_tpu_torch import _build
from msa_tpu_torch.configs import ExperimentConfig as PortExperimentConfig
from msa_tpu_torch.ops import attention as A
from msa_tpu_torch.ops import flash2 as F2
from msa_tpu_torch.ops import short_attention as sa
from msa_tpu_torch.ops.attention import attention_route, multi_head_attention
from msa_tpu_torch.ops.short_attention import kernel_head_dim, short_attention
from msa_tpu_torch.utils.flops import mmbert_step_flops
from test_torch_wide_tc import Recorder

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
BF16_TOL = (2e-3, 8e-3)  # (atol, rtol)
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
@pytest.mark.parametrize("s,blocks,h", [
    pytest.param(200, "default", 128, id="200-default"),
    pytest.param(300, "128", 128, id="300-128"),
    pytest.param(200, "default", 64, id="200-default-d32")])
def test_flash2_plain_matches_jax_kernels(s, blocks, h, fused, monkeypatch,
                                          request):
    """flash_attention2_plain's forward and gradients against JAX's
    flash_attention2 in interpret mode: S=200 pads one block, S=300 with
    128-blocks runs multi-block tiles; the backward through the fused
    kernel and, with ``_FUSED_BWD=False``, through the split pair."""
    if blocks == "128":
        request.getfixturevalue("small_blocks")
    check_plain_against_jax(s, h, fused, monkeypatch)


@pytest.mark.parametrize("h", [pytest.param(128, id="d64"),
                               pytest.param(64, id="d32")])
@pytest.mark.parametrize("s", [127, 129])
def test_flash2_split_plain_matches_jax_at_block_edges(s, h, monkeypatch):
    """The plain forward and gradients against JAX's flash2 with the split
    pair (``_FUSED_BWD=False``) one row short of and one past a 128-row
    block, where the CUDA forward and dq launch end a query block and the
    dk/dv launch's ring ends a query tile."""
    check_plain_against_jax(s, h, False, monkeypatch)


def check_plain_against_jax(s, h, fused, monkeypatch):
    """flash_attention2_plain's forward and autograd gradients against jax.vjp
    of JAX's flash_attention2 (interpret mode, the fused kernel or the
    split pair) at B=2, S=s, H=h."""
    monkeypatch.setattr(jax_flash2, "_FUSED_BWD", fused)
    q, k, v, dout, bias = inputs(2, s, h, seed=s)

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


@pytest.mark.parametrize("fused,h", [
    pytest.param(True, 128, id="fused"), pytest.param(False, 128, id="split"),
    pytest.param(True, 64, id="fused-d32"),
    pytest.param(True, 256, id="fused-d128"),
    pytest.param(True, 32, id="fused-d16")])
def test_flash2_rounded_backward_rule_matches_jax_bf16(fused, h, monkeypatch):
    """flash_attention2_backward_plain in bf16 at rate 0, given JAX's bf16
    output (its backward's ``o``) and the row lse in log2 units, against
    jax.vjp of JAX's flash2 (interpret mode) through the fused kernel or
    the split pair; and the rule with its roundings lies closer to JAX's
    gradients than the same rule without them (the f32 gradient of the bf16
    inputs), for every gradient.  The fused route at head dims 16, 32, 64
    and 128: the rule its sweeps are held to on the card."""
    monkeypatch.setattr(jax_flash2, "_FUSED_BWD", fused)
    q, k, v, dout, bias = inputs(2, 200, h, seed=7)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    jout, vjp = jax.vjp(lambda *x: jax_flash2.flash_attention2(
        *x, jnp.asarray(bias), None, HEADS, 0.0, True), jq, jk, jv)
    ref = [np.asarray(g, np.float32) for g in vjp(jdo)]
    tq, tk, tv, tdo, tout = (torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16) for x in (jq, jk, jv, jdo, jout))
    tbias = torch.from_numpy(bias)
    b, s, _ = tq.shape
    split = lambda x: x.float().reshape(b, s, HEADS, -1)  # noqa: E731
    logits = torch.einsum("bqnd,bknd->bnqk", split(tq), split(tk)) / np.sqrt(
        h // HEADS) + tbias[:, None, None, :]
    lse = torch.logsumexp(logits, -1) / np.log(2.0)
    got = F2.flash_attention2_backward_plain(tq, tk, tv, tbias, tout, lse,
                                             tdo, HEADS)
    wide = F2.flash_attention2_backward_plain(
        *(x.float() for x in (tq, tk, tv)), tbias, tout, lse, tdo.float(),
        HEADS)
    for name, g, w, r in zip(("dq", "dk", "dv"), got, wide, ref):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), r, atol=BF16_TOL[0],
                                   rtol=BF16_TOL[1], err_msg=name)
        err = np.abs(g.float().numpy() - r).max()
        err_wide = np.abs(w.to(torch.bfloat16).float().numpy() - r).max()
        assert err < err_wide, (name, err, err_wide)


def jax_order_backward(q, k, v, bias, out, lse, dout, keep, rate, weak):
    """JAX's ``_bwd_fused_kernel`` (msa_tpu/ops/flash2.py:355) in jnp on
    dense [B, heads, S, S] tiles with a given keep mask: scores in the base-2
    domain, p = exp2(s - lse), delta from the unscaled dO, then dO times
    1 / (1 - rate) -- a weakly typed Python float as that kernel writes it
    (``weak``), else an f32 array -- rounded to dO's dtype; pd the kept p
    unscaled; dS and pd rounded to the dtype before their products."""
    b, s, h = q.shape
    d = h // HEADS
    f32 = jnp.float32

    def split(x):
        return x.reshape(b, s, HEADS, d).transpose(0, 2, 1, 3)

    qg, kg, vg, dog, og = map(split, (q, k, v, dout, out))
    scale = 1.0 / np.sqrt(d)
    log2e = 1.0 / np.log(2.0)
    sc = jnp.einsum("bnqd,bnkd->bnqk", qg, kg, preferred_element_type=f32) \
        * (scale * log2e) + (bias * log2e)[:, None, None, :]
    p = jnp.exp2(sc - lse[..., None])
    delta = jnp.sum(dog.astype(f32) * og.astype(f32), -1, keepdims=True)
    inv = 1.0 / (1.0 - rate)
    dog = (dog * (inv if weak else jnp.asarray(inv, f32))).astype(dog.dtype)
    dp = jnp.einsum("bnqd,bnkd->bnqk", dog, vg, preferred_element_type=f32)
    pd, dpm = jnp.where(keep, p, 0.0), jnp.where(keep, dp, 0.0)
    ds = (p * (dpm - delta)).astype(q.dtype)
    dv = jnp.einsum("bnqk,bnqd->bnkd", pd.astype(dog.dtype), dog,
                    preferred_element_type=f32)
    dk = jnp.einsum("bnqk,bnqd->bnkd", ds, qg,
                    preferred_element_type=f32) * scale
    dq = jnp.einsum("bnqk,bnkd->bnqd", ds, kg,
                    preferred_element_type=f32) * scale
    return [np.asarray(x.transpose(0, 2, 1, 3).reshape(b, s, h).astype(q.dtype),
                       np.float32) for x in (dq, dk, dv)]


@pytest.mark.parametrize("h", [pytest.param(128, id="d64"),
                               pytest.param(64, id="d32"),
                               pytest.param(256, id="d128")])
def test_flash2_rounded_backward_rule_dropout_order(h):
    """flash_attention2_backward_plain in bf16 under dropout (rate 26/256)
    against :func:`jax_order_backward` on the same keep mask, the same f32
    output and lse: within the bf16 tolerance, and nearer on average, in
    every gradient, to JAX's order (the factor rounded to bf16 with dO) than
    to the same order with the f32 factor."""
    rate = 26 / 256
    q, k, v, dout, bias = inputs(2, 40, h, seed=11)
    keep = np.random.default_rng(12).random((2, HEADS, 40, 40)) >= rate
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, dout))
    tbias, tkeep = torch.from_numpy(bias), torch.from_numpy(keep)
    out = F2.flash_attention2_plain(*(x.float() for x in (tq, tk, tv)), tbias,
                                    HEADS, rate, tkeep)
    b, s, _ = tq.shape
    split = lambda x: x.float().reshape(b, s, HEADS, -1)  # noqa: E731
    logits = torch.einsum("bqnd,bknd->bnqk", split(tq), split(tk)) / np.sqrt(
        h // HEADS) + tbias[:, None, None, :]
    lse = torch.logsumexp(logits, -1) / np.log(2.0)
    got = F2.flash_attention2_backward_plain(tq, tk, tv, tbias, out, lse, tdo,
                                             HEADS, rate, tkeep)
    jx = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq, tk, tv,
                                                                 tdo)]
    args = (*jx[:3], jnp.asarray(bias), jnp.asarray(out.numpy()),
            jnp.asarray(lse.numpy()), jx[3], jnp.asarray(keep), rate)
    ref = jax_order_backward(*args, weak=True)
    strong = jax_order_backward(*args, weak=False)
    for name, g, r, f in zip(("dq", "dk", "dv"), got, ref, strong):
        g = g.float().numpy()
        np.testing.assert_allclose(g, r, atol=BF16_TOL[0], rtol=BF16_TOL[1],
                                   err_msg=name)
        assert np.abs(g - r).mean() < np.abs(g - f).mean(), name


def check_fused_entry(d, monkeypatch):
    """flash2_bwd_fused at head dim ``d`` in bf16 through a stand-in
    library: one call of the C entry of ``flash2_d<kd>`` (kd the kernel
    head dim d runs on), its arguments in ``_SIGNATURES`` order, with the
    delta scratch [B, heads, S] f32 that the pre-pass writes and the f32 dq
    buffer [B, S, heads x kd] that it zeroes and the sweep sums into,
    counted as two launches; dq, dk and dv come back in bf16 at the
    caller's width."""
    lib, scratch, kd = Recorder(), [], kernel_head_dim(d)

    def record(q, lse):
        scratch.append((torch.empty_like(lse),
                        torch.empty(q.shape, dtype=torch.float32)))
        return scratch[-1]

    monkeypatch.setattr(_build, "load", lib.load)
    monkeypatch.setattr(F2, "_check", lambda *a, **k: None)
    monkeypatch.setattr(F2, "_stream", lambda x: 0)
    monkeypatch.setattr(F2, "fused_scratch", record)
    b, s = 2, 20
    q, k, v, dout = (torch.zeros(b, s, HEADS * d, dtype=torch.bfloat16)
                     for _ in range(4))
    out32 = torch.zeros(b, s, HEADS * d)
    lse, bias = torch.zeros(b, HEADS, s), torch.zeros(b, s)
    before = F2.flash2_bwd_fused.launches
    grads = F2.flash2_bwd_fused(q, k, v, bias, out32, lse, dout, HEADS,
                                seed=5, rate=26 / 256)
    assert F2.flash2_bwd_fused.launches == before + 2
    assert lib.loaded == [f"flash2_d{kd}"]
    ((entry, args),) = lib.calls
    assert entry == "msa_flash2_bwd_fused"
    assert len(args) == len(F2._SIGNATURES[entry])
    ((delta, dq32),) = scratch
    assert delta.shape == (b, HEADS, s) and delta.dtype == torch.float32
    assert dq32.shape == (b, s, HEADS * kd) and dq32.dtype == torch.float32
    assert args[7:9] == (delta.data_ptr(), dq32.data_ptr())
    assert args[11:16] == (b, s, HEADS * kd, HEADS, 1)  # bf16
    assert args[-4:-1] == (5, 0, 26 / 256)  # the seed's words, the rate
    for g in grads:
        assert g.shape == q.shape and g.dtype == torch.bfloat16


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_fused_entry_hands_the_sweep_its_scratch(d, monkeypatch):
    """The bf16 fused entry at d = 16, 32, 64 and 128, each on its own
    library (the warpgroup sweep from 64, the mma.sync one at 16 and 32),
    by :func:`check_fused_entry`."""
    check_fused_entry(d, monkeypatch)


@pytest.mark.parametrize("layout", ["flash2", "head_split"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_forward_entry_launches_once_on_its_head_dims_library(d, layout,
                                                              monkeypatch):
    """The bf16 training forward of either layout at head dim ``d`` through
    a stand-in library: one call of its C entry (``msa_flash2_fwd``, or
    ``msa_flash_attention_fwd`` for the head-split layout) on the head
    dim's library (``flash2_d<d>`` / ``flash_attention_d<d>``, which picks
    the kernel: the warp-specialised forward at 64 and 128), its arguments
    in ``_SIGNATURES`` order (the buffers it returns, the widths, the
    scale, the seed's words, the rate, the stream), counted as one
    launch."""
    lib = Recorder()
    monkeypatch.setattr(_build, "load", lib.load)
    monkeypatch.setattr(sa, "_stream", lambda x: 0)
    monkeypatch.setattr(A, "_stream", lambda x: 0)
    b, s, rate = 2, 20, 26 / 256
    bias = torch.zeros(b, s)
    if layout == "flash2":
        q, k, v = (torch.zeros(b, s, HEADS * d, dtype=torch.bfloat16)
                   for _ in range(3))
        counter, entry, signatures = (F2.flash_attention2, "msa_flash2_fwd",
                                      F2._SIGNATURES)
        before = counter.launches
        out, lse, out32 = F2._forward_kernel(q, k, v, bias, HEADS, 5, rate,
                                             True)
        buffers, widths = (out, lse, out32), (b, s, HEADS * d, HEADS, 1)
    else:
        q, k, v = (torch.zeros(b, HEADS, s, d, dtype=torch.bfloat16)
                   for _ in range(3))
        counter, entry, signatures = (A.flash_attention,
                                      "msa_flash_attention_fwd", A._SIGNATURES)
        before = counter.launches
        out, lse = A._forward_kernel(q, k, v, bias, 5, rate, True)
        buffers, widths = (out, lse), (b, HEADS, s, d, 1)
    assert counter.launches == before + 1
    library = "flash2" if layout == "flash2" else "flash_attention"
    assert lib.loaded == [f"{library}_d{d}"]
    ((name, args),) = lib.calls
    assert name == entry and len(args) == len(signatures[entry])
    n = 4 + len(buffers)  # q, k, v, the bias, then the outputs
    assert all(isinstance(x, int) for x in args[:n])
    assert args[4:n] == tuple(x.data_ptr() for x in buffers)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (b, HEADS, s) and lse.dtype == torch.float32
    assert args[n:n + 5] == widths  # bf16
    assert args[n + 5] == pytest.approx(1 / np.sqrt(d))
    assert args[n + 6:] == (5, 0, rate, 0)  # the seed's words, rate, stream


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


@pytest.mark.parametrize("dtype,code", [
    pytest.param(torch.bfloat16, 1, id="bf16"),
    pytest.param(torch.float32, 0, id="f32")])
def test_flash2_bwd_fused_wrapper_hands_the_prepass_its_scratch(dtype, code,
                                                                 monkeypatch):
    """The fused route's host side (its kernels run only on a card): one
    call of the C entry with delta [B, heads, S] f32 and the [B, S, H] f32
    dq buffer that its pre-pass fills, counted as two launches (pre-pass
    and sweep); dq comes back from that buffer in q's dtype."""
    calls, scratch = [], []

    class Lib:
        def msa_flash2_bwd_fused(self, *args):
            calls.append(args)
            return 0

    def record(q, lse):
        scratch.extend(real(q, lse))
        scratch[1].fill_(0.5)  # what the sweep's atomics would leave
        return tuple(scratch)

    real = F2.fused_scratch
    monkeypatch.setattr(F2._build, "load", lambda name, sigs: Lib())
    monkeypatch.setattr(F2, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(F2, "_stream", lambda x: 0)
    monkeypatch.setattr(F2, "fused_scratch", record)
    b, s, h = 2, 20, 64
    q, k, v, dout = (torch.zeros(b, s, h, dtype=dtype) for _ in range(4))
    out32, lse = torch.zeros(b, s, h), torch.zeros(b, HEADS, s)
    before = F2.flash2_bwd_fused.launches
    dq, dk, dv = F2.flash2_bwd_fused(q, k, v, torch.zeros(b, s), out32, lse,
                                     dout, HEADS, seed=5, rate=0.1015625)
    assert F2.flash2_bwd_fused.launches == before + 2
    (args,) = calls
    assert len(args) == len(F2._SIGNATURES["msa_flash2_bwd_fused"])
    delta, dq32 = scratch
    assert delta.shape == (b, HEADS, s) and delta.dtype == torch.float32
    assert dq32.shape == (b, s, h) and dq32.dtype == torch.float32
    assert args[7:11] == (delta.data_ptr(), dq32.data_ptr(), dk.data_ptr(),
                          dv.data_ptr())
    assert args[11:16] == (b, s, h, HEADS, code)
    assert args[-2] == 26 / 256  # the rate itself (the C entry picks its rule)
    assert dq.dtype == dtype and torch.equal(dq.float(), dq32)


@pytest.mark.parametrize("dtype,code,d", [
    pytest.param(torch.bfloat16, 1, 32, id="bf16"),
    pytest.param(torch.float32, 0, 32, id="f32"),
    pytest.param(torch.bfloat16, 1, 192, id="bf16-d192"),
    pytest.param(torch.bfloat16, 1, 256, id="bf16-d256")])
def test_flash2_bwd_split_wrapper_hands_the_dq_launch_its_delta(dtype, code, d,
                                                                monkeypatch):
    """The split route's host side (its kernels run only on a card): one
    call of the C entry of the library of head dim d (d = 192 padded onto
    256, whose bf16 pair runs the warpgroup kernels there too), its
    arguments in ``_SIGNATURES`` order, with the delta scratch [B, heads,
    S] f32 that its dq launch writes for the dk/dv launch, counted as two
    launches; dq, dk and dv come back in q's dtype at the caller's width."""
    calls, scratch, loaded = [], [], []

    class Lib:
        def msa_flash2_bwd_split(self, *args):
            calls.append(args)
            return 0

    def record(lse):
        scratch.append(real(lse))
        return scratch[-1]

    def load(name, sigs):
        loaded.append(name)
        return Lib()

    real = F2.delta_scratch
    monkeypatch.setattr(F2._build, "load", load)
    monkeypatch.setattr(F2, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(F2, "_stream", lambda x: 0)
    monkeypatch.setattr(F2, "delta_scratch", record)
    kd = 256 if d > 128 else d  # the library's head dim
    b, s, h = 2, 20, HEADS * d
    q, k, v, dout = (torch.zeros(b, s, h, dtype=dtype) for _ in range(4))
    out32, lse = torch.zeros(b, s, h), torch.zeros(b, HEADS, s)
    before = F2.flash2_bwd_split.launches
    bias = torch.zeros(b, s)
    dq, dk, dv = F2.flash2_bwd_split(q, k, v, bias, out32, lse, dout, HEADS,
                                     seed=5, rate=0.1015625)
    assert F2.flash2_bwd_split.launches == before + 2
    assert loaded == [f"flash2_d{kd}"]
    (args,) = calls
    assert len(args) == len(F2._SIGNATURES["msa_flash2_bwd_split"])
    (delta,) = scratch
    assert delta.shape == (b, HEADS, s) and delta.dtype == torch.float32
    if d == kd:  # no pad: the caller's tensors themselves
        assert args[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), out32.data_ptr(), dout.data_ptr(),
                            lse.data_ptr())
        assert args[7:11] == (delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr())
    else:
        assert args[3] == bias.data_ptr() and args[6:8] == (lse.data_ptr(),
                                                            delta.data_ptr())
    assert args[11:16] == (b, s, HEADS * kd, HEADS, code)
    assert args[-4:-1] == (5, 0, 26 / 256)  # the seed's words, the rate
    for g in (dq, dk, dv):
        assert g.shape == q.shape and g.dtype == dtype
