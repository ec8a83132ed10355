"""The bf16 flash rules at head dim 256 on the CPU against the JAX package.

At head dim 256 the bf16 flash forward (kernel rows 10 and 13: flash2's
``_fwd_kernel`` and the head-split ``_flash_kernel``), flash2's fused
backward (row 11, ``_bwd_fused_kernel``) and the split backward pair (row
12's ``_dq_kernel`` / ``_dkv_kernel``, row 13's ``_flash_dq_kernel`` /
``_flash_dkv_kernel``) run warpgroup kernels on the card
(``csrc/flash_kernels.cuh``: ``flash_fwd_wg_overlap_kernel``,
``flash2_bwd_fused_wg_kernel``, ``flash_bwd_dq_wg_kernel``,
``flash_bwd_dkv_role_wg_kernel``).  They build and run only there;
``chip_smoke.py`` holds them against their plain rules, and these tests
hold those rules against JAX in bf16:

* the forward rule ``short_attention_train_forward_plain`` (p rounded to
  bf16 before P V, the row lse in log2 units; the head-split kernel's ctx
  is flash2's, its lse the same in natural-log units);
* flash2's backward rule ``flash_attention2_backward_plain`` (dS and the
  kept p rounded to bf16, dO folded by 1 / (1 - rate) and rounded), the
  oracle of both of its routes: against the fused kernel and, at rate 0,
  the split pair;
* row 13's backward rule ``flash_attention_backward_plain`` (the kept p
  rounded, dV and dP scaled in f32): at rate 0 against the Pallas pair,
  under dropout against a dense copy of that pair's order
  (:func:`jax_order_head_split_backward`), which is held against the
  Pallas pair at rate 0 too.

At B = 1, 2 heads of 256 (H = 512) and S = 70: two of the kernels' 64-key
tiles, the second ragged, keys padded from 50 on.  At rate 0 JAX's side is
its Pallas kernels in interpret mode (``flash_attention2`` with the fused
backward, ``_flash_attention``), as JAX's own tests run them.  Under
dropout (26/256) the two frameworks draw other masks, so JAX's side is a
dense copy of its kernels' order in jnp on the port's exported mask
(``keep_mask_plain``): the forward's (one key block at S = 70) and row
13's backward's here, the fused backward's
``test_torch_flash2.jax_order_backward``; each copy here is held against
its Pallas kernels at rate 0 too.

Tolerance: ``test_torch_flash2.BF16_TOL`` (2e-3 absolute, 8e-3 relative,
two bf16 ulps), the bound of the existing bf16 rule test: both sides round
p or dS and pd to bf16, and a sum taken in another order can move a
rounded value to its neighbour.  The forward's ctx also gets the gap of
rounding each kept p in another place (:func:`rounding_gap`: the rule
rounds the normalised p / (1 - rate), JAX's kernels the unnormalised p,
before P V; at 26/256 that moved one element of 35,840 2.4e-3 off, past
BF16_TOL alone).  The lse, f32 math on the same bf16 inputs, within 1e-5
(JAX's own f32 forward bound).

A stand-in library that records the C calls shows the d = 192 and 256
fused entry still making two launches (the delta pre-pass and the sweep)
and handing the C entry its delta and f32 dq scratch.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msa_tpu.ops.flash2 as jax_flash2
from msa_tpu.ops import attention as jax_attention
from msa_tpu_torch.ops import attention as A
from msa_tpu_torch.ops import flash2 as F2
from msa_tpu_torch.ops.dropout import keep_mask_plain
from msa_tpu_torch.ops.short_attention import (
    short_attention_train_forward_plain)
from test_torch_flash2 import (BF16_TOL, HEADS, check_fused_entry,
                               jax_order_backward)

torch.set_num_threads(1)

B, S, D = 1, 70, 256
H = HEADS * D
LSE_TOL = 1e-5
RATES = [pytest.param(0.0, id="rate0"), pytest.param(26 / 256, id="rate26")]


def bf16_inputs(seed):
    """q, k, v, dO as JAX bf16 arrays and their bf16 torch twins, [B, S, H];
    the additive key bias [B, S] f32 (keys from 50 on padded)."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal((B, S, H)).astype(np.float32),
                      jnp.bfloat16) for _ in range(4)]
    tx = [torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
          for x in jx]
    mask = np.ones((B, S), np.float32)
    mask[0, 50:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return jx, tx, bias


def heads(x):
    """[B, S, H] -> [B, heads, S, d]."""
    return x.reshape(B, S, HEADS, D).transpose(0, 2, 1, 3)


def jax_order_forward(q, k, v, bias, keep, rate):
    """JAX's flash forward (flash2's ``_fwd_kernel`` and the head-split
    ``_flash_kernel``, one key block) in jnp on [B, heads, S, d] bf16 tiles
    with a given keep mask: base-2 scores, p = exp2(s - m), l the sum of
    the undropped p, the kept p rounded to bf16 times v summed in f32,
    divided by 1 - rate and by l, rounded to bf16; lse = m + log2 l."""
    f32 = jnp.float32
    log2e = 1.0 / np.log(2.0)
    s = jnp.einsum("bnqd,bnkd->bnqk", q, k, preferred_element_type=f32) \
        * (log2e / np.sqrt(D)) + (bias * log2e)[:, None, None, :]
    m = jnp.max(s, -1, keepdims=True)
    p = jnp.exp2(s - m)
    l = jnp.sum(p, -1, keepdims=True)
    if keep is not None:
        p = jnp.where(keep, p, 0.0)
    acc = jnp.einsum("bnqk,bnkd->bnqd", p.astype(v.dtype), v,
                     preferred_element_type=f32)
    if keep is not None:
        acc = acc / (1.0 - rate)
    out = (acc / l).astype(q.dtype)
    return np.asarray(out, np.float32), np.asarray((m + jnp.log2(l))[..., 0])


def port_forward(tx, bias, rate, keep):
    """The forward rule: ctx [B, S, H] (f32 view of the bf16 result) and
    the log2 lse [B, heads, S]."""
    ctx, lse = short_attention_train_forward_plain(
        tx[0], tx[1], tx[2], torch.from_numpy(bias), HEADS, rate, keep)
    assert ctx.dtype == torch.bfloat16
    return ctx, lse


def assert_bf16_close(got, ref, name, gap=0.0):
    """|got - ref| <= BF16_TOL (+ ``gap``, elementwise) everywhere."""
    bound = BF16_TOL[0] + BF16_TOL[1] * np.abs(ref) + gap
    worst = np.argmax(np.abs(got - ref) - bound)
    assert np.all(np.abs(got - ref) <= bound), (
        name, got.flat[worst], ref.flat[worst], bound.flat[worst])


def rounding_gap(tx, bias, rate, keep):
    """2^-8 sum_j p_j |v_j| [B, S, H]: one bf16 rounding (2^-9 relative) of
    every kept p on each side, the rule's of p / (1 - rate) normalised and
    JAX's of the unnormalised p, carried through P V."""
    q, k, v = (x.float().reshape(B, S, HEADS, D) for x in tx[:3])
    p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(D)
                      + torch.from_numpy(bias)[:, None, None, :], dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    return (2.0 ** -8 * torch.einsum("bnqk,bknd->bqnd", p, v.abs())
            ).reshape(B, S, H).numpy()


@pytest.mark.parametrize("layout", ["flash2", "head_split"])
@pytest.mark.parametrize("rate", RATES)
def test_flash_forward_rule_matches_jax_at_d256(layout, rate):
    """The forward rule's ctx and lse against JAX's bf16 forward: at rate 0
    the Pallas kernel (flash2's ``flash_attention2``, or the head-split
    ``_flash_forward_dispatch`` with its natural-log lse) in interpret
    mode, and the dense copy of its order beside it; at 26/256 that copy
    on the exported mask."""
    jx, tx, bias = bf16_inputs(seed=256)
    keep = keep_mask_plain(31, rate, B, HEADS, S) if rate else None
    ctx, lse = port_forward(tx, bias, rate, keep)
    got = ctx.float().numpy()
    gap = rounding_gap(tx, bias, rate, keep)
    copy, copy_lse = jax_order_forward(
        *(heads(x) for x in jx[:3]), jnp.asarray(bias),
        None if keep is None else jnp.asarray(keep.numpy()), rate)
    copy = copy.transpose(0, 2, 1, 3).reshape(B, S, H)
    assert_bf16_close(got, copy, f"{layout} ctx against JAX's order", gap)
    np.testing.assert_allclose(lse.numpy(), copy_lse, atol=LSE_TOL,
                               rtol=LSE_TOL)
    if rate:
        return
    if layout == "flash2":
        ref = jax_flash2.flash_attention2(*jx[:3], jnp.asarray(bias), None,
                                          HEADS, 0.0, True)
        ref = np.asarray(ref, np.float32)
    else:
        bq = min(jax_attention._FLASH_BQ, -(-S // 128) * 128)
        ref, ref_lse = jax_attention._flash_forward_dispatch(
            *(heads(x) for x in jx[:3]), jnp.asarray(bias), None, bq, bq,
            0.0, with_lse=True, interpret=True)
        ref = np.asarray(ref, np.float32).transpose(0, 2, 1, 3).reshape(
            B, S, H)
        np.testing.assert_allclose(lse.numpy() * math.log(2.0),
                                   np.asarray(ref_lse)[:, :, 0, :S],
                                   atol=LSE_TOL, rtol=LSE_TOL)
    assert_bf16_close(got, ref, f"{layout} ctx against the Pallas kernel", gap)
    assert_bf16_close(copy, ref, f"{layout} JAX's order against its kernel")


def flash2_rule_against_vjp(tx, jx, bias, lse):
    """jax.vjp of JAX's bf16 ``flash_attention2`` (its backward route as
    ``_FUSED_BWD`` is set, interpret mode) at rate 0, and the rule in bf16
    and in f32 given JAX's output and ``lse``: (rule, rule in f32, JAX's
    gradients)."""
    tbias = torch.from_numpy(bias)
    jout, vjp = jax.vjp(lambda *x: jax_flash2.flash_attention2(
        *x, jnp.asarray(bias), None, HEADS, 0.0, True), *jx[:3])
    ref = [np.asarray(g, np.float32) for g in vjp(jx[3])]
    out = torch.from_numpy(np.array(jout, np.float32)).to(torch.bfloat16)
    got = F2.flash_attention2_backward_plain(*tx[:3], tbias, out, lse, tx[3],
                                             HEADS)
    wide = F2.flash_attention2_backward_plain(
        *(x.float() for x in tx[:3]), tbias, out, lse, tx[3].float(), HEADS)
    return got, wide, ref


def assert_rule_nearer(got, wide, ref):
    """Each bf16 gradient of the rule within BF16_TOL of JAX's, and nearer
    to it than the rule without its roundings."""
    for name, g, w, r in zip(("dq", "dk", "dv"), got, wide, ref):
        assert g.dtype == torch.bfloat16, name
        assert_bf16_close(g.float().numpy(), r, name)
        err = np.abs(g.float().numpy() - r).max()
        err_wide = np.abs(w.to(torch.bfloat16).float().numpy() - r).max()
        assert err < err_wide, (name, err, err_wide)


@pytest.mark.parametrize("rate", RATES)
def test_flash2_fused_rule_matches_jax_at_d256(rate, monkeypatch):
    """flash_attention2_backward_plain in bf16, given JAX's output and the
    row lse, against JAX's fused backward: at rate 0 jax.vjp of
    ``flash_attention2`` through ``_bwd_fused_kernel`` (interpret mode),
    where the rule also lies nearer to JAX's gradients than the same rule
    without its roundings; at 26/256 its dense order on the exported mask
    (the rule's forward output and lse for both)."""
    monkeypatch.setattr(jax_flash2, "_FUSED_BWD", True)
    jx, tx, bias = bf16_inputs(seed=257)
    keep = keep_mask_plain(37, rate, B, HEADS, S) if rate else None
    ctx, lse = port_forward(tx, bias, rate, keep)
    if not rate:
        assert_rule_nearer(*flash2_rule_against_vjp(tx, jx, bias, lse))
        return
    out = ctx.float()
    ref = jax_order_backward(
        *jx[:3], jnp.asarray(bias), jnp.asarray(out.numpy()),
        jnp.asarray(lse.numpy()), jx[3], jnp.asarray(keep.numpy()), rate,
        weak=True)
    got = F2.flash_attention2_backward_plain(*tx[:3], torch.from_numpy(bias),
                                             out, lse, tx[3], HEADS, rate,
                                             keep)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16, name
        assert_bf16_close(g.float().numpy(), r, name)


def test_flash2_split_rule_matches_jax_at_d256(monkeypatch):
    """flash_attention2_backward_plain in bf16 (the oracle of the split
    pair too), given JAX's output and the row lse, against jax.vjp of
    ``flash_attention2`` through JAX's split pair (``_FUSED_BWD = False``:
    ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode) at rate 0; the
    rule also lies nearer to JAX's gradients than the same rule without
    its roundings."""
    monkeypatch.setattr(jax_flash2, "_FUSED_BWD", False)
    jx, tx, bias = bf16_inputs(seed=259)
    _, lse = port_forward(tx, bias, 0.0, None)
    assert_rule_nearer(*flash2_rule_against_vjp(tx, jx, bias, lse))


def jax_order_head_split_backward(q, k, v, bias, out, lse, dout, keep, rate):
    """JAX's ``_flash_dq_kernel`` and ``_flash_dkv_kernel``
    (msa_tpu/ops/attention.py:171, :211) in jnp on dense [B, heads, S, S]
    tiles of [B, heads, S, d] bf16 inputs with a given keep mask (None at
    rate 0): p = exp(s - lse) from the natural-log lse, delta = rowsum(dO
    o) in f32; the dq kernel's dpm the kept dP divided by 1 - rate, the
    dk/dv kernel's times 1 / (1 - rate) (:237-245); dS = p (dpm - delta)
    rounded to bf16; dV the kept p rounded, times dO, its f32 sum times 1 /
    (1 - rate).  Returns dq, dk, dv as f32 numpy arrays of bf16 values."""
    f32 = jnp.float32
    scale = 1.0 / np.sqrt(D)
    s = jnp.einsum("bnqd,bnkd->bnqk", q, k, preferred_element_type=f32) \
        * scale + bias[:, None, None, :]
    p = jnp.exp(s - lse[..., None])
    delta = jnp.sum(dout.astype(f32) * out.astype(f32), -1, keepdims=True)
    dp = jnp.einsum("bnqd,bnkd->bnqk", dout, v, preferred_element_type=f32)
    pd, dp_q, dp_k, dv_mult = p, dp, dp, 1.0
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        pd = jnp.where(keep, p, 0.0)
        dp_q = jnp.where(keep, dp, 0.0) / (1.0 - rate)
        dp_k = jnp.where(keep, dp, 0.0) * inv
        dv_mult = inv
    dq = jnp.einsum("bnqk,bnkd->bnqd", (p * (dp_q - delta)).astype(q.dtype),
                    k, preferred_element_type=f32) * scale
    dk = jnp.einsum("bnqk,bnqd->bnkd", (p * (dp_k - delta)).astype(q.dtype),
                    q, preferred_element_type=f32) * scale
    dv = jnp.einsum("bnqk,bnqd->bnkd", pd.astype(dout.dtype), dout,
                    preferred_element_type=f32) * dv_mult
    return [np.asarray(x.astype(q.dtype), np.float32) for x in (dq, dk, dv)]


def test_flash_attention_backward_rule_matches_jax_at_d256():
    """Row 13's backward rule (``flash_attention_backward_plain``, the
    oracle of its split pair) in bf16, given JAX's output and natural-log
    lse, against jax.vjp of ``_flash_attention`` (its dq and dk/dv kernels
    in interpret mode) at rate 0; and :func:`jax_order_head_split_backward`
    against the same kernels."""
    jx, _, bias = bf16_inputs(seed=258)
    hx = [heads(x) for x in jx]
    bq = min(jax_attention._FLASH_BQ, -(-S // 128) * 128)
    jout, jlse = jax_attention._flash_forward_dispatch(
        *hx[:3], jnp.asarray(bias), None, bq, bq, 0.0, with_lse=True,
        interpret=True)
    _, vjp = jax.vjp(lambda *x: jax_attention._flash_attention(
        *x, jnp.asarray(bias), None, bq, bq, 0.0, True), *hx[:3])
    ref = [np.asarray(g, np.float32) for g in vjp(hx[3])]
    tq, tk, tv, tdo, tout = (
        torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
        for x in (*hx, jout))
    lse = torch.from_numpy(np.array(jlse, np.float32)[:, :, 0, :S])
    got = A.flash_attention_backward_plain(tq, tk, tv, torch.from_numpy(bias),
                                           tout, lse, tdo)
    copy = jax_order_head_split_backward(
        *hx[:3], jnp.asarray(bias), jout, jnp.asarray(lse.numpy()), hx[3],
        None, 0.0)
    for name, g, c, r in zip(("dq", "dk", "dv"), got, copy, ref):
        assert g.dtype == torch.bfloat16, name
        assert_bf16_close(g.float().numpy(), r, name)
        assert_bf16_close(c, r, f"{name}: JAX's order against its kernels")


def test_flash_attention_backward_rule_dropout_order_at_d256():
    """Row 13's backward rule in bf16 at rate 26/256 against
    :func:`jax_order_head_split_backward` on the same exported keep mask,
    both given the rule's forward output (bf16) and natural-log lse."""
    rate = 26 / 256
    jx, tx, bias = bf16_inputs(seed=260)
    keep = keep_mask_plain(41, rate, B, HEADS, S)
    tq, tk, tv, tdo = (x.reshape(B, S, HEADS, D).transpose(1, 2)
                       for x in tx)
    tbias = torch.from_numpy(bias)
    out, lse = A.flash_attention_plain(
        *(x.float() for x in (tq, tk, tv)), tbias, rate, keep, with_lse=True)
    out = out.to(torch.bfloat16)
    got = A.flash_attention_backward_plain(tq, tk, tv, tbias, out, lse, tdo,
                                           rate, keep)
    ref = jax_order_head_split_backward(
        *(heads(x) for x in jx[:3]), jnp.asarray(bias),
        jnp.asarray(out.float().numpy(), jnp.bfloat16),
        jnp.asarray(lse.numpy()), heads(jx[3]), jnp.asarray(keep.numpy()),
        rate)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16, name
        assert_bf16_close(g.float().numpy(), r, name)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_fused_entry_hands_the_sweep_its_scratch(d, monkeypatch):
    """The fused entry at d = 192 and 256 (the library of 256; f32 there
    runs the short kernels, bf16 this route), by
    :func:`test_torch_flash2.check_fused_entry`: one call of the C entry of
    ``flash2_d256`` with the delta and f32 dq scratch in ``_SIGNATURES``
    order, counted as two launches."""
    check_fused_entry(d, monkeypatch)
