"""msa_tpu_torch's training ops on the CPU: gradients and dropout rules
against the JAX package.

On the CPU each wrapper runs its plain PyTorch version under autograd (the
CUDA kernels run only on a card; chip_smoke.py holds them against these
plain versions there).  The JAX side runs its Pallas kernels in interpret
mode, as the JAX package's own tests do.  Inputs come from numpy seeds.

Tolerances:
  * f32 gradients: atol = rtol = 2e-5 -- the same math, summed in another
    order (the JAX kernel in base-2 softmax blocks, the port in einsums);
  * keep shares: 4 binomial standard deviations;
  * rescale factors and masks: exact.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.models import bert as jax_bert
from msa_tpu.ops import masking as jax_masking
from msa_tpu.ops.fused_joint_embed import fused_joint_embed as jax_joint_embed
from msa_tpu.ops.short_attention import (
    _byte_threshold as jax_byte_threshold,
    quantize_dropout_rate as jax_quantize,
    short_attention_v2,
)
from msa_tpu_torch.ops import dropout as D
from msa_tpu_torch.ops import fused_joint_embed as fje
from msa_tpu_torch.ops import masking
from msa_tpu_torch.ops.attention import multi_head_attention
from msa_tpu_torch.ops.short_attention import (
    dropout_keep_mask, short_attention, short_attention_plain)

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

GRAD_TOL = 2e-5
SIGMAS = 4.0


def attention_inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, s, h)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0
    mask[1, 3:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, dout, bias


@pytest.mark.parametrize("s", [12, 40])
def test_short_attention_plain_grads_match_jax_kernel(s):
    """dq, dk, dv of the plain attention (the backward kernel's oracle)
    against jax.grad through short_attention_v2 (its Pallas _bwd_kernel_v2
    in interpret mode), dropout 0, two heads of 64."""
    q, k, v, dout, bias = attention_inputs(3, s, 128, seed=s)

    def jax_loss(q, k, v):
        out = short_attention_v2(q, k, v, jnp.asarray(bias), None, 2, 0.0, True)
        return jnp.sum(out * jnp.asarray(dout))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qq, kk, vv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = short_attention(qq, kk, vv, torch.from_numpy(bias), 2)
    got = torch.autograd.grad(out, (qq, kk, vv), torch.from_numpy(dout))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("d", [47, 74])
def test_fused_joint_embed_grads_match_jax(d):
    """Gradients of the joint embed (the plain version under autograd on
    the CPU) against JAX's custom VJP (the VJP of _ref_forward)."""
    rng = np.random.default_rng(d)
    b, l, h = 2, 8, 128
    feats = rng.standard_normal((b, l, d)).astype(np.float32)
    feats[1, 5:] = 0.0
    args = [rng.standard_normal((b, l, h)).astype(np.float32), feats,
            (rng.standard_normal((d, h)) * 0.05).astype(np.float32),
            (rng.standard_normal(h) * 0.01).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32),
            (0.1 * rng.standard_normal(h)).astype(np.float32)]
    g = rng.standard_normal((b, 2 * l, h)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jax_joint_embed(*a, 1e-12, True) * g),
                   argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fje.fused_joint_embed(*ts, 1e-12)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, r in zip(("text", "feats", "w", "b", "scale", "bias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_fused_joint_embed_autograd_function_recomputes_plain(monkeypatch):
    """The CUDA autograd wrapper's backward (a recompute through the plain
    version), run on the CPU with the plain forward standing in for the
    kernel: its gradients equal plain autograd's, feats included or not."""
    monkeypatch.setattr(fje, "_kernel", fje.fused_joint_embed_plain)
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((2, 6, 128), (2, 6, 47), (47, 128), (128,), (128,), (128,))]
    g = torch.from_numpy(rng.standard_normal((2, 12, 128)).astype(np.float32))
    for feats_grad in (True, False):
        ts = [torch.tensor(a, requires_grad=(i != 1 or feats_grad))
              for i, a in enumerate(args)]
        wanted = [t for t in ts if t.requires_grad]
        out = fje._FusedJointEmbed.apply(*ts, 1e-12)
        got = torch.autograd.grad(out, wanted, g)
        ref = torch.autograd.grad(fje.fused_joint_embed_plain(*ts, 1e-12),
                                  wanted, g)
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, atol=0, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.05, 0.1, 0.1015625, 0.3, 0.5,
                                  0.9, 0.999, 1.0, -0.2])
def test_quantize_dropout_rate_matches_jax(rate):
    q = D.quantize_dropout_rate(rate)
    assert q == jax_quantize(rate)
    if q > 0:
        assert D.byte_threshold(q) == jax_byte_threshold(q)


def test_byte_threshold_refuses_unsnapped_rates():
    assert D.byte_threshold(0.0) == 0
    with pytest.raises(ValueError, match="1/256"):
        D.byte_threshold(0.1)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Philox4x32-10 against the known-answer vectors of Salmon et al.'s
    Random123 distribution (counters (c0, c1, c2, c3), key (k0, k1))."""
    got = D.philox4x32_10(*(torch.tensor([c]) for c in counter), *key)
    assert tuple(int(x) for x in got) == want


def test_keep_mask_is_a_function_of_index_and_seed():
    """Each decision follows from (seed, b, head, i, j) alone: rebuilt from
    one Philox draw per element, it matches the vectorised mask; the keep
    share is 1 - t/256; another seed gives another mask."""
    rate = D.quantize_dropout_rate(0.1)
    t = D.byte_threshold(rate)
    b, nh, s, seed = 2, 3, 40, (123 << 32) + 456
    keep = D.keep_mask_plain(seed, rate, b, nh, s)
    rng = np.random.default_rng(0)
    for _ in range(50):
        bi, hi, i, j = (int(rng.integers(n)) for n in (b, nh, s, s))
        row = (bi * nh + hi) * s + i
        words = D.philox4x32_10(torch.tensor([j // 16]), torch.tensor([row]),
                                torch.tensor([0]), torch.tensor([0]),
                                seed & 0xFFFFFFFF, seed >> 32)
        byte = (int(words[(j % 16) // 4]) >> (8 * (j % 4))) & 0xFF
        assert bool(keep[bi, hi, i, j]) == (byte >= t)
    p = 1 - t / 256
    share = float(keep.float().mean())
    assert abs(share - p) <= SIGMAS * math.sqrt(p * (1 - p) / keep.numel())
    assert not torch.equal(keep, D.keep_mask_plain(seed + 1, rate, b, nh, s))
    # the export entry is a kernel only: off the card it refuses
    with pytest.raises(ValueError, match="keep_mask_plain"):
        dropout_keep_mask(seed, rate, b, nh, s, "cpu")


def test_short_attention_cpu_dropout_uses_the_kernel_mask():
    """The kernels' dropout on the CPU is short_attention_plain given
    keep_mask_plain (the oracle the card's kernels are held against): the
    dropped probabilities are zero and the kept ones scaled by 1/(1-rate).
    short_attention itself on CPU tensors is the plain version at rate 0
    and refuses a rate: dropout off the card is multi_head_attention's."""
    q, k, v, _, bias = attention_inputs(2, 24, 128, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    rate = D.quantize_dropout_rate(0.2)
    keep = D.keep_mask_plain(99, rate, 2, 2, 24)
    out = short_attention_plain(*t, 2, rate, keep)
    # ones in v: each output dim is the row's kept probability mass / (1-rate)
    ones = torch.ones_like(t[2])
    mass = short_attention_plain(t[0], t[1], ones, t[3], 2, rate, keep)
    probs = torch.softmax(torch.einsum(
        "bqnd,bknd->bnqk", t[0].view(2, 24, 2, 64), t[1].view(2, 24, 2, 64))
        / 8.0 + t[3][:, None, None, :], -1)
    want = (probs * keep).sum(-1) / (1 - rate)  # [b, head, q]
    torch.testing.assert_close(mass[..., ::64].permute(0, 2, 1), want,
                               atol=1e-6, rtol=1e-6)
    assert not torch.equal(out, short_attention_plain(*t, 2))
    torch.testing.assert_close(short_attention(*t, 2),
                               short_attention_plain(*t, 2), atol=0, rtol=0)
    with pytest.raises(ValueError, match="keep mask"):
        short_attention(*t, 2, rate, 99)
    with pytest.raises(ValueError, match="seed"):
        short_attention(*t, 2, rate)


def test_multi_head_attention_cpu_dropout_is_bernoulli_at_the_raw_rate():
    """Off the card, attention dropout is a bernoulli mask at the unsnapped
    rate (JAX's _xla_attention): ones in v make each output dim the row's
    kept probability mass, so kept-probs / (1 - rate) shows through."""
    b, s, h, rate = 2, 40, 128, 0.1
    bias = torch.zeros(b, 1, 1, s)
    q = k = torch.zeros(b, s, h)  # uniform probabilities 1/s
    v = torch.ones(b, s, h)
    out = multi_head_attention(q, k, v, bias, num_heads=2, dropout_rate=rate,
                               seed=5, deterministic=False)
    kept = out[..., 0] * s * (1 - rate)  # per (b, i): keys kept of head 0
    assert torch.allclose(kept, kept.round(), atol=1e-4)
    share = float(kept.sum()) / (b * s * s)
    p = 1 - rate
    assert abs(share - p) <= SIGMAS * math.sqrt(p * (1 - p) / (b * s * s))
    same = multi_head_attention(q, k, v, bias, num_heads=2, dropout_rate=rate,
                                seed=5, deterministic=False)
    assert torch.equal(out, same)
    off = multi_head_attention(q, k, v, bias, num_heads=2, dropout_rate=rate,
                               seed=5, deterministic=True)
    torch.testing.assert_close(off, torch.ones_like(off))


@pytest.mark.parametrize("s", [40, 256])
def test_hidden_dropout_keep_share_and_rescale_match_jax(s):
    """S=40: the bernoulli path at the raw rate; S=256: the uint8-threshold
    path at the snapped rate.  Both keep share and the kept value (the
    rescale) agree with JAX's _dropout; the draw comes from the generator."""
    rate = 0.1
    shape = (4, s, 64)
    x = torch.ones(shape)
    y = D.dropout(x, rate, torch.Generator().manual_seed(0))
    ref = np.asarray(jax_bert._dropout(jax.random.key(0), jnp.ones(shape), rate,
                                       deterministic=False))
    kept, ref_kept = y[y != 0].unique(), np.unique(ref[ref != 0])
    assert kept.numel() == 1 and ref_kept.size == 1
    assert float(kept[0]) == pytest.approx(float(ref_kept[0]), rel=1e-6)
    if s >= D.BITS_DROPOUT_MIN_SEQ:
        p = 1 - D.byte_threshold(D.quantize_dropout_rate(rate)) / 256
        assert float(kept[0]) == pytest.approx(1 / p, rel=1e-6)
    else:
        p = 1 - rate
    n = y.numel()
    for share in (float((y != 0).float().mean()), float((ref != 0).mean())):
        assert abs(share - p) <= SIGMAS * math.sqrt(p * (1 - p) / n)
    same = D.dropout(x, rate, torch.Generator().manual_seed(0))
    other = D.dropout(x, rate, torch.Generator().manual_seed(1))
    assert torch.equal(y, same) and not torch.equal(y, other)
    assert D.dropout(x, 0.0, torch.Generator()) is x


def test_mask_tokens_semantics_and_injected_masks_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 200, size=(6, 30)).astype(np.int64)
    ids[:, 0], ids[:, -1], ids[0, 10:] = 101, 102, 0
    new, labels = masking.mask_tokens(torch.Generator().manual_seed(0),
                                      torch.from_numpy(ids), 0.3)
    special = np.isin(ids, masking.DEFAULT_SPECIAL_IDS)
    masked = labels.numpy() != masking.IGNORE_INDEX
    assert not (masked & special).any() and masked.any()
    np.testing.assert_array_equal(labels.numpy()[masked], ids[masked])
    changed = new.numpy() != ids
    assert (new.numpy()[changed] == masking.DEFAULT_MASK_ID).all()
    assert not (changed & ~masked).any()

    m = (rng.random(ids.shape) < 0.2) & ~special
    r = rng.random(ids.shape) < 0.8
    got = masking.apply_mlm_masks(torch.from_numpy(ids), torch.from_numpy(m),
                                  torch.from_numpy(r))
    ref = jax_masking.apply_mlm_masks(jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(m), jnp.asarray(r))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_c_entry_points_match_their_ctypes_signatures():
    """Every entry a wrapper binds exists in its CUDA source with as many
    parameters as the wrapper's ctypes signature passes (a mismatch would
    pass garbage on the card, where the CPU tests cannot look)."""
    import re

    from msa_tpu_torch import _build
    from msa_tpu_torch.ops import attention as attn
    from msa_tpu_torch.ops import flash2 as f2
    from msa_tpu_torch.ops import fused_adamw as fa
    from msa_tpu_torch.ops import ln_quant as lnq
    from msa_tpu_torch.ops import short_attention as sa

    bound = {"short_attention": sa._SIGNATURES,
             "fused_joint_embed": fje._SIGNATURES,
             "ln_quant": lnq._SIGNATURES,
             "flash2": f2._SIGNATURES,
             "fused_adamw": fa._SIGNATURES,
             "flash_attention": attn._SIGNATURES,
             "short_attention_v1": sa._V1_SIGNATURES}
    assert "msa_short_attention_v3_bwd" in sa._SIGNATURES
    assert set(bound) == set(_build.KERNELS)
    for name, signatures in bound.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        for entry, argtypes in signatures.items():
            m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
            assert m, f"{entry} not in {name}.cu"
            assert len(m.group(1).split(",")) == len(argtypes), entry
