"""Attention dropout at any rate in [0, 1): the port's word rule beside its
byte rule, on the CPU.

JAX's kernels draw at any rate (``msa_tpu/ops/short_attention.py::
_keep_mask``): four decisions from each 32-bit draw at a rate on the t/256
grid, one decision a draw, keep iff bits >= min(floor(rate * 2**32), 2**32
- 1), at any other.  The port's kernels take both rules
(``ops/dropout.py``, ``csrc/dropout.cuh``): Philox4x32-10 of the seed at
counter (j // 16, row, 0, 0) for the byte rule, (j // 4, row, 1, 0) for
the word rule.  The TPU's PRNG cannot be reproduced, so these tests hold:

* the rule each rate takes, against JAX's ``_byte_threshold``, and the
  word rule's threshold;
* the word rule's keep share at rates 0.1 and 0.3 within 5 sigma over
  more than 10**6 decisions (a binomial draw);
* each decision a function of (seed, rate, element index) alone, so the
  forward and every backward launch draw the same mask: rebuilt element by
  element from one Philox draw each, and a smaller batch's mask the
  leading rows of a larger one's;
* the byte rule's masks bit-equal to the parent tree's (SHA-256 of the
  masks it drew);
* every kernel entry hands a rate off the grid to its C entry (a stand-in
  for the CUDA library records the arguments) and refuses a rate outside
  [0, 1);
* tests/test_dropout_bits.py's checks, mirrored for the attention mask:
  the keep rate and the unbiased rescale, the gradient a scaled mask, the
  mask fixed by its seed and all-keep at rate 0.
"""

import hashlib

import numpy as np
import pytest
import torch

from msa_tpu.ops.short_attention import _byte_threshold as jax_byte_threshold
from msa_tpu_torch import _build
from msa_tpu_torch.ops import attention as attn
from msa_tpu_torch.ops import dropout as D
from msa_tpu_torch.ops import flash2 as F2
from msa_tpu_torch.ops import short_attention as sa

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

SEED = (123 << 32) + 456
OFF_GRID = (0.1, 0.3)
SIGMAS = 5.0


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3, 26 / 256, 0.5, 1 / 256,
                                  255 / 256, 0.123456, 1e-9, 0.999999])
def test_rule_of_a_rate_is_jax_s(rate):
    """The byte rule exactly where JAX's _byte_threshold gives a t; the
    word rule's threshold elsewhere."""
    grid = jax_byte_threshold(rate) is not None
    assert D.on_grid(rate) == (rate == 0.0 or grid)
    if rate > 0.0 and not grid:
        assert D.word_threshold(rate) == min(int(rate * 2 ** 32), 2 ** 32 - 1)
    elif rate > 0.0:
        assert D.byte_threshold(rate) == jax_byte_threshold(rate)


@pytest.mark.parametrize("rate", [1.0, 1.5, -0.1, float("nan")])
def test_rates_outside_the_unit_interval_raise(rate):
    with pytest.raises(ValueError, match=r"outside \[0, 1\)"):
        D.check_rate(rate)
    with pytest.raises(ValueError, match=r"outside \[0, 1\)"):
        D.keep_mask_plain(SEED, rate, 1, 1, 8)


@pytest.mark.parametrize("rate", OFF_GRID)
def test_word_rule_keep_share(rate):
    """Over 4 x 512 x 512 = 1.05M decisions the keep share lies within 5
    sigma of 1 - rate."""
    keep = D.keep_mask_plain(SEED, rate, 1, 4, 512)
    n = keep.numel()
    assert n > 10 ** 6
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) < SIGMAS * sigma


def _philox_words(c0, c1, c2):
    out = D.philox4x32_10(*(torch.tensor([c]) for c in (c0, c1, c2, 0)),
                          SEED, SEED >> 32)
    return [int(x) for x in out]


@pytest.mark.parametrize("rate", OFF_GRID)
def test_word_rule_is_a_function_of_index_and_seed(rate):
    """Each decision rebuilt from its own draw (counter (j // 4, row, 1, 0),
    word j % 4) matches the vectorised mask; a smaller batch's mask is the
    leading rows of a larger one's, as every launch computes it."""
    b, nh, s = 2, 3, 37
    keep = D.keep_mask_plain(SEED, rate, b, nh, s)
    rng = np.random.default_rng(0)
    threshold = D.word_threshold(rate)
    for _ in range(40):
        bi, h, i, j = (int(rng.integers(n)) for n in (b, nh, s, s))
        row = (bi * nh + h) * s + i
        word = _philox_words(j // 4, row, 1)[j % 4]
        assert bool(keep[bi, h, i, j]) == (word >= threshold)
    assert torch.equal(D.keep_mask_plain(SEED, rate, 1, nh, s), keep[:1])
    # the byte rule's draws for the same index are another stream
    byte = D.keep_mask_plain(SEED, 26 / 256, b, nh, s)
    assert not torch.equal(byte, keep)


@pytest.mark.parametrize("rate, shape, digest", [
    (26 / 256, (2, 3, 40),
     "7bcd8010427732aa99506824c8ca5a4e007e56baa3f4fd62a3d2ae4f11d69771"),
    (26 / 256, (1, 2, 130),
     "3af584e0f5484370ef47d9f6bbd975203dabfa10f7e0228c362d86bfa6d866c4"),
    (1 / 256, (2, 3, 40),
     "40afc2a52a0bfca3ce3857a5d4b8bb2fc834b09b38cb08c9666ac3a61746faef"),
    (255 / 256, (1, 2, 130),
     "a1fedb2687ca5d714ae094702b9f20d08af2eca1b001d84e0259af34ae341cbd"),
    (0.5, (2, 3, 40),
     "f3ebf82e94be42cc21a7cdb3d80f3e9c8416bed97b4030425db184e90cfc2a20")])
def test_byte_rule_masks_are_unchanged(rate, shape, digest):
    """The byte rule draws the masks it drew before the word rule existed
    (digests of the earlier tree's keep_mask_plain at this seed)."""
    keep = D.keep_mask_plain(SEED, rate, *shape)
    assert hashlib.sha256(keep.numpy().tobytes()).hexdigest() == digest


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_attention_dropout_keep_rate_and_unbiased(rate):
    """test_dropout_bits.py's first check for the attention mask: with q =
    k = 0 every probability is 1/S, so each ctx element of v = 1 is the row's
    kept share times 1 / (1 - rate): its mean over the rows is 1 within the
    binomial noise, and the kept share is 1 - rate."""
    b, nh, s, d = 1, 4, 256, 4
    keep = D.keep_mask_plain(SEED, rate, b, nh, s)
    q = torch.zeros(b, s, nh * d)
    out = sa.short_attention_plain(q, q, torch.ones(b, s, nh * d),
                                   torch.zeros(b, s), nh, rate, keep)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert keep.float().mean().item() == pytest.approx(1 - rate,
                                                       abs=SIGMAS * sigma)
    assert out.mean().item() == pytest.approx(1.0, abs=SIGMAS * sigma / (1 - rate))


def test_attention_dropout_grad_is_scaled_mask():
    """The gradient of sum(ctx) with respect to v_j at uniform
    probabilities is sum_i keep_ij / (S (1 - rate)): the scaled mask."""
    rate, b, nh, s, d = 0.1, 1, 2, 64, 4
    keep = D.keep_mask_plain(SEED, rate, b, nh, s)
    q = torch.zeros(b, s, nh * d)
    v = torch.randn(b, s, nh * d, requires_grad=True)
    out = sa.short_attention_plain(q, q, v, torch.zeros(b, s), nh, rate, keep)
    (g,) = torch.autograd.grad(out.sum(), v)
    want = keep.float().sum(2) / (s * (1 - rate))          # [b, nh, s_j]
    want = want.transpose(1, 2)[..., None].expand(b, s, nh, d).reshape(g.shape)
    torch.testing.assert_close(g, want, atol=1e-6, rtol=1e-6)


def test_attention_dropout_fixed_by_seed_and_identity_at_zero():
    a = D.keep_mask_plain(SEED, 0.1, 2, 2, 50)
    assert torch.equal(a, D.keep_mask_plain(SEED, 0.1, 2, 2, 50))
    assert not torch.equal(a, D.keep_mask_plain(SEED + 1, 0.1, 2, 2, 50))
    assert D.keep_mask_plain(SEED, 0.0, 2, 2, 50).all()


class Recorder:
    """A CUDA library's stand-in: every C entry records its arguments and
    returns 0 (no output is computed)."""

    def __init__(self):
        self.calls = []

    def load(self, name, signatures):
        return self

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    lib = Recorder()
    monkeypatch.setattr(_build, "load", lib.load)
    for mod in (sa, F2):
        monkeypatch.setattr(mod, "_check", lambda *a, **k: None)
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
    monkeypatch.setattr(attn, "_stream", lambda x: 0)
    monkeypatch.setattr(attn, "_check_heads", lambda *a: None)
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_kernel_entry_takes_a_rate_off_the_grid(recorder, dtype):
    """Each forward and backward entry hands 0.1 (the word rule) to its C
    entry as the rate, the last argument before the stream, at head dims on
    both sides of the tensor-core templates (64 and 192)."""
    rate = 0.1
    for d in (64, 192):
        b, s, nh = 2, 24, 2
        q = torch.zeros(b, s, nh * d, dtype=dtype)
        qh = torch.zeros(b, nh, s, d, dtype=dtype)
        bias = torch.zeros(b, s)
        lse = torch.zeros(b, nh, s)
        f32 = torch.zeros(b, s, nh * d)
        probs = torch.zeros(b, nh, s, sa.probs_width(s), dtype=dtype)
        recorder.calls.clear()
        sa._forward_kernel(q, q, q, bias, nh, 7, rate, True)
        sa.short_attention_backward(q, q, q, bias, lse, q, nh, 7, rate)
        sa.short_attention_v3_backward(q, q, q, bias, q, q, nh, 7, rate)
        sa._packed_forward_kernel(torch.cat([q] * 3, -1), bias, nh, 7, rate,
                                  False)
        sa.short_attention_packed_backward(torch.cat([q] * 3, -1), bias, q, q,
                                           nh, 7, rate)
        sa._probs_forward_kernel(q, q, q, bias, nh, 7, rate)
        sa.short_attention_probs_backward(q, q, q, probs, q, nh, rate)
        sa._v1_forward_kernel(q, q, q, bias, nh, 7, rate)
        sa.short_attention_v1_backward(q, q, q, bias, q, nh, 7, rate)
        F2._forward_kernel(q, q, q, bias, nh, 7, rate, True)
        for fused in (True, False):
            F2.flash_attention2_backward(q, q, q, bias, f32, lse, q, nh, 7,
                                         rate, fused=fused)
        out, hlse = attn._forward_kernel(qh, qh, qh, bias, 7, rate, True)
        attn.flash_attention_backward(qh, qh, qh, bias, qh, lse, qh, 7, rate)
        assert len(recorder.calls) >= 14, [c[0] for c in recorder.calls]
        for entry, args in recorder.calls:
            assert args[-2] == rate, (d, entry)


def test_entries_refuse_rates_outside_the_unit_interval(recorder):
    q = torch.zeros(1, 8, 64)
    bias = torch.zeros(1, 8)
    lse = torch.zeros(1, 1, 8)
    for call in (
            lambda: sa._forward_kernel(q, q, q, bias, 1, 7, 1.0, False),
            lambda: sa.short_attention_backward(q, q, q, bias, lse, q, 1, 7,
                                                1.0),
            lambda: F2._forward_kernel(q, q, q, bias, 1, 7, -0.5, False)):
        with pytest.raises(ValueError, match=r"outside \[0, 1\)"):
            call()
    assert not recorder.calls
