"""The widths the port's CUDA kernels take, and the v2s backward's launches.

The kernels build and run only on a card (chip_smoke.py holds them against
their plain versions there, at head dims 8, 16, 26, 32, 64 and 128); these
tests hold the Python side of the contract on the CPU:

* every attention entry takes any integer head dim from 1 to 256 and
  raises for any other, naming the limit; each attention source is built
  once a head dim of ``HEAD_DIMS`` (16, 32, 64, 128, 256: the
  instantiations of ``csrc/mma_tiles.cuh::by_head_dim``; v1's whole-row
  source up to 128, above which v1 runs on the v2 kernels), and a head dim
  between runs on the next one up;
* the wrappers of a head dim off the instantiations (8, 26, 100) pad each
  head with zero columns to the instantiated width and cut the outputs
  back, through a stand-in for the CUDA library that computes attention on
  the tensors it is handed: the library of the right head dim is loaded,
  the C entry sees hidden = heads x the instantiated width and the softmax
  scale of the true head dim, and the cut outputs equal the plain version
  at the true head dim (f32, 1e-5: the same math on zero-padded operands);
* ln_quant takes any H: the lane-team forms for a multiple of 64 up to 512,
  of 128 up to 1024 or of 256 up to 2048 (``supported_hidden``, the
  (lanes, chunks) pairs ``csrc/ln_quant.cu`` instantiates), the generic
  form (a warp or a CTA a row) for every other width;
* ``short_attention_probs_backward`` counts one launch on the whole-row
  tensor-core route (bf16, S <= 128), where it hands the C entry no delta
  scratch, and two elsewhere (bf16 above 128 keys on the tiled tensor-core
  pair, counted on its route's counter too; f32 on the CUDA-core pair),
  with a stand-in for the CUDA library.
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from msa_tpu_torch import _build
from msa_tpu_torch.ops import attention as attn
from msa_tpu_torch.ops import short_attention as sa
from msa_tpu_torch.ops.ln_quant import supported_hidden

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)


@pytest.mark.parametrize("d, ok", [(32, True), (64, True), (16, True),
                                   (48, True), (128, True), (1, True),
                                   (64.5, False), (136, True), (256, True),
                                   (257, False), (0, False)])
def test_head_dim_acceptance(d, ok):
    if ok:
        sa.check_head_dim(d, "entry")
    else:
        with pytest.raises(ValueError, match="integer head dim from 1 to 256"):
            sa.check_head_dim(d, "entry")


def test_head_dims_are_the_instantiated_ones():
    """HEAD_DIMS is the set by_head_dim dispatches on when a source is
    built for every head dim, the build makes one library a head dim of
    each attention source (-DMSA_HEAD_DIM), every attention source
    dispatches through by_head_dim, and a head dim runs on the smallest
    instantiation at or above it."""
    text = (_build.CSRC / "mma_tiles.cuh").read_text()
    dims = tuple(int(d) for d in re.findall(
        r"if \(d == (\d+)\) return f\(std::integral_constant", text))
    assert dims == sa.HEAD_DIMS == _build.HEAD_DIMS == (16, 32, 64, 128, 256)
    assert "MSA_HEAD_DIM" in text
    libraries = _build.libraries()
    assert len(libraries) == 3 * 5 + 4 + 3  # v1 up to 128, three others
    for name in ("short_attention", "short_attention_v1", "flash2",
                 "flash_attention"):
        assert "by_head_dim(" in (_build.CSRC / f"{name}.cu").read_text(), name
        dims = _build.source_head_dims(name)
        assert dims == (sa.HEAD_DIMS[:4] if name == "short_attention_v1"
                        else sa.HEAD_DIMS), name
        for d in dims:
            lib = _build.head_dim_library(name, d)
            assert lib in libraries
            assert f"-DMSA_HEAD_DIM={d}" in _build._flags(lib)
            assert _build._source(lib) == _build.CSRC / f"{name}.cu"
    with pytest.raises(ValueError, match="no library"):
        _build.head_dim_library("short_attention_v1", 256)
    assert sa.V1_MAX_HEAD_DIM == 128
    assert [sa.kernel_head_dim(d) for d in (1, 8, 16, 17, 26, 32, 33, 64, 65,
                                            100, 128, 129, 192, 256)] == [
        16, 16, 16, 32, 32, 32, 64, 64, 128, 128, 128, 256, 256, 256]


def ln_quant_instantiations():
    text = (_build.CSRC / "ln_quant.cu").read_text()
    return {(int(a), int(b)) for a, b in re.findall(
        r"MSA_LN_QUANT_CASE\((\d+), (\d+)\)", text)}


def test_ln_quant_widths():
    """supported_hidden(H), for every multiple of 64 up to 2048, exactly when
    a team of 32, 16 or 8 lanes (the largest dividing H / 8) holds the row
    at an instantiated chunk count; and a few widths by name.  The C entry
    sends every other width to the generic form: a warp a row below 1024
    columns, a CTA a row from there."""
    cases = ln_quant_instantiations()
    for h in range(64, 2049, 64):
        chunks = h // 8
        lanes = next(n for n in (32, 16, 8) if chunks % n == 0)
        assert supported_hidden(h) == ((lanes, chunks // lanes) in cases), h
    for h in (64, 768, 1024, 2048):
        assert supported_hidden(h), h
    for h in (0, 32, 100, 312, 576, 2112, 4096):
        assert not supported_hidden(h), h
    text = (_build.CSRC / "ln_quant.cu").read_text()
    assert "constexpr int kWideRow = 1024;" in text
    assert "if (team_lanes(hidden)) {" in text


@pytest.mark.parametrize("dtype, s, launches", [
    (torch.bfloat16, 40, 1), (torch.bfloat16, 128, 1),
    (torch.bfloat16, 129, 2), (torch.float32, 40, 2)])
def test_probs_backward_launches_by_route(monkeypatch, dtype, s, launches):
    calls = []

    class Lib:
        @staticmethod
        def msa_short_attention_probs_bwd(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(sa, "_check", lambda *a, **k: None)
    monkeypatch.setattr(sa, "_stream", lambda x: 0)
    monkeypatch.setattr(_build, "load", lambda *a: Lib)
    b, heads, h = 2, 2, 64
    q = torch.zeros(b, s, h, dtype=dtype)
    probs = torch.zeros(b, heads, s, sa.probs_width(s), dtype=dtype)
    entry = sa.short_attention_probs_backward
    before, before_tiled = entry.launches, entry.tiled.launches
    dq, dk, dv = sa.short_attention_probs_backward(q, q, q, probs, q, heads)
    assert entry.launches - before == launches
    tiled = dtype == torch.bfloat16 and s > sa.WHOLE_ROW_BWD_MAX_SEQ
    assert entry.tiled.launches - before_tiled == (launches if tiled else 0)
    (args,) = calls
    delta_ptr = args[5]
    assert (delta_ptr is None) == (launches == 1)
    assert args[9:13] == (b, s, h, heads)
    assert args[14] == pytest.approx(1 / (h // heads) ** 0.5)
    assert dq.shape == dk.shape == dv.shape == q.shape


# ---------------------------------------------------------------------------
# Head dims off the instantiations: the pad and the cut, through a stand-in
# library that computes attention on the tensors the wrappers hand it
# ---------------------------------------------------------------------------

def _at(ptr, *shape):
    """The f32 CPU tensor of ``shape`` over the memory at ``ptr``."""
    n = math.prod(shape)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctypes.c_float * n).from_address(ptr))).view(*shape)


def _attend(q, k, v, bias, heads, scale):
    """Attention over [B, S, H] at ``heads`` heads with softmax ``scale``."""
    b, s, h = q.shape
    split = lambda x: x.reshape(b, s, heads, h // heads)  # noqa: E731
    p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", split(q), split(k))
                      * scale + bias[:, None, None, :], -1)
    return torch.einsum("bnqk,bknd->bqnd", p, split(v)).reshape(b, s, h)


class StandIn:
    """A CUDA library's stand-in: each entry views the pointers it gets as
    the tensors the kernel would read and write, and computes on them with
    the hidden and scale it is handed."""

    def __init__(self):
        self.loaded, self.calls = [], []

    def load(self, name, signatures):
        self.loaded.append(name)
        return self

    def msa_short_attention_fwd(self, q, k, v, bias, out, lse, b, s, h,
                                heads, dtype, scale, *rest):
        self.calls.append((h, scale))
        args = [_at(p, b, s, h) for p in (q, k, v)]
        _at(out, b, s, h).copy_(_attend(*args, _at(bias, b, s), heads, scale))
        return 0

    def msa_short_attention_bwd(self, q, k, v, bias, dout, lse, delta, dq, dk,
                                dv, b, s, h, heads, dtype, scale, *rest):
        self.calls.append((h, scale))
        leaves = [_at(p, b, s, h).clone().requires_grad_() for p in (q, k, v)]
        grads = torch.autograd.grad(
            _attend(*leaves, _at(bias, b, s), heads, scale), leaves,
            _at(dout, b, s, h))
        for p, g in zip((dq, dk, dv), grads):
            _at(p, b, s, h).copy_(g)
        return 0

    def msa_short_attention_packed_bwd(self, qkv, bias, out, dout, lse, delta,
                                       dqkv, b, s, h, heads, dtype, scale,
                                       *rest):
        self.calls.append((h, scale))
        packed = _at(qkv, b, s, 3 * h).clone().requires_grad_()
        thirds = packed[..., :h], packed[..., h:2 * h], packed[..., 2 * h:]
        (grad,) = torch.autograd.grad(
            _attend(*thirds, _at(bias, b, s), heads, scale), packed,
            _at(dout, b, s, h))
        _at(dqkv, b, s, 3 * h).copy_(grad)
        return 0

    def msa_flash_attention_fwd(self, q, k, v, bias, out, lse, b, n, s, d,
                                dtype, scale, *rest):
        self.calls.append((n * d, scale))
        merge = lambda p: _at(p, b, n, s, d).transpose(1, 2).reshape(  # noqa: E731
            b, s, n * d)
        ctx = _attend(*map(merge, (q, k, v)), _at(bias, b, s), n, scale)
        _at(out, b, n, s, d).copy_(ctx.reshape(b, s, n, d).transpose(1, 2))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = StandIn()
    monkeypatch.setattr(_build, "load", lib.load)
    monkeypatch.setattr(sa, "_check", lambda *a, **k: None)
    monkeypatch.setattr(sa, "_stream", lambda x: 0)
    monkeypatch.setattr(attn, "_stream", lambda x: 0)
    monkeypatch.setattr(attn, "_check_heads", lambda *a: None)
    return lib


PAD_HEAD_DIMS = [8, 26, 100, 192]  # on the instantiations at 16, 32, 128, 256


def _inputs(d, heads=3, b=2, s=7, n=4):
    gen = torch.Generator().manual_seed(d)
    xs = [torch.randn(b, s, heads * d, generator=gen) for _ in range(n)]
    bias = torch.zeros(b, s)
    bias[1, 4:] = -10000.0
    return xs, bias, heads


def _check_calls(lib, source, d, heads):
    kd = sa.kernel_head_dim(d)
    assert lib.loaded and set(lib.loaded) == {f"{source}_d{kd}"}
    for hidden, scale in lib.calls:
        assert hidden == heads * kd
        assert scale == pytest.approx(1 / math.sqrt(d))


@pytest.mark.parametrize("d", PAD_HEAD_DIMS)
def test_padded_forward_hands_the_library_width_and_true_scale(stand_in, d):
    (q, k, v), bias, heads = _inputs(d, n=3)
    out, lse = sa._forward_kernel(q, k, v, bias, heads, 0, 0, False)
    _check_calls(stand_in, "short_attention", d, heads)
    assert lse is None and out.shape == q.shape
    torch.testing.assert_close(out, sa.short_attention_plain(
        q, k, v, bias, heads), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", PAD_HEAD_DIMS)
def test_padded_backward_cuts_the_gradients_back(stand_in, d):
    (q, k, v, dout), bias, heads = _inputs(d)
    lse = torch.zeros(q.shape[0], heads, q.shape[1])  # f32: the pair's input
    grads = sa.short_attention_backward(q, k, v, bias, lse, dout, heads)
    _check_calls(stand_in, "short_attention", d, heads)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(sa.short_attention_plain(
        *leaves, bias, heads), leaves, dout)
    for g, w in zip(grads, want):
        assert g.shape == q.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", PAD_HEAD_DIMS)
def test_padded_packed_backward_pads_each_third(stand_in, d):
    (q, k, v, dout), bias, heads = _inputs(d)
    qkv = torch.cat([q, k, v], -1)
    out = sa.short_attention_plain(q, k, v, bias, heads)
    dqkv = sa.short_attention_packed_backward(qkv, bias, out, dout, heads)
    _check_calls(stand_in, "short_attention", d, heads)
    leaf = qkv.clone().requires_grad_()
    (want,) = torch.autograd.grad(sa.short_attention_packed_plain(
        leaf, bias, heads), leaf, dout)
    assert dqkv.shape == qkv.shape
    torch.testing.assert_close(dqkv, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", PAD_HEAD_DIMS[:3])
def test_padded_head_split_forward(stand_in, d):
    (q, k, v), bias, heads = _inputs(d, n=3)
    split = lambda x: x.reshape(2, 7, heads, d).transpose(1, 2)  # noqa: E731
    out, _ = attn._forward_kernel(*map(split, (q, k, v)), bias, 0, 0, False)
    _check_calls(stand_in, "flash_attention", d, heads)
    assert out.shape == (2, heads, 7, d)
    torch.testing.assert_close(
        out, split(sa.short_attention_plain(q, k, v, bias, heads)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_f32_head_split_runs_the_short_kernels(stand_in, d):
    """f32 above head dim 128 on the head-split flash entry: its [B, heads,
    S, d] tensors go to the short-attention library of 256 as one head of
    each of B x heads rows (the flash kernels' f32 tiles would overfill
    shared memory there), padded to 256 at the true d's scale, and the
    output comes back in the head-split layout."""
    (q, k, v), bias, heads = _inputs(d, n=3)
    split = lambda x: x.reshape(2, 7, heads, d).transpose(1, 2)  # noqa: E731
    out, _ = attn._forward_kernel(*map(split, (q, k, v)), bias, 0, 0, False)
    assert set(stand_in.loaded) == {"short_attention_d256"}
    assert stand_in.calls == [(256, pytest.approx(1 / math.sqrt(d)))]
    assert out.shape == (2, heads, 7, d)
    torch.testing.assert_close(
        out, split(sa.short_attention_plain(q, k, v, bias, heads)),
        atol=1e-5, rtol=1e-5)

