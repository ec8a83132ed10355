"""The bf16 short-attention route at head dims above 128 (the library of 256).

There the whole-row templates (``csrc/short_fwd_tc.cuh``,
``csrc/short_bwd_tc.cuh``) do not fit, so bf16 runs the two-sweep ring
forward and the tiled dq and dk/dv pair (``csrc/short_bwd_tiled.cuh``) on
the tensor cores at every S from 1 to 1023; f32 keeps its CUDA-core pair.
The kernels build and run only on a card (``chip_smoke.py`` holds them
against their plain versions there, at d = 192 and 256); these tests hold
the Python side of the route on the CPU, with a stand-in for the CUDA
library that records the calls:

* ``backward_route`` / ``backward_launches`` / ``v1_backward_launches`` at
  d = 192 and 256 in bf16: the tiled pair, two launches (v1: the training
  forward, then the pair) at S = 1, 40, 128, 129 and 1023; f32 the
  CUDA-core pair; d = 128 keeps the whole-row launch up to 128 keys;
* under autograd ``_ShortAttention``'s forward asks the C forward for the
  row lse at S = 40 (the pair reads it), and its backward hands the C entry
  that lse and delta scratch;
* every backward entry (v2, v3, v2s, v2p; v1) counts its launches, and the
  tiled route's counter counts them too.

The plain versions at d = 192 and 256 are held against JAX in
``test_torch_any_head_dim.py``.
"""

import pytest
import torch

from msa_tpu_torch import _build
from msa_tpu_torch.ops import short_attention as sa

torch.set_num_threads(1)

WIDE_DIMS = (192, 256)
SEQS = (1, 40, 128, 129, 1023)


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_bf16_backward_is_the_tiled_pair(d, seq):
    bf, f32 = torch.bfloat16, torch.float32
    assert sa.backward_route(seq, bf, d) == sa.TILED
    assert sa.tensor_core_backward(seq, bf, d)
    assert sa.backward_launches(seq, bf, d) == 2
    assert sa.v1_backward_launches(seq, bf, d) == 3
    assert sa.backward_route(seq, f32, d) == sa.CUDA_CORES
    assert sa.backward_launches(seq, f32, d) == 2


@pytest.mark.parametrize("seq, route", [(1, sa.WHOLE_ROW), (128, sa.WHOLE_ROW),
                                        (129, sa.TILED)])
def test_head_dim_128_keeps_the_whole_row_launch(seq, route):
    assert sa.backward_route(seq, torch.bfloat16, 128) == route
    assert sa.backward_launches(seq, torch.bfloat16, 128) == (
        1 if route == sa.WHOLE_ROW else 2)


class Recorder:
    """A CUDA library's stand-in: every C entry records its name and
    arguments (the pointers as ints, None where the wrapper passes null)
    and returns 0."""

    def __init__(self):
        self.loaded, self.calls = [], []

    def load(self, name, signatures):
        self.loaded.append(name)
        return self

    def __getattr__(self, entry):
        if not entry.startswith("msa_"):
            raise AttributeError(entry)

        def call(*args):
            self.calls.append((entry, args))
            return 0
        return call


class OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as one on the card does, so
    that ``_ShortAttention`` takes its kernel route into the stand-in."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def recorder(monkeypatch):
    lib = Recorder()
    monkeypatch.setattr(_build, "load", lib.load)
    monkeypatch.setattr(sa, "_check", lambda *a, **k: None)
    monkeypatch.setattr(sa, "_stream", lambda x: 0)
    monkeypatch.setattr(sa, "USE_V3_BWD", False)
    return lib


def _bf16(b, s, h, n=3):
    return [torch.zeros(b, s, h, dtype=torch.bfloat16) for _ in range(n)]


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_autograd_pair_keeps_the_lse(recorder, d):
    b, s, heads = 2, 40, 2
    q, k, v = (x.as_subclass(OnCard).requires_grad_()
               for x in _bf16(b, s, heads * d))
    bias = torch.zeros(b, s)
    bwd = sa.short_attention_backward
    before, tiled = bwd.launches, bwd.tiled.launches
    out = sa._ShortAttention.apply(q, k, v, bias, heads, 0, 0.0, None)
    ((name, args),) = recorder.calls
    assert name == "msa_short_attention_fwd"
    assert args[5] is not None  # the training form's lse
    assert args[6:10] == (b, s, heads * 256, heads)
    torch.autograd.grad(out.float().sum(), (q, k, v))
    assert [c[0] for c in recorder.calls] == ["msa_short_attention_fwd",
                                              "msa_short_attention_bwd"]
    args = recorder.calls[1][1]
    assert args[5] is not None and args[6] is not None  # lse, delta
    assert bwd.launches - before == 2 == bwd.tiled.launches - tiled
    assert set(recorder.loaded) == {"short_attention_d256"}


def _call_backward(entry, b, s, heads, d):
    q, k, v, dout = _bf16(b, s, heads * d, 4)
    bias = torch.zeros(b, s)
    lse = torch.zeros(b, heads, s)
    if entry == "v2":
        return sa.short_attention_backward(q, k, v, bias, lse, dout, heads)
    if entry == "v3":
        return sa.short_attention_v3_backward(q, k, v, bias, q, dout, heads)
    if entry == "v2s":
        probs = torch.zeros(b, heads, s, sa.probs_width(s),
                            dtype=torch.bfloat16)
        return sa.short_attention_probs_backward(q, k, v, probs, dout, heads)
    if entry == "v2p":
        qkv = torch.cat([q, k, v], dim=-1)
        return sa.short_attention_packed_backward(qkv, bias, q, dout, heads)
    return sa.short_attention_v1_backward(q, k, v, bias, dout, heads)


ENTRIES = {"v2": ("short_attention_backward", "msa_short_attention_bwd"),
           "v3": ("short_attention_v3_backward", "msa_short_attention_v3_bwd"),
           "v2s": ("short_attention_probs_backward",
                   "msa_short_attention_probs_bwd"),
           "v2p": ("short_attention_packed_backward",
                   "msa_short_attention_packed_bwd"),
           "v1": ("short_attention_v1_backward", "msa_short_attention_bwd")}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_bf16_backwards_count_the_tiled_pair(recorder, entry, d):
    b, s, heads = 2, 40, 2
    name, c_entry = ENTRIES[entry]
    fn = getattr(sa, name)
    before = fn.launches
    tiled = fn.tiled.launches if entry != "v1" else None
    grads = _call_backward(entry, b, s, heads, d)
    widths = [3 * heads * d] if entry == "v2p" else [heads * d] * 3
    assert [g.shape for g in (grads if entry != "v2p" else [grads])] == [
        (b, s, w) for w in widths]
    assert recorder.calls[-1][0] == c_entry
    if entry == "v1":  # the v2 training forward for the lse, then the pair
        assert [c[0] for c in recorder.calls] == ["msa_short_attention_fwd",
                                                  c_entry]
        assert recorder.calls[0][1][5] is not None
        assert fn.launches - before == 3
        return
    assert len(recorder.calls) == 1
    assert fn.launches - before == 2 == fn.tiled.launches - tiled
