"""The widths the port's CUDA kernels take, and the v2s backward's launches.

The kernels build and run only on a card (chip_smoke.py holds them against
their plain versions there, at head dim 32 and 64); these tests hold the
Python side of the contract on the CPU:

* every attention entry takes head dim 32 or 64 (``HEAD_DIMS``, the
  instantiations of ``csrc/mma_tiles.cuh::by_head_dim``) and raises for
  any other, naming what runs;
* ln_quant takes H a multiple of 64 up to 512, of 128 up to 1024 or of
  256 up to 2048 (``supported_hidden``), the (lanes, chunks) pairs
  ``csrc/ln_quant.cu`` instantiates;
* ``short_attention_probs_backward`` counts one launch on the whole-row
  tensor-core route (bf16, S <= 128), where it hands the C entry no delta
  scratch, and two elsewhere (bf16 above 128 keys on the tiled tensor-core
  pair, counted on its route's counter too; f32 on the CUDA-core pair),
  with a stand-in for the CUDA library.
"""

import re

import pytest
import torch

from msa_tpu_torch import _build
from msa_tpu_torch.ops import short_attention as sa
from msa_tpu_torch.ops.ln_quant import supported_hidden


@pytest.mark.parametrize("d, ok", [(32, True), (64, True), (16, False),
                                   (48, False), (128, False), (64.5, False)])
def test_head_dim_acceptance(d, ok):
    if ok:
        sa.check_head_dim(d, "entry")
    else:
        with pytest.raises(ValueError, match="the kernels take 32 or 64"):
            sa.check_head_dim(d, "entry")


def test_head_dims_are_the_instantiated_ones():
    """HEAD_DIMS is the set by_head_dim dispatches on, and every attention
    source dispatches through it."""
    text = (_build.CSRC / "mma_tiles.cuh").read_text()
    dims = tuple(int(d) for d in re.findall(
        r"if \(d == (\d+)\) return f\(std::integral_constant", text))
    assert dims == sa.HEAD_DIMS
    for name in ("short_attention", "short_attention_v1", "flash2",
                 "flash_attention"):
        assert "by_head_dim(" in (_build.CSRC / f"{name}.cu").read_text(), name


def ln_quant_instantiations():
    text = (_build.CSRC / "ln_quant.cu").read_text()
    return {(int(a), int(b)) for a, b in re.findall(
        r"MSA_LN_QUANT_CASE\((\d+), (\d+)\)", text)}


def test_ln_quant_widths():
    """supported_hidden(H), for every multiple of 64 up to 2048, exactly when
    a team of 32, 16 or 8 lanes (the largest dividing H / 8) holds the row
    at an instantiated chunk count; and a few widths by name."""
    cases = ln_quant_instantiations()
    for h in range(64, 2049, 64):
        chunks = h // 8
        lanes = next(n for n in (32, 16, 8) if chunks % n == 0)
        assert supported_hidden(h) == ((lanes, chunks // lanes) in cases), h
    for h in (64, 768, 1024, 2048):
        assert supported_hidden(h), h
    for h in (0, 100, 576, 2112):
        assert not supported_hidden(h), h


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
