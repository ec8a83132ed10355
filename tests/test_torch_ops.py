"""msa_tpu_torch's kernel modules on the CPU: plain versions against JAX.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
build and run only on a card; chip_smoke.py holds them against these plain
versions there).  The JAX side runs its Pallas kernels in interpret mode,
as the JAX package's own tests do.

Tolerances:
  * f32: atol = rtol = 1e-5 -- same math, different summation order;
  * attention rows whose keys are ALL masked: atol 5e-3 -- every score
    carries the -10000 fill, whose f32 ulp (2^-10) quantises the scores
    differently in JAX's base-2 softmax domain and the port's natural one;
  * bf16: atol = rtol = 3e-2 -- both sides round q/k/v, the probabilities
    and the output to bf16, at different points.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msa_tpu.ops.fused_joint_embed import fused_joint_embed as jax_joint_embed
from msa_tpu.ops.short_attention import short_attention_v2
from msa_tpu_torch import _build
from msa_tpu_torch.ops.attention import multi_head_attention
from msa_tpu_torch.ops.flash2 import flash_attention2
from msa_tpu_torch.ops.fused_joint_embed import (
    fused_joint_embed, fused_joint_embed_plain)
from msa_tpu_torch.ops.short_attention import (
    short_attention, short_attention_plain)

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

F32_TOL = 1e-5
MASKED_ROW_ATOL = 5e-3
BF16_TOL = 3e-2


def attention_inputs(b, s, h, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[0, :] = 0                  # fully masked row (Predictor padding)
    mask[1, s // 3:] = 0            # partial key padding
    if b > 2:
        mask[2, s - 1:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, bias


def _jax_attention(q, k, v, bias, heads, dtype):
    cast = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    out = short_attention_v2(cast(q), cast(k), cast(v), jnp.asarray(bias),
                             None, heads, 0.0, True)  # interpret mode
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("s", [12, 40])
def test_short_attention_plain_matches_jax_f32(s):
    q, k, v, bias = attention_inputs(3, s, 128)
    ref = _jax_attention(q, k, v, bias, 2, jnp.float32)
    t = torch.from_numpy
    out = short_attention(t(q), t(k), t(v), t(bias), 2).numpy()
    np.testing.assert_allclose(out[1:], ref[1:], atol=F32_TOL, rtol=F32_TOL)
    assert np.isfinite(out[0]).all()
    np.testing.assert_allclose(out[0], ref[0], atol=MASKED_ROW_ATOL, rtol=0)


@pytest.mark.parametrize("s", [12, 40])
def test_short_attention_plain_matches_jax_bf16(s):
    q, k, v, bias = attention_inputs(3, s, 128, seed=1)
    ref = _jax_attention(q, k, v, bias, 2, jnp.bfloat16)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    out = short_attention(bf(q), bf(k), bf(v), torch.from_numpy(bias), 2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("use_flash", ["auto", "always", "never"])
def test_multi_head_attention_on_cpu_is_plain(use_flash):
    """CPU tensors take the plain path under every use_flash setting, and
    no kernel launch is counted."""
    q, k, v, bias = (torch.from_numpy(x) for x in attention_inputs(2, 24, 128))
    before = short_attention.launches
    out = multi_head_attention(q, k, v, bias[:, None, None, :], num_heads=2,
                               use_flash=use_flash)
    ref = short_attention_plain(q, k, v, bias, 2)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert short_attention.launches == before


def test_multi_head_attention_rejects_unknown_use_flash():
    q = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError):
        multi_head_attention(q, q, q, torch.zeros(1, 1, 1, 4), num_heads=2,
                             use_flash="sometimes")


def joint_inputs(b, l, lp, d, h, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, lp, d)).astype(np.float32)
    feats[1, lp // 2:] = 0.0  # padded frames
    return (rng.standard_normal((b, l, h)).astype(np.float32), feats,
            (rng.standard_normal((d, h)) * 0.05).astype(np.float32),
            (rng.standard_normal(h) * 0.01).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32),
            (0.1 * rng.standard_normal(h)).astype(np.float32))


@pytest.mark.parametrize("l,lp,d,h", [
    (16, 16, 47, 128), (12, 20, 74, 128), (8, 8, 371, 128),
    # 3 x 37 = 111 frame rows: off every tile of the kernel's frame CTAs
    # (R = 8-64 rows), at the tiny preset's H = 64 and a ragged H = 200
    pytest.param(5, 37, 47, 64, id="frames-off-tile-h64"),
    pytest.param(4, 37, 74, 200, id="frames-off-tile-h200"),
    # past the width whose four relu'd f32 rows fill a CTA's shared memory
    # (14,459): the kernel's form that holds no row
    pytest.param(4, 4, 47, 16384, id="h16384")])
def test_fused_joint_embed_plain_matches_jax(l, lp, d, h):
    args = joint_inputs(3, l, lp, d, h)
    ref = np.asarray(jax_joint_embed(*(jnp.asarray(a) for a in args), 1e-12,
                                     True))  # interpret mode
    out = fused_joint_embed(*(torch.from_numpy(a) for a in args), 1e-12)
    assert out.shape == (3, l + lp, h)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)


def test_fused_joint_embed_bf16_keeps_dtype_and_f32_projection():
    """bf16 text/feats: output in bf16, projection and LN in f32 (the JAX
    kernel's math), so it matches the f32 result up to bf16 rounding."""
    args = [torch.from_numpy(a) for a in joint_inputs(2, 8, 8, 47, 128)]
    bf = [a.to(torch.bfloat16) for a in args[:2]] + args[2:]
    out = fused_joint_embed(*bf, 1e-12)
    assert out.dtype == torch.bfloat16
    ref = fused_joint_embed_plain(*[a.float() for a in bf], 1e-12)
    torch.testing.assert_close(out.float(), ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("fn", ["attention", "joint", "flash2"])
def test_wrappers_raise_on_devices_without_kernel(fn):
    """Only CPU tensors take the plain version; another device raises
    instead of falling back (here: the meta device)."""
    if fn in ("attention", "flash2"):
        q = torch.empty(2, 8, 128, device="meta")
        attend = short_attention if fn == "attention" else flash_attention2
        call = lambda: attend(  # noqa: E731
            q, q, q, torch.empty(2, 8, device="meta"), 2)
    else:
        t = torch.empty(2, 8, 256, device="meta")
        f = torch.empty(2, 8, 47, device="meta")
        p = torch.empty(256, device="meta")
        call = lambda: fused_joint_embed(  # noqa: E731
            t, f, torch.empty(47, 256, device="meta"), p, p, p)
    with pytest.raises(ValueError, match="no kernel"):
        call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("short_attention")
    assert not (tmp_path / "build").exists()  # nothing half-built left


def test_library_path_tracks_source_hash(monkeypatch, tmp_path):
    """The library name changes with the source text: an edited kernel is
    rebuilt, an unchanged one is reused."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    assert first.parent == _build.BUILD_DIR
    (src / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first


def test_library_path_tracks_shared_headers(monkeypatch, tmp_path):
    """An edit to a header in csrc/ (dropout.cuh, which both attention
    sources include) rebuilds every library instead of reusing a stale one."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "rule.cuh"\n')
    (src / "rule.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path("k")
    (src / "rule.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first


def test_every_kernel_has_a_source_with_a_c_entry_point():
    entries = {"short_attention": "msa_short_attention_fwd",
               "fused_joint_embed": "msa_fused_joint_embed",
               "ln_quant": "msa_ln_quant_static",
               "flash2": "msa_flash2_fwd",
               "fused_adamw": "msa_fused_adamw",
               "flash_attention": "msa_flash_attention_fwd",
               "short_attention_v1": "msa_short_attention_v1_fwd"}
    assert set(_build.KERNELS) == set(entries)
    for name, entry in entries.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {entry}(' in text
        # the launch may sit in a csrc header the source includes
        # (flash_kernels.cuh holds flash2's and the head-split launchers)
        included = re.findall(r'#include "([^"]+)"', text)
        text += "".join((_build.CSRC / h).read_text() for h in included)
        assert "return (int)cudaGetLastError();" in text
