"""msa_tpu_torch's MMBert forward against the JAX package on the same weights.

Tiny config (H=128, 2 heads so d=64 as on the card, 2 layers), inputs from
a numpy seed, JAX parameters carried over by ``from_jax_params``.  The JAX
side runs deterministic f32 with ``use_flash="always"``, ``on_tpu=False``:
its attention is the short-attention Pallas kernel in interpret mode.

Tolerance: f32, atol = rtol = 1e-4 on every returned head.  Both sides are
f32 throughout; what differs is summation order (einsum vs the Pallas
block dots, base-2 vs natural softmax).

bf16 (the serving recipe): each head's dtype must match JAX's, and its
max |port - JAX bf16| must stay within BF16_NOISE_FACTOR times the max
|JAX bf16 - JAX f32| of that head.  Rounding to bf16 at different points
(residual adds, pooler, fusion head, joint embed) moves results by about
the same amount as bf16 rounding itself, so a few times that noise is the
bound; a cast in the wrong place or precision shows as a larger gap.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.configs import MMBertConfig, tiny_bert_config
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.models.mmbert import mmbert_forward as jax_mmbert_forward
from msa_tpu_torch.models.mmbert import mmbert_forward
from msa_tpu_torch.models.weights import (
    cast_for_compute, from_jax_params, init_params)

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

ATOL = RTOL = 1e-4
BF16_NOISE_FACTOR = 3.0
HEADS = ("seq_text", "seq_joint", "align_visual", "align_speech", "nsp_text",
         "pooled_text", "pooled_visual", "pooled_speech", "temp", "logits")


def tiny_cfg(num_labels: int) -> MMBertConfig:
    bert = tiny_bert_config(hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=256,
                            vocab_size=200, max_position_embeddings=64)
    # padded vocab (200 -> 256): zero word rows, -1e9 decoder bias
    bert = dataclasses.replace(bert, vocab_pad_multiple=128)
    return MMBertConfig(bert=bert, visual_dim=47, speech_dim=74,
                        num_labels=num_labels)


def make_inputs(b=3, l=12, lp=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 200, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    ids[mask == 0] = 0
    vis = rng.standard_normal((b, lp, 47)).astype(np.float32)
    spc = rng.standard_normal((b, lp, 74)).astype(np.float32)
    vis[1, 9:] = 0.0  # padded frames
    spc[2, 5:] = 0.0
    tv = np.where(mask == 1, rng.integers(5, 200, size=(b, l)), 0).astype(np.int32)
    return ids, mask, tv, vis, spc


@pytest.mark.parametrize("num_labels,lp", [(1, 12), (7, 12), (1, 20),
                                            (1, 520)])
def test_mmbert_forward_matches_jax(num_labels, lp):
    """lp=520 is frame-level mode at L=16: the joint pass runs at S=536,
    which JAX's use_flash="always" sends through its flash2 kernels (in
    interpret mode) and the port, on the CPU, through the plain attention."""
    cfg = tiny_cfg(num_labels)
    jparams = init_mmbert_params(jax.random.key(num_labels), cfg)
    l = 16 if lp > 512 else 12
    ids, mask, tv, vis, spc = make_inputs(l=l, lp=lp)

    fwd = jax.jit(lambda p, *a: jax_mmbert_forward(
        p, *a, cfg, deterministic=True, compute_dtype=jnp.float32,
        use_flash="always", on_tpu=False, mlm_scores=False))
    ref = jax.device_get(fwd(jparams, ids, mask, tv, ids, vis, spc))

    params = from_jax_params(jax.device_get(jparams), torch.device("cpu"))
    t = torch.from_numpy
    with torch.no_grad():
        out = mmbert_forward(params, t(ids).long(), t(mask), t(tv).long(),
                             t(ids).long(), t(vis), t(spc), cfg)
    assert set(out) == set(HEADS)
    for name in HEADS:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    # num_labels 1 and 7 are both one-output regression heads
    assert out["logits"].shape == (3, 1)
    assert out["seq_joint"].shape == (6, l + lp, 128)


@pytest.mark.parametrize("num_labels", [1, 7])
def test_mmbert_forward_bf16_matches_jax(num_labels):
    """The bf16 forward, as the Predictor runs it (dense weights cast once
    by cast_for_compute), against JAX's bf16 forward on the same weights."""
    cfg = tiny_cfg(num_labels)
    jparams = init_mmbert_params(jax.random.key(num_labels), cfg)
    ids, mask, tv, vis, spc = make_inputs(seed=num_labels)

    def jax_run(dtype):
        fwd = jax.jit(lambda p, *a: jax_mmbert_forward(
            p, *a, cfg, deterministic=True, compute_dtype=dtype,
            use_flash="always", on_tpu=False, mlm_scores=False))
        return jax.device_get(fwd(jparams, ids, mask, tv, ids, vis, spc))

    ref, ref32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    params = cast_for_compute(
        from_jax_params(jax.device_get(jparams), torch.device("cpu")),
        torch.bfloat16)
    t = torch.from_numpy
    with torch.no_grad():
        out = mmbert_forward(params, t(ids).long(), t(mask), t(tv).long(),
                             t(ids).long(), t(vis), t(spc), cfg,
                             compute_dtype=torch.bfloat16)
    for name in HEADS:
        assert str(out[name].dtype).split(".")[1] == str(ref[name].dtype), name
        got = out[name].float().numpy()
        want = np.asarray(ref[name], np.float32)
        noise = np.abs(want - np.asarray(ref32[name], np.float32)).max()
        assert noise > 0, name  # JAX's bf16 run really rounded
        err = np.abs(got - want).max()
        assert err <= BF16_NOISE_FACTOR * noise, (
            f"{name}: port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {noise:.3g}")


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("num_labels", [1, 3])
def test_init_params_layout_matches_jax_bridge(num_labels):
    """init_params draws the layout that from_jax_params produces, with
    init_mmbert_params's stds, zero pad rows and -1e9 padded decoder bias."""
    cfg = tiny_cfg(num_labels)
    bridged = from_jax_params(
        jax.device_get(init_mmbert_params(jax.random.key(0), cfg)),
        torch.device("cpu"))
    drawn = init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(drawn) == _shapes(bridged)

    vocab, vp = cfg.bert.vocab_size, cfg.bert.padded_vocab_size
    word = drawn["bert"]["embeddings"]["word"]
    assert vp == 256 and word.shape == (256, 128)
    assert torch.all(word[vocab:] == 0)
    assert abs(float(word[:vocab].std()) - 0.02) < 2e-3
    bias = drawn["cls"]["decoder_bias"]
    assert torch.all(bias[vocab:] == -1e9) and torch.all(bias[:vocab] == 0)
    lp = drawn["bert"]["layers"][1]
    assert abs(float(lp["wi"]["weight"].std()) - 0.02) < 2e-3
    assert torch.all(lp["wi"]["bias"] == 0)
    assert torch.all(lp["mlp_ln"]["scale"] == 1)
    assert drawn["fusion"]["classifier2"]["weight"].shape == (
        1 if cfg.regression else num_labels, 128)


def test_from_jax_params_transposes_dense_and_unstacks_layers():
    cfg = tiny_cfg(1)
    jparams = jax.device_get(init_mmbert_params(jax.random.key(1), cfg))
    params = from_jax_params(jparams, torch.device("cpu"))
    layers = params["bert"]["layers"]
    assert len(layers) == 2
    np.testing.assert_array_equal(
        layers[1]["wi"]["weight"].numpy(),
        np.asarray(jparams["bert"]["layers"]["wi"]["kernel"][1]).T)
    np.testing.assert_array_equal(
        params["fusion"]["attn"]["weight"].numpy(),
        np.asarray(jparams["fusion"]["attn"]["kernel"]).T)
    # the fused joint-embed kernel reads W in the JAX [D, H] layout
    np.testing.assert_array_equal(params["joint"]["Wv"]["kernel"].numpy(),
                                  np.asarray(jparams["joint"]["Wv"]["kernel"]))
