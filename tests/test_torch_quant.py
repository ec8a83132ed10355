"""msa_tpu_torch's int8 serving path against the JAX package.

Tiny config (H=128, 2 heads, 2 layers), JAX parameters carried over by
``from_jax_params``, inputs made from a seed with numpy.  Tolerances:

  * quantized weights and scales: bit-equal (the same true division and
    round half to even on the same f32 values);
  * ``quantize_act`` on the same inputs: bit-equal; ``int8_dense`` /
    ``int8_matmul_pre`` in f32: 1e-6 relative (exact int32 products, the
    same dequant order; XLA may fuse the f32 epilogue differently);
  * ``ln_quant_plain`` against JAX's Pallas kernel in interpret mode: the
    JAX test's bounds (h within 1e-6; xi differs in under 0.5 % of the
    elements and never by more than one level: a 1-ulp LayerNorm difference
    flips a rounding tie; the dynamic row scale within 1e-5 relative);
  * the int8 encoder and Predictor in f32: ENCODER_ATOL / PRED_ATOL; what
    differs is summation order, which moves a quantization tie by at most
    one level, i.e. by one activation scale times a weight;
  * bf16: within BF16_NOISE_FACTOR times the gap between JAX's own bf16
    and f32 predictions (the two frameworks round to bf16 at different
    points), as the bf16 serving tests hold it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msa_tpu.models.bert as jax_bert
from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config,
)
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.inference import calibrate_act_stats as jax_calibrate
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.models.mmbert import mmbert_forward as jax_mmbert_forward
from msa_tpu.ops import quant as jq
from msa_tpu.ops.ln_quant import ln_quant as jax_ln_quant
import msa_tpu_torch.models.bert as port_bert
import msa_tpu_torch.ops.attention as port_attention
from msa_tpu_torch.configs import ExperimentConfig as PortExperimentConfig
from msa_tpu_torch.inference import Predictor, calibrate_act_stats
from msa_tpu_torch.models.mmbert import mmbert_forward
from msa_tpu_torch.models.weights import cast_for_compute, from_jax_params
from msa_tpu_torch.ops import quant as tq
from msa_tpu_torch.ops.ln_quant import ln_quant, ln_quant_plain

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

ENCODER_ATOL = 2e-5
PRED_ATOL = 2e-6
BF16_NOISE_FACTOR = 3.0
HEAD_SCALE = 30.0  # spreads the predictions over tanh's linear range
STATS = ("attn_in", "ctx", "mlp_in", "ffn_act")


def experiment(compute_dtype="float32"):
    bert = tiny_bert_config(hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=256,
                            vocab_size=120)
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7, num_labels=1),
        data=DataConfig(dataset="mosi", max_seq_length=12),
        train=TrainConfig(compute_dtype=compute_dtype, data_parallel=1))


def port_config(exp):
    return PortExperimentConfig.from_json(exp.to_json())


@pytest.fixture(scope="module")
def jparams():
    exp = experiment()
    params = jax.device_get(init_mmbert_params(jax.random.key(0), exp.model))
    for name in ("classifier1", "classifier2"):
        params["fusion"][name]["kernel"] = (
            np.asarray(params["fusion"][name]["kernel"]) * HEAD_SCALE)
    return params


@pytest.fixture(scope="module")
def split():
    return synthetic_split(10, 12, 5, 7, vocab_size=120, seed=1)


@pytest.fixture(scope="module")
def jax_int8_predictions(jparams, split):
    """JAX's f32 int8 predictions of the split at batch 4, per mode."""
    return {mode: JaxPredictor(experiment(), jparams, batch_size=4,
                               **quantize_kwargs(mode, split)).predict_split(split)
            for mode in ("int8", "int8_static")}


def quantize_kwargs(mode, split):
    return {"quantize": mode,
            "calibration": split if mode == "int8_static" else None}


def batch(split, n=4):
    return [np.asarray(x[:n]) for x in (split.input_ids, split.attention_mask,
                                         split.visual, split.speech)]


def jax_stats(exp, jparams, split):
    ids, mask, vis, spc = (jnp.asarray(x) for x in batch(split))
    return jax.device_get(jax_mmbert_forward(
        jparams, ids, mask, ids, ids, vis, spc, exp.model, deterministic=True,
        mlm_scores=False, collect_act_stats=True)["act_stats"])


def torch_stats(stats):
    return {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}


def test_quantize_weight_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    kernel = rng.standard_normal((3, 16, 24)).astype(np.float32)  # [L, in, out]
    kernel[1] *= 100.0  # per-(layer, channel) scales must differ
    kernel[2, :, 5] = 0.0  # an all-zero channel: scale eps
    qk, qs = jq.quantize_weight(jnp.asarray(kernel))
    qw, scale = tq.quantize_weight(torch.from_numpy(kernel).transpose(1, 2))
    assert qw.dtype == torch.int8 and qw.is_contiguous()
    np.testing.assert_array_equal(qw.numpy(), np.asarray(qk).transpose(0, 2, 1))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(qs))


def test_quantize_bert_params_bit_equal_to_jax(jparams):
    exp = experiment()
    stats = {k: np.asarray([1.5 + i, 2.5 * (i + 1)], np.float32)
             for i, k in enumerate(STATS)}
    ref = jax.device_get(jq.quantize_bert_params(
        jparams, act_stats={k: jnp.asarray(v) for k, v in stats.items()},
        margin=1.1))
    out = tq.quantize_bert_params(from_jax_params(jparams, "cpu"),
                                  act_stats=torch_stats(stats), margin=1.1)
    jl = ref["bert"]["layers"]
    for i in range(exp.model.bert.num_hidden_layers):
        for key in tq.QUANT_LAYER_KEYS:
            got = out["bert"]["layers"][i][key]
            assert set(got) == {"qweight", "qscale", "bias", "ascale"}
            np.testing.assert_array_equal(got["qweight"].numpy(),
                                          np.asarray(jl[key]["qkernel"][i]).T)
            np.testing.assert_array_equal(got["qscale"].numpy(),
                                          np.asarray(jl[key]["qscale"][i]))
            np.testing.assert_array_equal(got["bias"].numpy(),
                                          np.asarray(jl[key]["bias"][i]))
            assert got["ascale"].shape == ()
            assert float(got["ascale"]) == float(np.asarray(jl[key]["ascale"][i]))
    # everything but the six projections is untouched
    assert out["fusion"]["classifier1"]["weight"].dtype == torch.float32
    assert "weight" in out["bert"]["pooler"]


def test_quantize_bert_params_refuses_fused_qkv(jparams):
    """fuse_qkv=True, which the port used to refuse, now builds JAX's fused
    entry: each layer's q, k, v replaced by one "qkv" whose qweight
    ([3H, H], the port's [out, in]), qscale and bias are q|k|v on the
    output axis and whose static scale is q's; bit-equal to JAX's tree,
    with per-row and with static scales."""
    for static in (False, True):
        check_fused_tree(jparams, static)


def check_fused_tree(jparams, static):
    stats = {k: np.asarray([1.5 + i, 2.5 * (i + 1)], np.float32)
             for i, k in enumerate(STATS)} if static else None
    ref = jax.device_get(jq.quantize_bert_params(
        jparams, act_stats=None if stats is None else {
            k: jnp.asarray(v) for k, v in stats.items()}, fuse_qkv=True))
    out = tq.quantize_bert_params(
        from_jax_params(jparams, "cpu"),
        act_stats=None if stats is None else torch_stats(stats), fuse_qkv=True)
    jl = ref["bert"]["layers"]["qkv"]
    for i, layer in enumerate(out["bert"]["layers"]):
        assert not {"q", "k", "v"} & set(layer)
        got = layer["qkv"]
        assert set(got) == {"qweight", "qscale", "bias"} | (
            {"ascale"} if static else set())
        assert got["qweight"].shape == (3 * 128, 128)
        np.testing.assert_array_equal(got["qweight"].numpy(),
                                      np.asarray(jl["qkernel"][i]).T)
        np.testing.assert_array_equal(got["qscale"].numpy(),
                                      np.asarray(jl["qscale"][i]))
        np.testing.assert_array_equal(got["bias"].numpy(),
                                      np.asarray(jl["bias"][i]))
        if static:
            assert float(got["ascale"]) == float(np.asarray(jl["ascale"][i]))
        for key in ("o", "wi", "wo"):
            np.testing.assert_array_equal(
                layer[key]["qweight"].numpy(),
                np.asarray(ref["bert"]["layers"][key]["qkernel"][i]).T)


def test_act_scales_from_stats_match_jax():
    stats = {k: np.asarray([0.5, 3.0, 7.25], np.float32) * (i + 1)
             for i, k in enumerate(STATS)}
    ref = jq.act_scales_from_stats({k: jnp.asarray(v) for k, v in stats.items()},
                                   margin=1.25)
    out = tq.act_scales_from_stats(torch_stats(stats), margin=1.25)
    assert set(out) == set(ref) == set(tq.PROJ_STAT)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("static", [False, True])
def test_quantize_act_and_int8_dense_match_jax(static):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 9, 64)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row
    w = rng.standard_normal((64, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    asc = np.float32(2.5 / 127) if static else None
    qk, qs = jq.quantize_weight(jnp.asarray(w))
    qw, scale = tq.quantize_weight(torch.from_numpy(w.T))
    jasc = None if asc is None else jnp.asarray(asc)
    tasc = None if asc is None else torch.tensor(asc)

    xi_ref, row_ref = jq.quantize_act(jnp.asarray(x), jasc)
    xi, row = tq.quantize_act(torch.from_numpy(x), tasc)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(xi_ref))
    np.testing.assert_array_equal(row.numpy(), np.asarray(row_ref))

    ref = np.asarray(jq.int8_dense(jnp.asarray(x), qk, qs, jnp.asarray(b), jasc))
    out = tq.int8_dense(torch.from_numpy(x), qw, scale, torch.from_numpy(b), tasc)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)

    ref_pre = np.asarray(jq.int8_matmul_pre(xi_ref, row_ref, qk, qs,
                                            jnp.asarray(b), jnp.float32))
    out_pre = tq.int8_matmul_pre(xi, row, qw, scale, torch.from_numpy(b),
                                 torch.float32)
    np.testing.assert_allclose(out_pre.numpy(), ref_pre, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("static", [False, True])
def test_ln_quant_plain_matches_jax_kernel(static):
    """The plain version against JAX's Pallas kernel in interpret mode,
    with tests/test_quant.py's tolerances."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    r = rng.standard_normal((2, 8, 128)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    asc = np.float32(0.05) if static else None
    h_ref, xi_ref, row_ref = jax_ln_quant(
        jnp.asarray(x), jnp.asarray(r),
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, 1e-12,
        ascale=None if asc is None else jnp.asarray(asc), interpret=True)
    args = (torch.from_numpy(x), torch.from_numpy(r),
            {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
            1e-12, None if asc is None else torch.tensor(asc))
    h, xi, row = ln_quant(*args)  # CPU tensors: the plain version
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-6,
                               atol=1e-6)
    xi, xi_ref = xi.numpy().astype(np.int32), np.asarray(xi_ref, np.int32)
    assert np.mean(xi != xi_ref) < 0.005
    assert np.abs(xi - xi_ref).max() <= 1
    if static:
        assert row is None and row_ref is None
    else:
        assert row.shape == (2, 8, 1)
        np.testing.assert_allclose(row.numpy(), np.asarray(row_ref), rtol=1e-5)
    # the plain version is the composition it fuses
    h2, xi2, _ = ln_quant_plain(args[0], args[1], args[2]["scale"],
                                args[2]["bias"], 1e-12, args[4])
    want_xi, _ = tq.quantize_act(h2, args[4])
    assert torch.equal(xi2, want_xi)


def quantized_pair(exp, jparams, split, static):
    """The JAX and port parameter trees, int8 on the same weights (static
    scales from JAX's calibration stats, handed to both)."""
    stats = jax_stats(exp, jparams, split) if static else None
    jq_params = jq.quantize_bert_params(
        jparams, act_stats=None if stats is None else
        {k: jnp.asarray(v) for k, v in stats.items()})
    port = tq.quantize_bert_params(
        from_jax_params(jparams, "cpu"),
        act_stats=None if stats is None else torch_stats(stats))
    return jq_params, port


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_int8_encoder_matches_jax(jparams, split, static, interpret,
                                  monkeypatch):
    """The int8 encoder against JAX's, with JAX's fused LN + quantize sites
    on (Pallas interpret mode) or off (its XLA composition); the port runs
    its fused-site wiring with the plain ln_quant on the CPU."""
    exp = experiment()
    jq_params, port = quantized_pair(exp, jparams, split, static)
    rng = np.random.default_rng(10)
    hidden = rng.standard_normal((3, 12, 128)).astype(np.float32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0
    monkeypatch.setattr(jax_bert, "_LN_QUANT_INTERPRET", interpret)
    ref = np.asarray(jax_bert.bert_encoder(
        jq_params["bert"], jnp.asarray(hidden),
        jax_bert.extended_attention_mask(jnp.asarray(mask)), exp.model.bert,
        deterministic=True))
    out = port_bert.bert_encoder(
        port["bert"], torch.from_numpy(hidden),
        port_bert.extended_attention_mask(torch.from_numpy(mask)),
        port_config(exp).model.bert)
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out.numpy(), ref, atol=ENCODER_ATOL, rtol=0)


@pytest.mark.parametrize("static", [False, True])
def test_int8_encoder_fused_sites_per_layer(jparams, split, static,
                                            monkeypatch):
    """The fused sites the port runs per layer: mlp_in in both modes, and
    with static scales the closing LayerNorm too, the last layer's view at
    layer 0's scale (discarded), so that every layer launches the kernels
    the same number of times.  Layer 0's view is one standalone quantize."""
    exp = experiment()
    _, port = quantized_pair(exp, jparams, split, static)
    layers = port["bert"]["layers"]
    calls = []
    real = port_bert.ln_quant

    def counting(x, res, ln_params, eps, ascale=None):
        calls.append(ascale)
        return real(x, res, ln_params, eps, ascale)

    monkeypatch.setattr(port_bert, "ln_quant", counting)
    hidden = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 12, 128)).astype(np.float32))
    bias = port_bert.extended_attention_mask(torch.ones(2, 12))
    port_bert.bert_encoder(port["bert"], hidden, bias,
                           port_config(exp).model.bert)
    n = len(layers)
    if not static:
        assert calls == [None] * n
        return
    assert len(calls) == 2 * n
    for i in range(n):
        assert calls[2 * i] is layers[i]["wi"]["ascale"]
        assert calls[2 * i + 1] is layers[(i + 1) % n]["q"]["ascale"]


def test_collect_act_stats_matches_jax(jparams, split):
    exp = experiment()
    ref = jax_stats(exp, jparams, split)
    ids, mask, vis, spc = (torch.from_numpy(x) for x in batch(split))
    ids = ids.long()
    out = mmbert_forward(from_jax_params(jparams, "cpu"), ids, mask, ids, ids,
                         vis, spc, port_config(exp).model,
                         collect_act_stats=True)["act_stats"]
    assert set(out) == set(ref) == set(STATS)
    for k in STATS:
        assert out[k].shape == (exp.model.bert.num_hidden_layers,)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5)


def test_calibrate_act_stats_matches_jax(jparams, split):
    """Ten rows at batch 4: the last batch repeats its two real rows."""
    exp = experiment()
    ref = jax_calibrate(exp, jparams, split, batch_size=4)
    out = calibrate_act_stats(port_config(exp), from_jax_params(jparams, "cpu"),
                              split, batch_size=4)
    for k in STATS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_predictor_int8_matches_jax(jparams, split, mode, jax_int8_predictions):
    """f32, ragged split (10 rows at batch 4): int8 predictions within
    PRED_ATOL of JAX's, and off the full-precision ones by the
    quantization."""
    exp = experiment()
    ref = jax_int8_predictions[mode]
    pred = Predictor(port_config(exp), from_jax_params(jparams, "cpu"), 4,
                     "cpu", **quantize_kwargs(mode, split))
    assert pred.params["bert"]["layers"][0]["wi"]["qweight"].dtype == torch.int8
    assert ("ascale" in pred.params["bert"]["layers"][0]["q"]) == (
        mode == "int8_static")
    out = pred.predict_split(split)
    full = JaxPredictor(exp, jparams, batch_size=4).predict_split(split)
    assert out.shape == ref.shape == (10,)
    np.testing.assert_allclose(out, ref, atol=PRED_ATOL, rtol=0)
    assert np.abs(out - full).max() > 10 * PRED_ATOL  # it did quantize


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_predictor_int8_bf16_matches_jax_bf16(jparams, split, mode,
                                              jax_int8_predictions):
    exp = experiment()
    exp16 = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, compute_dtype="bfloat16"))
    kw = quantize_kwargs(mode, split)
    ref32 = jax_int8_predictions[mode]
    ref = JaxPredictor(exp16, jparams, batch_size=4, **kw).predict_split(split)
    pred = Predictor(port_config(exp16), from_jax_params(jparams, "cpu"), 4,
                     "cpu", **kw)
    layer = pred.params["bert"]["layers"][0]
    assert layer["wi"]["qweight"].dtype == torch.int8
    assert layer["wi"]["bias"].dtype == torch.float32  # JAX's f32 epilogue
    assert layer["attn_ln"]["scale"].dtype == torch.float32
    out = pred.predict_split(split)
    noise = np.abs(ref - ref32).max()
    assert noise > 0
    err = np.abs(out - ref).max()
    assert err <= BF16_NOISE_FACTOR * noise, (
        f"port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {noise:.3g}")


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_predictor_fuse_qkv_matches_jax(jparams, split, mode, monkeypatch):
    """Predictor(fuse_qkv=True) in f32 against JAX's fused Predictor
    (calibrated on the unfused tree, as JAX does) within 1e-5, and against
    the port's split projections within PRED_ATOL (the int32 products are
    exact and the scales the same).  On the CPU the attention takes the
    plain route, fed the fused product's thirds; with the short route
    forced, the packed attention reads the fused product itself (its plain
    version here; on the card its kernel) and the predictions do not
    move."""
    exp = experiment()
    kw = quantize_kwargs(mode, split)
    ref = JaxPredictor(exp, jparams, batch_size=4, fuse_qkv=True,
                       **kw).predict_split(split)
    params = from_jax_params(jparams, "cpu")
    pred = Predictor(port_config(exp), params, 4, "cpu", fuse_qkv=True, **kw)
    layer = pred.params["bert"]["layers"][0]
    assert "qkv" in layer and "q" not in layer
    assert ("ascale" in layer["qkv"]) == (mode == "int8_static")
    out = pred.predict_split(split)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    split_out = Predictor(port_config(exp), params, 4, "cpu",
                          **kw).predict_split(split)
    np.testing.assert_allclose(out, split_out, atol=PRED_ATOL, rtol=0)
    packed = []
    monkeypatch.setattr(port_bert, "attention_route",
                        lambda use_flash, seq, on_cuda: "short")
    monkeypatch.setattr(port_bert, "packed_attention",
                        lambda *a, **k: packed.append(1) or
                        port_attention.packed_attention(*a, **k))
    np.testing.assert_allclose(pred.predict_split(split), out, atol=PRED_ATOL,
                               rtol=0)
    assert len(packed) == 2 * 2 * 3  # layers x passes x batches


def test_predictor_quantize_arguments(jparams, split):
    exp = port_config(experiment())
    params = from_jax_params(jparams, "cpu")
    with pytest.raises(ValueError, match="calibration"):
        Predictor(exp, params, 4, "cpu", quantize="int8_static")
    with pytest.raises(ValueError, match="unknown quantize"):
        Predictor(exp, params, 4, "cpu", quantize="fp4")


def test_cast_for_compute_leaves_int8_entries_alone(jparams):
    params = tq.quantize_bert_params(
        from_jax_params(jparams, "cpu"),
        act_stats=torch_stats({k: np.ones(2, np.float32) for k in STATS}))
    cast = cast_for_compute(params, torch.bfloat16)
    before, after = params["bert"]["layers"][1]["o"], cast["bert"]["layers"][1]["o"]
    for key in ("qweight", "qscale", "ascale", "bias"):
        assert after[key] is before[key]
    assert cast["bert"]["pooler"]["weight"].dtype == torch.bfloat16
