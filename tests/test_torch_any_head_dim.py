"""Head dims off the presets' 32 and 64, and ln_quant widths off the lane
teams, on the CPU against the JAX package.

JAX's Pallas kernels take any head dim and any width; the port's CUDA
kernels take every integer head dim from 1 to 256 (instantiated at 16, 32,
64, 128 and 256, any other d zero-padded to the next one up) and ln_quant
any H.  These tests hold the port's plain versions -- the oracles the kernels
are held to on the card by chip_smoke.py -- against JAX's kernels in
interpret mode, as JAX's own tests run them, on inputs made from numpy
seeds:

* the short v2 forward (``short_attention_plain``) and its backward rule
  (``short_attention_v1_backward_plain``) against ``jax.vjp`` of
  ``short_attention_v2`` at head dims 8, 16, 26 (TinyBERT-4L-312D's),
  128, 192 (zero-padded onto 256) and 256, S = 12 and 40, on the key-padded inputs of the v2 parity tests
  (test_torch_ops_grad.py): f32 within 1e-5 (forward) and 2e-5 (gradients),
  the v2 parity tests' bounds (the same math in another summation order);
  the bf16 gradients at S = 40 within 2e-3 absolute and 8e-3 relative,
  two bf16 ulps (test_torch_short_attention_v2_bwd.py's bounds);
* flash2's plain forward and fused-backward gradients against JAX's
  flash_attention2 (fused backward) at S = 136, the same head dims:
  JAX's test_flash2.py bounds, 1e-5 and 2e-4;
* ``ln_quant_plain`` against JAX's ``ln_quant`` kernel at H = 32, 100
  (not a multiple of 8) and 104 (a multiple of 8, not of 64), static and
  dynamic: test_quant.py's bounds (h within 1e-6, xi in under 0.5 % of the
  elements by at most one level, the row scale within 1e-5 relative);
* a TinyBERT-shaped tiny MMBert (H = 52, 2 heads of 26, 2 layers): one
  f32 train step against JAX's (losses rtol 1e-5, parameters atol 1e-5,
  test_torch_train.py's bounds) and f32 int8 / int8_static serving
  against JAX's Predictor (2e-6, test_torch_quant.py's PRED_ATOL);
* the widest head dim, a tiny MMBert of H = 512 in 2 heads of 256 (2
  layers): its train step and its int8 serving, the same checks.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import msa_tpu.ops.flash2 as jax_flash2
from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config)
from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.ops import short_attention as jax_sa
from msa_tpu.ops.ln_quant import ln_quant as jax_ln_quant
from msa_tpu.parallel.mesh import make_mesh
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch.configs import ExperimentConfig as PortExperimentConfig
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models import bert as port_bert
from msa_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params, named_leaves)
from msa_tpu_torch.ops import flash2 as F2
from msa_tpu_torch.ops import ln_quant as port_ln_quant
from msa_tpu_torch.ops import quant as port_quant
from msa_tpu_torch.ops import short_attention as sa
from msa_tpu_torch.ops.ln_quant import ln_quant
from msa_tpu_torch.training.trainer import Trainer
from test_torch_ops_grad import attention_inputs

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

HEADS = 2
HEAD_DIMS = (8, 16, 26, 128, 192, 256)
FWD_TOL = 1e-5
GRAD_TOL = 2e-5        # the short v2 parity tests' f32 gradient bound
FLASH_GRAD_TOL = 2e-4  # JAX's test_flash2.py
BF16_TOL = (2e-3, 8e-3)
PRED_ATOL = 2e-6
HEAD_SCALE = 30.0  # spreads the predictions over tanh's linear range
SPECIAL_IDS = (0, 2, 3, 4)
MASK_ID = 4
L, B, VOCAB = 12, 4, 120


# (S, dtype): f32 at both lengths, bf16 at S = 40
V2_CASES = [(12, "float32"), (40, "float32"), (40, "bfloat16")]


@pytest.mark.parametrize("s, dtype", V2_CASES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_short_v2_plain_matches_jax_at_head_dim(monkeypatch, d, s, dtype):
    """The port's short v2 forward and backward rule against JAX's
    short_attention_v2 (interpret mode) at H = 2d: f32 forward and
    gradients, and (S = 40) the bf16 gradients of the rounded rule."""
    monkeypatch.setattr(jax_sa, "_USE_V3_BWD", False)
    q, k, v, dout, bias = attention_inputs(3, s, HEADS * d, seed=d + s)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, dout))
    ref, vjp = jax.vjp(lambda *x: jax_sa.short_attention_v2(
        *x, jnp.asarray(bias), None, HEADS, 0.0, True), jq, jk, jv)
    ref_grads = [np.asarray(g, np.float32) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x, np.float32)).to(tdt)
                       for x in (jq, jk, jv, jdo))
    tbias = torch.from_numpy(bias)
    grads = sa.short_attention_v1_backward_plain(tq, tk, tv, tbias, tdo,
                                                 HEADS)
    if dtype == "float32":
        out = sa.short_attention_plain(tq, tk, tv, tbias, HEADS)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        atol = rtol = GRAD_TOL
    else:
        atol, rtol = BF16_TOL
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert g.dtype == tdt, name
        np.testing.assert_allclose(g.float().numpy(), r, atol=atol, rtol=rtol,
                                   err_msg=f"d={d} {name}")


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash2_plain_matches_jax_at_head_dim(monkeypatch, d):
    """flash2's plain forward and gradients against JAX's flash_attention2
    (interpret mode, the fused backward) at B = 3, S = 136 (one 128-row
    block and a ragged one), H = 2d."""
    monkeypatch.setattr(jax_flash2, "_FUSED_BWD", True)
    q, k, v, dout, bias = attention_inputs(3, 136, HEADS * d, seed=d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref, vjp = jax.vjp(lambda *x: jax_flash2.flash_attention2(
        *x, jnp.asarray(bias), None, HEADS, 0.0, True), jq, jk, jv)
    ref_grads = vjp(jnp.asarray(dout))
    qq, kk, vv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = F2.flash_attention2(qq, kk, vv, torch.from_numpy(bias), HEADS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FWD_TOL, rtol=FWD_TOL)
    grads = torch.autograd.grad(out, (qq, kk, vv), torch.from_numpy(dout))
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=FLASH_GRAD_TOL, rtol=FLASH_GRAD_TOL,
                                   err_msg=f"d={d} {name}")


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("h", [32, 100, 104])
def test_ln_quant_plain_matches_jax_at_width(h, static):
    """ln_quant's plain version (what the CPU runs, and the generic form's
    oracle on the card) against JAX's kernel in interpret mode."""
    rng = np.random.default_rng(h)
    x, r = (rng.standard_normal((3, 7, h)).astype(np.float32)
            for _ in range(2))
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    asc = np.float32(0.05) if static else None
    h_ref, xi_ref, row_ref = jax_ln_quant(
        jnp.asarray(x), jnp.asarray(r),
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, 1e-12,
        ascale=None if asc is None else jnp.asarray(asc), interpret=True)
    got_h, got_xi, got_row = ln_quant(
        torch.from_numpy(x), torch.from_numpy(r),
        {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
        1e-12, None if asc is None else torch.tensor(asc))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h_ref), rtol=1e-6,
                               atol=1e-6)
    xi, want = got_xi.numpy().astype(np.int32), np.asarray(xi_ref, np.int32)
    assert np.mean(xi != want) < 0.005
    assert np.abs(xi - want).max() <= 1
    if static:
        assert got_row is None and row_ref is None
    else:
        np.testing.assert_allclose(got_row.numpy(), np.asarray(row_ref),
                                   rtol=1e-5)


def tinybert_experiment(hidden=52):
    """TinyBERT-4L-312D's head dim (26) at a tiny width: H = 52, 2 heads,
    2 layers, FFN 4H; ``hidden`` = 512 gives 2 heads of 256."""
    bert = dataclasses.replace(
        tiny_bert_config(hidden_size=hidden, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=4 * hidden,
                         vocab_size=VOCAB),
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7, num_labels=1,
                           joint_dropout_prob=0.0),
        data=DataConfig(dataset="mosi", max_seq_length=L),
        train=TrainConfig(compute_dtype="float32", data_parallel=1,
                          train_batch_size=B, learning_rate=1e-3,
                          warmup_proportion=0.0))


def port_config(exp):
    return PortExperimentConfig.from_json(exp.to_json())


def mlm_masks(epoch, bi, batch):
    ids = np.asarray(batch["text_ids"])
    rng = np.random.default_rng(100 + 10 * epoch + bi)
    special = np.isin(ids, SPECIAL_IDS)
    masked = (rng.random((ids.shape[0], 3, ids.shape[1])) < 0.25) & \
        ~special[:, None]
    return {"mlm_masked": masked,
            "mlm_replaced": (rng.random(masked.shape) < 0.8) & masked}


def one_batch():
    """The step's batch with its MLM masks, made anew for each trainer."""
    split = synthetic_split(B, L, 5, 7, vocab_size=VOCAB, seed=3)
    batch = dict(next(iter(JaxDataset(split, seed=1).epoch_batches(0, B))))
    batch.update(mlm_masks(0, 0, batch))
    return batch


def test_tinybert_head_dim_train_step_matches_jax():
    """One f32 train step of the d = 26 tiny MMBert: the port's
    Trainer.train_step against JAX's on the same weights, optimizer state,
    batch and MLM masks."""
    check_train_step(tinybert_experiment(), 26)


def test_head_dim_256_train_step_matches_jax():
    """The same step of the d = 256 tiny MMBert (H = 512, 2 heads)."""
    check_train_step(tinybert_experiment(512), 256)


def check_train_step(exp, head_dim):
    assert exp.model.bert.hidden_size // exp.model.bert.num_attention_heads \
        == head_dim
    jtrainer = JaxTrainer(exp, mesh=make_mesh(1, 1), mask_token_id=MASK_ID,
                          special_ids=SPECIAL_IDS)
    jtrainer.mlm_mask_injector = mlm_masks
    state = jtrainer.init_state(jax.random.key(0), total_steps=1)
    start = jax.device_get((state.params, state.opt_state))
    state, metrics = jtrainer._build_train_step()(
        state, jtrainer._shard_batch(one_batch()), jtrainer.rng(1))
    want = {k: float(v) for k, v in jax.device_get(metrics).items()}
    ref = dict(named_leaves(from_jax_params(jax.device_get(state.params),
                                            "cpu")))

    trainer = Trainer(port_config(exp), "cpu", mask_token_id=MASK_ID,
                      special_ids=SPECIAL_IDS)
    pstate = trainer.init_state(0, 1, params=from_jax_params(start[0], "cpu"))
    pstate.opt_state = from_jax_opt_state(start[1], "cpu")
    pstate, got = trainer.train_step(pstate, one_batch(), base_seed=1)
    for k in ("loss", "mlm_loss", "ap_loss", "label_loss", "nce"):
        assert float(got[k]) == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    for k, v in named_leaves(pstate.params):
        torch.testing.assert_close(v.detach(), ref[k].detach(), atol=1e-5,
                                   rtol=0, msg=k)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_tinybert_head_dim_int8_serving_matches_jax(mode):
    """f32 int8 serving of the d = 26 tiny MMBert (ln_quant at H = 52, off
    the lane teams) on a ragged split against JAX's Predictor."""
    check_int8_serving(tinybert_experiment(), mode)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_head_dim_256_int8_serving_matches_jax(mode):
    """f32 int8 serving of the d = 256 tiny MMBert (H = 512) against JAX's
    Predictor.  A tenth of HEAD_SCALE: at HEAD_SCALE the wider classifier
    input saturates tanh, every prediction within 1e-4 of -1 (a spread
    under 100 PRED_ATOL, where the test sees nothing); at a tenth they
    spread over 1.7e-2, fifty times the d = 26 case's 3.5e-4.  One
    prediction may differ by more than PRED_ATOL only where one int8 code
    sits on a rounding tie that the two frameworks' f32 sums break apart:
    :func:`match_by_one_tie` moves one such code in the port by one level
    and then requires every prediction within PRED_ATOL."""
    check_int8_serving(tinybert_experiment(512), mode, HEAD_SCALE / 10,
                       ties=1)


def check_int8_serving(exp, mode, head_scale=HEAD_SCALE, ties=0):
    params = jax.device_get(init_mmbert_params(jax.random.key(0), exp.model))
    for name in ("classifier1", "classifier2"):
        params["fusion"][name]["kernel"] = (
            np.asarray(params["fusion"][name]["kernel"]) * head_scale)
    split = synthetic_split(10, L, 5, 7, vocab_size=VOCAB, seed=1)
    kwargs = {"quantize": mode,
              "calibration": split if mode == "int8_static" else None}
    ref = JaxPredictor(exp, params, batch_size=4, **kwargs).predict_split(split)
    pred = Predictor(port_config(exp), from_jax_params(params, "cpu"), 4,
                     "cpu", **kwargs)
    out, scaled = quantized_run(pred, split)
    assert out.shape == ref.shape == (10,)
    off = np.flatnonzero(np.abs(out - ref) > PRED_ATOL)
    assert len(off) <= ties, (out, ref)
    if len(off):
        out = match_by_one_tie(pred, split, scaled, int(off[0]), ref)
    np.testing.assert_allclose(out, ref, atol=PRED_ATOL, rtol=0)
    assert np.ptp(ref) > 100 * PRED_ATOL  # the predictions spread


# how near a midpoint between two int8 levels a scaled activation must lie
# to be tried as a tie: the two frameworks' f32 activations agree to ~1e-6
# relative, ~1e-4 at |x / scale| <= 127
TIE_DIST = 1e-3


def quantized_run(pred, split, flip=None):
    """``pred.predict_split(split)`` with every call of the port's
    ``quantize_act`` recorded: returns (predictions, each call's scaled
    activations x / scale in f32).  ``flip`` = (call, flat index): that one
    code rounded to the scaled value's other neighbour, one level away."""
    calls = []
    real = port_quant.quantize_act

    def recorded(x, ascale=None, row_max=None):
        xi, row = real(x, ascale, row_max)
        t = x.float() / row
        if flip is not None and flip[0] == len(calls):
            v = float(t.reshape(-1)[flip[1]])
            code = int(xi.reshape(-1)[flip[1]])
            other = math.floor(v) if code == math.ceil(v) else math.ceil(v)
            assert abs(other - code) == 1
            xi = xi.clone()
            xi.view(-1)[flip[1]] = other
        calls.append(t)
        return xi, row

    with pytest.MonkeyPatch.context() as mp:
        for mod in (port_quant, port_ln_quant, port_bert):
            mp.setattr(mod, "quantize_act", recorded)
        out = pred.predict_split(split)
    return out, calls


def match_by_one_tie(pred, split, scaled, sample, ref, tries=8):
    """The port's predictions with one int8 code of ``sample``'s rows
    moved by one level, where that code's scaled activation lies within
    TIE_DIST of a midpoint: the candidates nearest the midpoint are tried
    in turn, and the first that brings every prediction within PRED_ATOL
    of JAX's is returned (else the unmoved predictions, which then fail)."""
    batch = pred.batch_size
    n_batches = -(-len(ref) // batch)
    per = len(scaled) // n_batches
    assert per * n_batches == len(scaled)
    first = (sample // batch) * per
    found = []
    for c in range(first, first + per):
        t = scaled[c]
        rows = torch.zeros(t.shape[0], dtype=torch.bool)
        rows[sample % batch::batch] = True
        dist = ((t.abs() - t.abs().floor()) - 0.5).abs()
        near = (dist < TIE_DIST) & (t.abs() < 126.5) & \
            rows.reshape(-1, *[1] * (t.dim() - 1))
        for i in torch.nonzero(near.reshape(-1)).flatten().tolist():
            found.append((float(dist.reshape(-1)[i]), c, i))
    out = None
    for _, c, i in sorted(found)[:tries]:
        out, _ = quantized_run(pred, split, flip=(c, i))
        if np.abs(out - ref).max() <= PRED_ATOL:
            return out
    return quantized_run(pred, split)[0] if out is None else out
