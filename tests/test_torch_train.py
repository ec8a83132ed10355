"""msa_tpu_torch's train step on the CPU against the JAX package.

Tiny config (H=128, 2 heads of 64, 2 layers), JAX parameters and optimizer
state carried over by ``from_jax_params`` / ``from_jax_opt_state``, inputs
and MLM masks from numpy seeds, dropout 0 (the two frameworks draw
different random numbers; the dropout rules are tested in
test_torch_ops_grad.py).  JAX runs on the CPU, so its attention is the XLA
path and its joint embedding the unfused one, as its Trainer picks them off
the TPU.

Tolerances, each stated where it is used:
  * f32: what differs is summation order (and f32 vs f64 bias corrections
    in Adam): losses rtol 1e-5, parameters after Adam steps atol 1e-5;
  * bf16: the port's largest error against JAX's bf16 run over the steps
    must stay within BF16_NOISE_FACTOR times JAX's own largest bf16-vs-f32
    gap on the same run -- both round to bf16 at different points (the
    port's MLM logits one more time, its joint projection one less), which
    moves results about as much as the rounding itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec

from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config)
from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.models.mmbert import gathered_mlm_ce as jax_gathered_mlm_ce
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.models.mmbert import mmbert_forward as jax_mmbert_forward
from msa_tpu.models.mmbert import mmbert_loss as jax_mmbert_loss
from msa_tpu.ops import losses as jax_losses
from msa_tpu.parallel.mesh import make_mesh
from msa_tpu.training.optim import decay_mask as jax_decay_mask
from msa_tpu.training.optim import make_optimizer as jax_make_optimizer
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch import configs as port_configs
from msa_tpu_torch.data import MultimodalDataset
from msa_tpu_torch.models.mmbert import gathered_mlm_ce, mlm_cap, mmbert_loss
from msa_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params, named_leaves)
from msa_tpu_torch.ops import losses
from msa_tpu_torch.training.optim import decay_mask, make_optimizer
from msa_tpu_torch.training.trainer import Trainer

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

BF16_NOISE_FACTOR = 3.0
SPECIAL_IDS = (0, 2, 3, 4)  # synthetic_split's tiny-vocab PAD/CLS/SEP + MASK
MASK_ID = 4
L, B, VOCAB = 12, 4, 120


def experiment(compute_dtype="float32", num_labels=1, pair_seq_length=None,
               **train):
    bert = dataclasses.replace(
        tiny_bert_config(hidden_size=128, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=256,
                         vocab_size=VOCAB),
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    train = {"compute_dtype": compute_dtype, "data_parallel": 1,
             "train_batch_size": B, "learning_rate": 1e-3,
             "warmup_proportion": 0.0, **train}
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7,
                           num_labels=num_labels, joint_dropout_prob=0.0),
        data=DataConfig(max_seq_length=L, pair_seq_length=pair_seq_length),
        train=TrainConfig(**train))


def port_experiment(exp):
    """The same experiment as the port's config classes (its own copy)."""
    return port_configs.ExperimentConfig.from_json(exp.to_json())


def tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def mlm_masks(epoch, bi, batch):
    """Host MLM masks shared by both trainers (Trainer.mlm_mask_injector)."""
    ids = np.asarray(batch["text_ids"])
    rng = np.random.default_rng(100 + 10 * epoch + bi)
    special = np.isin(ids, SPECIAL_IDS)
    masked = (rng.random((ids.shape[0], 3, ids.shape[1])) < 0.25) & \
        ~special[:, None]
    return {"mlm_masked": masked,
            "mlm_replaced": (rng.random(masked.shape) < 0.8) & masked}


def batches(n_steps, pair_seq_length=None):
    split = synthetic_split(B * n_steps, L, 5, 7, vocab_size=VOCAB, seed=3,
                            pair_seq_length=pair_seq_length)
    out = []
    for i, batch in enumerate(JaxDataset(split, seed=1).epoch_batches(0, B)):
        batch = dict(batch)
        batch.update(mlm_masks(0, i, batch))
        out.append(batch)
    return out


STEPS = 4


def placed(state, mesh, param_shardings=None):
    """``state`` committed to ``mesh`` as the train step returns it: its
    scalar leaves (the step, the optimizer's counts) replicated, and every
    parameter-shaped subtree (the params, Adam's moments) sharded by
    ``param_shardings`` (None: replicated, as the step returns them on a
    one-device mesh).  Placed otherwise, they are another input type, and
    the step's second call compiles the same program again."""
    replicated = NamedSharding(mesh, PartitionSpec())
    like_params = jax.tree.structure(state.params)

    def place(node):
        if jax.tree.structure(node) == like_params:
            return jax.device_put(node, replicated if param_shardings is None
                                  else param_shardings)
        return jax.device_put(node, replicated) if np.ndim(node) == 0 else node

    return jax.tree.map(place, state, is_leaf=lambda node: jax.tree.structure(
        node) == like_params)


def run_jax(compute_dtype, pair_seq_length=None, **train):
    exp = experiment(compute_dtype, pair_seq_length=pair_seq_length, **train)
    trainer = JaxTrainer(exp, mesh=make_mesh(1, 1), mask_token_id=MASK_ID,
                         special_ids=SPECIAL_IDS)
    trainer.mlm_mask_injector = mlm_masks
    state = placed(trainer.init_state(jax.random.key(0), total_steps=STEPS),
                   trainer.mesh)
    start = (tree_np(state.params), tree_np(state.opt_state))
    step = trainer._build_train_step()
    rng = trainer.rng(1)
    history = []
    for batch in batches(STEPS, pair_seq_length):
        state, metrics = step(state, trainer._shard_batch(batch), rng)
        history.append({k: float(v) for k, v in jax.device_get(metrics).items()})
    return start, history, tree_np(state.params)


@pytest.fixture(scope="module")
def jax_runs():
    return {dt: run_jax(dt) for dt in ("float32", "bfloat16")}


def run_port(compute_dtype, start, pair_seq_length=None, **train):
    params, opt_state = start
    exp = experiment(compute_dtype, pair_seq_length=pair_seq_length, **train)
    trainer = Trainer(port_experiment(exp), "cpu",
                      mask_token_id=MASK_ID, special_ids=SPECIAL_IDS)
    state = trainer.init_state(0, STEPS, params=from_jax_params(params, "cpu"))
    state.opt_state = from_jax_opt_state(opt_state, "cpu")
    history = []
    for batch in batches(STEPS, pair_seq_length):
        state, metrics = trainer.train_step(state, batch, base_seed=1)
        history.append({k: float(v) for k, v in metrics.items()})
    return history, dict(named_leaves(state.params))


def jax_leaves(params):
    return {k: v.detach() for k, v in
            named_leaves(from_jax_params(params, "cpu"))}


METRICS = ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")


def test_train_step_matches_jax_f32(jax_runs):
    """Four f32 steps of the port's Trainer.train_step against JAX's
    Trainer._build_train_step on the same weights, optimizer state, batches
    and MLM masks: per-step losses rtol 1e-5 (summation order); parameters
    after the last step atol 1e-5, 1% of one step's lr = 1e-3 (an Adam
    update g / (|g| + 1e-6) amplifies the gradients' summation-order noise
    where |g| is near 1e-6; measured 2.4e-6, on the CPC heads)."""
    start, ref_hist, ref_params = jax_runs["float32"]
    hist, params = run_port("float32", start)
    for got, want in zip(hist, ref_hist):
        for k in METRICS:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
        assert got["mlm_overflow"] == want["mlm_overflow"] == 0
    ref = jax_leaves(ref_params)
    moved = max(float((ref[k] - v).abs().max())
                for k, v in jax_leaves(start[0]).items())
    assert moved > 1e-4  # the steps really moved the weights
    for k, v in params.items():
        torch.testing.assert_close(v.detach(), ref[k], atol=1e-5, rtol=0,
                                   msg=k)


def test_train_step_frame_level_matches_jax_f32():
    """Frame-level mode (L=12 text tokens, Lp=24 native-rate frames per
    modality: the joint pass runs over 36 tokens, the pair frames carry no
    MLM labels and their padding mask comes from all-zero frames): four f32
    steps against JAX's, with the bounds of the word-aligned test above."""
    start, ref_hist, ref_params = run_jax("float32", pair_seq_length=24)
    hist, params = run_port("float32", start, pair_seq_length=24)
    for got, want in zip(hist, ref_hist):
        for k in METRICS:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
        assert got["mlm_overflow"] == want["mlm_overflow"] == 0
    ref = jax_leaves(ref_params)
    moved = max(float((ref[k] - v).abs().max())
                for k, v in jax_leaves(start[0]).items())
    assert moved > 1e-4
    for k, v in params.items():
        torch.testing.assert_close(v.detach(), ref[k], atol=1e-5, rtol=0,
                                   msg=k)


def test_train_step_matches_jax_bf16(jax_runs):
    """The same four steps in bf16 compute (f32 masters): the joint loss
    over the steps and the final parameters within BF16_NOISE_FACTOR x
    JAX's own bf16-vs-f32 gap (measured ratios ~1.7 and ~1.0)."""
    start, ref_hist, ref_params = jax_runs["bfloat16"]
    _, f32_hist, f32_params = jax_runs["float32"]
    hist, params = run_port("bfloat16", start)
    err = max(abs(g["loss"] - w["loss"]) for g, w in zip(hist, ref_hist))
    noise = max(abs(w["loss"] - e["loss"]) for w, e in zip(ref_hist, f32_hist))
    assert 0 < err <= BF16_NOISE_FACTOR * noise, (
        f"loss: port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {noise:.3g}")
    assert all(g["mlm_overflow"] == 0 for g in hist)
    ref, exact = jax_leaves(ref_params), jax_leaves(f32_params)
    err = max(float((v.detach() - ref[k]).abs().max())
              for k, v in params.items())
    noise = max(float((ref[k] - exact[k]).abs().max()) for k in ref)
    assert 0 < err <= BF16_NOISE_FACTOR * noise, (err, noise)


def jax_pair(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    """cross_entropy (with ignored positions), mse and infonce, f32,
    rtol 1e-6 (the same reductions in another order)."""
    rng = np.random.default_rng(int(weighted))
    logits = rng.standard_normal((4, 6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, size=(4, 6)).astype(np.int32)
    labels[0, :3] = jax_losses.IGNORE_INDEX
    w = np.array([1.0, 0.0, 1.0, 0.5], np.float32) if weighted else None
    preds, targets = (rng.standard_normal(4).astype(np.float32)
                      for _ in range(2))
    x, xp = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    jw, tw = (None, None) if w is None else jax_pair(w)
    cases = [
        (jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jw),
         losses.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), tw)),
        (jax_losses.mse(jnp.asarray(preds), jnp.asarray(targets), jw),
         losses.mse(torch.from_numpy(preds), torch.from_numpy(targets), tw)),
        (jax_losses.infonce(jnp.asarray(x), jnp.asarray(xp), jw),
         losses.infonce(torch.from_numpy(x), torch.from_numpy(xp), tw)),
    ]
    for want, got in cases:
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    # an all-ignored batch is 0, not NaN
    ignored = torch.full((2, 3), losses.IGNORE_INDEX)
    assert float(losses.cross_entropy(torch.zeros(2, 3, 5), ignored)) == 0.0


def loss_inputs(num_labels, seed=0):
    """JAX forward outputs of the tiny model and labels, shared by both
    losses (the port's loss then gets the same outputs as tensors)."""
    exp = experiment(num_labels=num_labels)
    cfg = exp.model
    jparams = init_mmbert_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    b = 3
    ids = rng.integers(5, VOCAB, size=(b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    mask[1, 8:] = 0
    vis = rng.standard_normal((b, L, 5)).astype(np.float32)
    spc = rng.standard_normal((b, L, 7)).astype(np.float32)
    out = jax.device_get(jax.jit(lambda p, *a: jax_mmbert_forward(
        p, *a, cfg, deterministic=True, use_flash="never", mlm_scores=False))(
            jparams, ids, mask, ids, ids, vis, spc))
    labels = [np.where(rng.random((b, L)) < 0.3, ids, -100).astype(np.int32)
              for _ in range(3)]
    ap = [rng.integers(0, 2, size=b).astype(np.int32) for _ in range(2)]
    if cfg.regression:
        sentiment = rng.uniform(-1, 1, size=b).astype(np.float32)
    else:
        sentiment = rng.integers(0, num_labels, size=b).astype(np.int32)
    weights = np.array([1.0, 1.0, 0.0], np.float32)
    return cfg, jparams, out, labels, ap, sentiment, weights


@pytest.mark.parametrize("num_labels", [1, 2, 3])
def test_mmbert_loss_matches_jax(num_labels):
    """Every term of the joint loss (MSE for num_labels 1, CE for 2 and 3;
    the gathered MLM CE; InfoNCE) on the same forward outputs and weights
    (one zero-weight row), f32, rtol 2e-5."""
    cfg, jparams, out, labels, ap, sentiment, weights = loss_inputs(num_labels)
    want = jax.device_get(jax.jit(lambda p, o, *a: jax_mmbert_loss(
        p, o, *a, cfg, weights=weights))(jparams, out, *labels, *ap, sentiment))
    pcfg = port_experiment(experiment(num_labels=num_labels)).model
    got = mmbert_loss(
        from_jax_params(jax.device_get(jparams), "cpu"),
        {k: torch.tensor(np.asarray(v)) for k, v in out.items()},
        *(torch.from_numpy(x).long() for x in labels + ap),
        torch.from_numpy(sentiment) if cfg.regression
        else torch.from_numpy(sentiment).long(),
        pcfg, weights=torch.from_numpy(weights))
    for k in ("loss", "mlm_loss", "text_mlm_loss", "visual_mlm_loss",
              "speech_mlm_loss", "ap_loss", "label_loss", "nce"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=2e-5,
                                              abs=1e-6), k
    assert int(got["mlm_overflow"]) == int(want["mlm_overflow"]) == 0
    np.testing.assert_allclose(got["predictions"].numpy().reshape(-1),
                               np.asarray(want["predictions"]).reshape(-1),
                               rtol=1e-5, atol=1e-6)


def test_gathered_mlm_ce_matches_jax_and_counts_overflow():
    """Under the cap the gathered CE equals JAX's whatever order topk picks
    (rtol 2e-5); over it, both count the same overflow."""
    cfg, jparams, out, labels, _, _, weights = loss_inputs(1, seed=1)
    pparams = from_jax_params(jax.device_get(jparams), "cpu")
    pcfg = port_experiment(experiment()).model
    seq = out["seq_text"]
    cap = mlm_cap(*labels[0].shape)
    want = jax_gathered_mlm_ce(jparams, seq, labels[0], weights, cfg, cap)
    got = gathered_mlm_ce(pparams, torch.from_numpy(np.asarray(seq)),
                          torch.from_numpy(labels[0]).long(),
                          torch.from_numpy(weights), pcfg, cap)
    assert float(got) == pytest.approx(float(want), rel=2e-5)

    every = np.tile(np.arange(5, 5 + L, dtype=np.int32), (3, 1))  # all masked
    jout = jax.device_get(jax.jit(lambda p, o, *a: jax_mmbert_loss(
        p, o, *a, cfg))(jparams, out, every, every, every,
                        np.zeros(3, np.int32), np.zeros(3, np.int32),
                        np.zeros(3, np.float32)))
    pout = mmbert_loss(pparams, {k: torch.tensor(np.asarray(v))
                                 for k, v in out.items()},
                       *(torch.from_numpy(every).long(),) * 3,
                       torch.zeros(3, dtype=torch.long),
                       torch.zeros(3, dtype=torch.long), torch.zeros(3), pcfg)
    assert int(pout["mlm_overflow"]) == int(jout["mlm_overflow"]) > 0


def small_params(seed):
    """The tiny MMBert tree: its names exercise the weight-decay mask."""
    exp = experiment()
    cfg = dataclasses.replace(exp.model, bert=dataclasses.replace(
        exp.model.bert, hidden_size=32, num_attention_heads=1,
        intermediate_size=64, vocab_size=40))
    return jax.device_get(init_mmbert_params(jax.random.key(seed), cfg))


@pytest.mark.parametrize("train,tol", [
    ({}, 1e-6),
    # bf16 moments round to bf16 after each f32 update: a moment that lands
    # on the other side of a bf16 rounding boundary moves its update by
    # ~2^-8 of lr
    ({"adam_mu_dtype": "bfloat16", "adam_nu_dtype": "bfloat16"}, 1e-4),
    ({"max_grad_norm": 0.5}, 1e-6),
    ({"gradient_accumulation_steps": 2}, 1e-6),
], ids=["f32", "bf16_moments", "clip", "accumulate2"])
def test_optimizer_matches_optax(train, tol):
    """The port's AdamW against make_optimizer's optax chain over six
    updates from random numpy gradients (lr 1e-2, warmup then decay, weight
    decay 0.01 masked), parameters atol ``tol`` (f32: summation order and
    the bias corrections' f64 vs f32 powers)."""
    tc = TrainConfig(learning_rate=1e-2, warmup_proportion=0.2, **train)
    params = small_params(0)
    tx = jax_make_optimizer(tc, 6)
    opt = tx.init(params)
    update = jax.jit(tx.update)
    port_params = from_jax_params(params, "cpu")
    port_tx = make_optimizer(port_configs.TrainConfig(
        **dataclasses.asdict(tc)), 6)
    port_opt = port_tx.init(port_params)
    rng = np.random.default_rng(1)
    for _ in range(6):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(np.shape(p)) * 0.1).astype(np.float32),
            params)
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        port_tx.step(port_params, dict(named_leaves(
            from_jax_params(grads, "cpu"))), port_opt)
    ref = jax_leaves(params)
    for k, v in named_leaves(port_params):
        torch.testing.assert_close(v, ref[k], atol=tol, rtol=0, msg=k)


def test_optimizer_resumes_from_jax_state():
    """Two optax updates, then the state carried across by
    from_jax_opt_state (count, bf16 mu/nu, accumulation state): three more
    updates on each side agree (atol 1e-4, the bf16 moments' rounding)."""
    tc = TrainConfig(learning_rate=1e-2, warmup_proportion=0.2,
                     adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                     gradient_accumulation_steps=2)
    params = small_params(1)
    tx = jax_make_optimizer(tc, 6)
    opt = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(2)

    def draw():
        return jax.tree.map(lambda p: (rng.standard_normal(np.shape(p))
                                       * 0.1).astype(np.float32), params)

    for _ in range(3):  # one full update and one accumulated mini-step
        updates, opt = update(draw(), opt, params)
        params = optax.apply_updates(params, updates)
    port_params = from_jax_params(params, "cpu")
    port_opt = from_jax_opt_state(jax.device_get(opt), "cpu")
    assert (port_opt.count, port_opt.mini_step) == (1, 1)
    assert next(iter(named_leaves(port_opt.mu)))[1].dtype == torch.bfloat16
    port_tx = make_optimizer(port_configs.TrainConfig(
        **dataclasses.asdict(tc)), 6)
    for _ in range(3):
        grads = draw()
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        port_tx.step(port_params, dict(named_leaves(
            from_jax_params(grads, "cpu"))), port_opt)
    ref = jax_leaves(params)
    for k, v in named_leaves(port_params):
        torch.testing.assert_close(v, ref[k], atol=1e-4, rtol=0, msg=k)


def test_decay_mask_matches_jax():
    params = small_params(0)
    # JAX's mask has one bool per leaf; spread it over the leaf's shape so
    # the bridge can unstack the layers
    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), m),
                        jax_decay_mask(params), params)
    want = {k: bool(v.all()) for k, v in
            named_leaves(from_jax_params(mask, "cpu"))}
    assert decay_mask(from_jax_params(params, "cpu")) == want
    assert not want["cls/decoder_bias"] and want["bert/embeddings/word"]
    assert not want["bert/layers/0/attn_ln/scale"]


def test_remat_full_reproduces_dropout():
    """With dropout on, checkpointing every layer (policy 'full') gives the
    same losses and parameters as no checkpointing: the recompute reseeds
    each site from the seeds it was given.  f32, atol 1e-6 (the same
    arithmetic, recomputed)."""
    exp = experiment()
    bert = dataclasses.replace(exp.model.bert, hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1)
    exp = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, bert=bert, joint_dropout_prob=0.5))
    runs = []
    for policy in ("full", "auto"):
        e = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, remat_policy=policy))
        trainer = Trainer(port_experiment(e), "cpu", mask_token_id=MASK_ID,
                          special_ids=SPECIAL_IDS)
        # auto on the CPU: no checkpointing
        assert trainer.remat_policy == ("full" if policy == "full" else "none")
        state = trainer.init_state(5, STEPS)
        hist = []
        for batch in batches(2):
            state, metrics = trainer.train_step(state, batch, base_seed=9)
            hist.append(float(metrics["loss"]))
        runs.append((hist, dict(named_leaves(state.params))))
    (h1, p1), (h2, p2) = runs
    assert h1 == pytest.approx(h2, rel=1e-6)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], atol=1e-6, rtol=0, msg=k)
    # and dropout was on: another base seed gives other losses
    trainer = Trainer(port_experiment(exp), "cpu", mask_token_id=MASK_ID,
                      special_ids=SPECIAL_IDS)
    state = trainer.init_state(5, STEPS)
    other = float(trainer.train_step(state, batches(1)[0], base_seed=10)[1]["loss"])
    assert other != pytest.approx(h1[0], rel=1e-6)


@pytest.mark.parametrize("train", [
    {"fused_optimizer": True, "gradient_accumulation_steps": 2},
    {"data_parallel": 2}, {"fuse_text_pass": True}])
def test_trainer_refuses_what_is_not_ported(train):
    """The fused optimizer with gradient accumulation raises JAX's own
    ValueError (make_fused_optimizer), since JAX refuses it too;
    data_parallel=2 in one process raises make_mesh's (the ranks come from
    a process group: test_torch_data_parallel.py).  fuse_text_pass,
    refused until it was ported, is taken (its parity with JAX:
    test_torch_surface.py); tensor and sequence parallelism still raise
    (test_torch_data_parallel.py)."""
    exp = port_experiment(experiment(**train))
    if train.get("fuse_text_pass"):
        trainer = Trainer(exp, "cpu")
        trainer.init_state(0, 4)
        assert trainer.config.train.fuse_text_pass
        return
    error, match = ((ValueError, "gradient accumulation")
                    if train.get("fused_optimizer")
                    else (ValueError, "requested 2 ranks, have 1"))
    with pytest.raises(error, match=match):
        Trainer(exp, "cpu").init_state(0, 4)


def test_eval_epoch_matches_jax():
    """The deterministic eval (no MLM masking, aligned pairs) over a ragged
    split, batch 3: predictions and averaged losses against JAX's
    eval_epoch, f32 atol 1e-5."""
    exp = experiment()
    split = synthetic_split(7, L, 5, 7, vocab_size=VOCAB, seed=8)
    jtrainer = JaxTrainer(exp, mesh=make_mesh(1, 1), mask_token_id=MASK_ID,
                          special_ids=SPECIAL_IDS)
    jstate = jtrainer.init_state(jax.random.key(2), total_steps=4)
    jm, jpreds, jlabels = jtrainer.eval_epoch(
        jstate, JaxDataset(split, seed=0), 0, jtrainer.rng(0), 3)
    trainer = Trainer(port_experiment(exp), "cpu", mask_token_id=MASK_ID,
                      special_ids=SPECIAL_IDS)
    state = trainer.init_state(0, 4, params=from_jax_params(
        tree_np(jstate.params), "cpu"))
    pm, preds, labels = trainer.eval_epoch(
        state, MultimodalDataset(split, seed=0), 0, 0, 3)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(preds, jpreds, atol=1e-5, rtol=0)
    for k, v in jm.averaged().items():
        if k != "samples_per_sec":
            assert pm.averaged()[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
