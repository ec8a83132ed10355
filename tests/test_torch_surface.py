"""msa_tpu_torch's remaining host-side surface against the JAX package:
``fuse_text_pass``, ``Predictor(inflight_batches=...)``,
``TrainConfig.profile_dir`` and ``cli.sweep``.

Tiny config (H=64, 2 heads, 2 layers), f32, dropout 0 where the two
packages are compared (they draw different random numbers), JAX weights
and optimizer state carried over by ``from_jax_params`` /
``from_jax_opt_state``, MLM masks from numpy seeds
(``Trainer.mlm_mask_injector``).  Tolerances as ``test_torch_train.py``'s
f32 case: losses rtol 1e-5, parameters after Adam steps atol 1e-5 (what
differs is summation order); each gradient leaf within 1e-4 of its largest
|value| plus 1e-6 (a bias gradient sums over rows: a large sum next to small
entries; measured ~1e-6 of the leaf's scale); predictions atol 1e-5 (tanh
outputs).
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.cli import sweep as jax_sweep
from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config)
from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.models.mmbert import mmbert_forward as jax_mmbert_forward
from msa_tpu.models.mmbert import mmbert_loss as jax_mmbert_loss
from msa_tpu.ops import masking as jax_masking
from msa_tpu.parallel.mesh import make_mesh
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch import configs as port_configs
from msa_tpu_torch import inference
from msa_tpu_torch.cli import sweep as port_sweep
from msa_tpu_torch.data import MultimodalDataset
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.mmbert import mmbert_forward, mmbert_loss
from msa_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params, init_params, named_leaves)
from msa_tpu_torch.ops import masking
from msa_tpu_torch.training.trainer import Trainer
from test_cli_end_to_end import data_pkl, vocab_file, workdir  # noqa: F401
from test_torch_train import placed

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

SPECIAL_IDS = (0, 2, 3, 4)
MASK_ID = 4
L, B, VOCAB, STEPS = 12, 4, 120, 2
METRICS = ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")


def experiment(pair_seq_length=None, dropout=0.0, speech_dim=7, **train):
    bert = dataclasses.replace(
        tiny_bert_config(hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=128,
                         vocab_size=VOCAB),
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    train = {"compute_dtype": "float32", "data_parallel": 1,
             "train_batch_size": B, "learning_rate": 1e-3,
             "warmup_proportion": 0.0, "fuse_text_pass": True, **train}
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=speech_dim,
                           num_labels=1, joint_dropout_prob=0.0),
        data=DataConfig(max_seq_length=L, pair_seq_length=pair_seq_length),
        train=TrainConfig(**train))


def port(exp):
    return port_configs.ExperimentConfig.from_json(exp.to_json())


def mlm_masks(epoch, bi, batch):
    ids = np.asarray(batch["text_ids"])
    rng = np.random.default_rng(300 + 10 * epoch + bi)
    special = np.isin(ids, SPECIAL_IDS)
    masked = (rng.random((ids.shape[0], 3, ids.shape[1])) < 0.25) & \
        ~special[:, None]
    return {"mlm_masked": masked,
            "mlm_replaced": (rng.random(masked.shape) < 0.8) & masked}


def batches(n):
    split = synthetic_split(B * n, L, 5, 7, vocab_size=VOCAB, seed=4)
    out = []
    for i, batch in enumerate(JaxDataset(split, seed=1).epoch_batches(0, B)):
        batch = dict(batch)
        batch.update(mlm_masks(0, i, batch))
        out.append(batch)
    return out


def tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def leaves(params):
    return {k: v.detach() for k, v in named_leaves(params)}


# ---------------------------------------------------------------------------
# fuse_text_pass
# ---------------------------------------------------------------------------

def test_fuse_text_pass_gradients_match_jax():
    """One [3B, L+L] encoder call: the joint loss and every gradient of the
    port's fused forward against JAX's ``fuse_text_pass=True`` on the same
    weights, batch and MLM masks; and the fused loss against the port's
    unfused one (JAX states the two are equal: the padded text keys are
    masked)."""
    exp = experiment()
    cfg = exp.model
    params = tree_np(init_mmbert_params(jax.random.key(0), cfg))
    batch = batches(1)[0]
    m, r = batch["mlm_masked"], batch["mlm_replaced"]
    views = [jax_masking.apply_mlm_masks(jnp.asarray(batch["text_ids"]),
                                         m[:, i], r[:, i], MASK_ID)
             for i in range(3)]

    def jax_loss(p):
        out = jax_mmbert_forward(
            p, views[0][0], batch["text_mask"], views[1][0], views[2][0],
            batch["visual"], batch["speech"], cfg, mlm_scores=False,
            fuse_text_pass=True)
        return jax_mmbert_loss(p, out, views[0][1], views[1][1], views[2][1],
                               batch["visual_ap"], batch["speech_ap"],
                               batch["target"], cfg,
                               weights=batch["weight"])["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = leaves(from_jax_params(tree_np(want_grads), "cpu"))

    pcfg = port(exp).model
    tree = from_jax_params(params, "cpu")
    paths, ps = zip(*named_leaves(tree))
    for p in ps:
        p.requires_grad_()
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    ids = t["text_ids"].long()
    pv = [masking.apply_mlm_masks(ids, t["mlm_masked"][:, i],
                                  t["mlm_replaced"][:, i], MASK_ID)
          for i in range(3)]

    def port_loss(fuse):
        out = mmbert_forward(tree, pv[0][0], t["text_mask"], pv[1][0],
                             pv[2][0], t["visual"], t["speech"], pcfg,
                             fuse_text_pass=fuse)
        return mmbert_loss(tree, out, pv[0][1], pv[1][1], pv[2][1],
                           t["visual_ap"].long(), t["speech_ap"].long(),
                           t["target"], pcfg, weights=t["weight"])["loss"]

    loss = port_loss(True)
    grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                materialize_grads=True)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(port_loss(False).detach()) == pytest.approx(
        float(loss.detach()), rel=1e-5)
    assert max(float(g.abs().max()) for g in grads) > 1e-3
    for k, g in zip(paths, grads):
        gap, scale = float((g - want[k]).abs().max()), float(want[k].abs().max())
        assert gap <= 1e-6 + 1e-4 * scale, (k, gap, scale)


def test_fuse_text_pass_train_steps_match_jax():
    """Two f32 steps of the port's Trainer with ``fuse_text_pass`` against
    JAX's Trainer with the flag, from the same weights, optimizer state,
    batches and MLM masks: per-step losses and every parameter after."""
    exp = experiment()
    jt = JaxTrainer(exp, mesh=make_mesh(1, 1), mask_token_id=MASK_ID,
                    special_ids=SPECIAL_IDS)
    jt.mlm_mask_injector = mlm_masks
    state = placed(jt.init_state(jax.random.key(0), total_steps=STEPS), jt.mesh)
    start = (tree_np(state.params), tree_np(state.opt_state))
    step = jt._build_train_step()
    ref = []
    for batch in batches(STEPS):
        state, m = step(state, jt._shard_batch(batch), jt.rng(1))
        ref.append({k: float(v) for k, v in jax.device_get(m).items()})

    trainer = Trainer(port(exp), "cpu", mask_token_id=MASK_ID,
                      special_ids=SPECIAL_IDS)
    ps = trainer.init_state(0, STEPS, params=from_jax_params(start[0], "cpu"))
    ps.opt_state = from_jax_opt_state(start[1], "cpu")
    for batch, want in zip(batches(STEPS), ref):
        ps, m = trainer.train_step(ps, batch, base_seed=1)
        for k in METRICS:
            assert float(m[k]) == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
        assert int(m["mlm_overflow"]) == want["mlm_overflow"] == 0
    want = leaves(from_jax_params(tree_np(state.params), "cpu"))
    for k, v in named_leaves(ps.params):
        torch.testing.assert_close(v.detach(), want[k], atol=1e-5, rtol=0,
                                   msg=k)


@pytest.mark.parametrize("lp", [None, 24])
def test_fuse_text_pass_predictor_matches_jax(lp):
    """The Predictor honours the flag (one [3B, L+Lp] call): word-aligned
    and frame-level (Lp=24) predictions against JAX's Predictor with it."""
    exp = experiment(pair_seq_length=lp)
    params = init_mmbert_params(jax.random.key(1), exp.model)
    split = synthetic_split(10, L, 5, 7, vocab_size=VOCAB, seed=5,
                            pair_seq_length=lp)
    want = JaxPredictor(exp, params, 4).predict_split(split)
    got = Predictor(port(exp), from_jax_params(tree_np(params), "cpu"), 4,
                    "cpu").predict_split(split)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fuse_text_pass_dropout_masks_are_distinct_per_view_and_rank():
    """With dropout in the one fused call, two views fed identical inputs
    (speech == visual, Ws == Wv) come out different: each row of the
    [3B, S] call draws its own masks.  Deterministic, they are equal.  A
    data-parallel shard moves every seed (JAX's seed + shard * 1000003)."""
    exp = port(experiment(dropout=0.1, speech_dim=5))
    cfg = exp.model
    params = init_params(cfg, torch.Generator().manual_seed(0))
    params["joint"]["Ws"] = params["joint"]["Wv"]
    split = synthetic_split(B, L, 5, 5, vocab_size=VOCAB, seed=6)
    ids = torch.as_tensor(split.input_ids).long()
    mask = torch.as_tensor(split.attention_mask)
    feats = torch.as_tensor(split.visual)

    def joint(shard=0, deterministic=False):
        return mmbert_forward(
            params, ids, mask, ids, ids, feats, feats, cfg,
            deterministic=deterministic, generator=torch.Generator(
            ).manual_seed(7), fuse_text_pass=True, shard=shard)["seq_joint"]

    same = joint(deterministic=True)
    torch.testing.assert_close(same[:B], same[B:], atol=0, rtol=0)
    drop = joint()
    assert float((drop[:B] - drop[B:]).abs().max()) > 1e-2
    assert float((joint(shard=1) - drop).abs().max()) > 1e-2
    torch.testing.assert_close(joint(), drop, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# inflight_batches
# ---------------------------------------------------------------------------

def test_predict_bounded_inflight_window(monkeypatch):
    """``predict_arrays`` fetches the oldest half of the window each time
    ``inflight_batches`` batches are outstanding (tests/test_inference.py's
    case: 7 batches at window 3 -> fetches of 1, 1, 1, 1, 1, 2), with
    predictions identical to ``inflight_batches=1``."""
    exp = port(experiment(fuse_text_pass=False))
    params = init_params(exp.model, torch.Generator().manual_seed(0))
    split = synthetic_split(14, L, 5, 7, vocab_size=VOCAB, seed=1)
    fetches = []
    real = inference._fetch
    monkeypatch.setattr(inference, "_fetch",
                        lambda xs: fetches.append(len(xs)) or real(xs))
    base = Predictor(exp, params, 2, "cpu", inflight_batches=1).predict_split(split)
    assert fetches == [1] * 7
    fetches.clear()
    out = Predictor(exp, params, 2, "cpu", inflight_batches=3).predict_split(split)
    np.testing.assert_array_equal(out, base)
    assert fetches == [1, 1, 1, 1, 1, 2]


# ---------------------------------------------------------------------------
# profile_dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,stop,n_batches", [(1, 3, 4), (1, 10, 3)])
def test_profile_dir_traces_the_window(tmp_path, start, stop, n_batches):
    """``TrainConfig.profile_dir``: ``torch.profiler`` traces train steps
    [profile_start, profile_stop) of epoch 0 into the directory (one
    TensorBoard trace file); an epoch that ends inside the window stops the
    trace there; epoch 1 writes nothing."""
    d = str(tmp_path / "trace")
    exp = port(experiment(fuse_text_pass=False, profile_dir=d,
                          profile_start=start, profile_stop=stop))
    trainer = Trainer(exp, "cpu", mask_token_id=MASK_ID,
                      special_ids=SPECIAL_IDS)
    state = trainer.init_state(0, 10)
    ds = MultimodalDataset(synthetic_split(B * n_batches, L, 5, 7,
                                           vocab_size=VOCAB, seed=2), seed=0)
    state, em = trainer.train_epoch(state, ds, 0, base_seed=1)
    assert em.steps == n_batches
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        trace = json.load(f)
    steps = {e["name"] for e in trace["traceEvents"]
             if e.get("name", "").startswith("ProfilerStep#")}
    assert len(steps) == min(stop, n_batches) - start, steps
    trainer.train_epoch(state, ds, 1, base_seed=1)
    assert len(glob.glob(os.path.join(d, "*.pt.trace.json"))) == 1


# ---------------------------------------------------------------------------
# cli.sweep
# ---------------------------------------------------------------------------

def test_sweep_writes_jax_rows(workdir, vocab_file, data_pkl,  # noqa: F811
                               tmp_path, monkeypatch):
    """A 2x1 (alpha, beta) grid of one-epoch cli.train runs on the pickle
    fixture: the port's JSONL rows are those JAX's sweep writes for the same
    cells and fit results (JAX's ``cli.train.main`` stood in by the port's
    results), and every cell passes the same argv."""
    monkeypatch.chdir(tmp_path)
    argv = ["--alphas", "0.1,0.5", "--betas", "0.3", "--model", "tiny",
            "--dataset", "mosi",
            "--data_pkl", data_pkl, "--vocab", vocab_file, "--n_epochs", "1",
            "--train_batch_size", "8", "--device", "cpu", "--compute_dtype",
            "float32", "--checkpoint_root", str(tmp_path / "ms"),
            "--numpy_root", str(tmp_path / "ns")]
    import msa_tpu.cli.train as jax_train
    import msa_tpu_torch.cli.train as port_train

    cells, results = [], []
    real = port_train.main

    def record(cell_argv):
        cells.append(cell_argv)
        results.append(real(cell_argv))
        return results[-1]

    monkeypatch.setattr(port_train, "main", record)
    rows = port_sweep.main(argv + ["--out", "port.jsonl"])
    assert [(r["alpha"], r["beta"]) for r in rows] == [(0.1, 0.3), (0.5, 0.3)]

    jax_cells = []
    replay = iter(results)
    monkeypatch.setattr(jax_train, "main",
                        lambda a: jax_cells.append(a) or next(replay))
    jax_rows = jax_sweep.main(argv + ["--out", "jax.jsonl"])
    assert rows == jax_rows and cells == jax_cells
    with open("port.jsonl") as f, open("jax.jsonl") as g:
        assert f.read() == g.read()
    for spec in ("0.1:1.0:10", "0.3,0.5", "0:1:3"):
        assert port_sweep.parse_grid(spec) == jax_sweep.parse_grid(spec)
