"""msa_tpu_torch's tensor and sequence parallelism against the JAX package.

Four gloo processes on the CPU (one spawn; the workers import only the
port) form a ``data_parallel=2 x model_parallel=2`` grid of ranks and run
the port's ``Trainer``, ``Predictor`` and ``cli.train`` on JAX's tiny
sequence-parallel model (``tests/test_seq_parallel.py``: H=32, 2 layers, 4
heads, FFN 64, vocab 120, f32), while this process runs the JAX package
at ``dp=2, mp=2`` on its fake CPU devices:

  (a) train steps at dropout 0 (two: the schedule's first has learning
      rate 0), tensor parallelism with and without sequence parallelism,
      against JAX's: every loss term rel 1e-5, every gathered parameter
      atol = rtol = 1e-5;
  (b) sequence parallelism against tensor parallelism at dropout 0.1 in
      the port (JAX's CPU masks are not the port's), same tolerances;
  (c) the replicated leaves and the encoder's output stream bit-equal on
      the two model ranks of each data row after those steps;
  (d) eval predictions and the Predictor in bf16, int8 and int8_static
      against JAX's at ``mp=2``, with ``tests/test_torch_quant.py``'s
      tolerances;
  (e) the frame-level pair (L=16, Lp=17: S=33, not a multiple of mp) under
      tensor + sequence parallelism against JAX's plain (one-device) steps,
      as ``test_frame_level_with_tp_and_sp`` holds JAX's own;
  (f) ``cli.train --dp 2 --mp 2``: two epochs, ``--resume`` bit-equal, the
      checkpoint (the gathered full state) read alike by the one-process
      port and by JAX's ``load_checkpoint``, and ``cli.sample --dp 2 --mp
      2`` on it against the one-process ``cli.sample``;
  (g) every remat policy under tensor + sequence parallelism at dropout 0.1
      against no checkpointing, in the port.

The steps clip at a global norm of 1.0 and log it, so the norm over the
model group (split leaves summed, replicated ones once) is held to JAX's.

Without a spawn: the split rule against JAX's ``param_specs`` for every
leaf (f32 and int8 trees), the shard / gather round trip, the vocabulary-
parallel cross entropy in two threads against the full one, the
divisibility errors and the ``fuse_qkv`` refusal.
"""

import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config)
from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.ops import quant as jq
from msa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from msa_tpu.parallel.sharding import param_shardings, param_specs
from msa_tpu.training import checkpoint as jax_ckpt
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch import configs as port_configs
from msa_tpu_torch.cli import sample as port_sample
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.weights import from_jax_params, named_leaves
from msa_tpu_torch.ops import losses
from msa_tpu_torch.ops import quant as tq
from msa_tpu_torch.parallel import sharding
from msa_tpu_torch.parallel.mesh import make_mesh
from msa_tpu_torch.training import checkpoint as ckpt
from test_torch_data_parallel import REPO, _free_port, port_split
from test_torch_train import placed

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

L, LP, B, VOCAB = 16, 17, 8, 120
EVAL_BATCH, EVAL_N = 4, 7
SERVE_BATCH, SERVE_N = 4, 10
RATE = 0.1
# every remat base under tensor + sequence parallelism (save_pack acts as
# save_attn there, as JAX's head-parallel attention takes no packed entry)
REMAT = ("full", "full+drop", "dots", "save_small", "save_wide",
         "save_attn+drop", "save_ctx", "save_pack")
METRICS = ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")
TOL = 1e-5
# tests/test_torch_quant.py's
PRED_ATOL = 2e-6
BF16_NOISE_FACTOR = 3.0
HEAD_SCALE = 300.0  # at H = 32 the heads need 10x test_torch_quant.py's


def experiment(dp=2, mp=2, sp=False, dropout=0.0, lp=None,
               compute_dtype="float32", remat_policy=None):
    bert = dataclasses.replace(
        tiny_bert_config(hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         vocab_size=VOCAB),
        hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7,
                           num_labels=1, joint_dropout_prob=dropout),
        data=DataConfig(max_seq_length=L, pair_seq_length=lp),
        train=TrainConfig(compute_dtype=compute_dtype, data_parallel=dp,
                          model_parallel=mp, sequence_parallel=sp,
                          train_batch_size=B, learning_rate=1e-3,
                          warmup_proportion=0.0, max_grad_norm=1.0,
                          log_grad_norm=True,
                          remat=remat_policy is not None,
                          remat_policy=remat_policy or "auto"))


def masks(batch, seed):
    """MLM masks for every view (applied by both trainers)."""
    ids = np.asarray(batch["text_ids"])
    rng = np.random.default_rng(seed)
    special = np.isin(ids, (0, 2, 3, 4))
    masked = (rng.random((ids.shape[0], 3, ids.shape[1])) < 0.3) & \
        ~special[:, None]
    return {"mlm_masked": masked,
            "mlm_replaced": (rng.random(masked.shape) < 0.8) & masked}


def train_batches(lp=None):
    """Two steps' batches: the schedule's first step has learning rate 0
    (warmup from 0, as JAX's), so the second moves the parameters."""
    split = synthetic_split(2 * B, L, 5, 7, vocab_size=VOCAB, seed=3,
                            pair_seq_length=lp)
    out = []
    for i, batch in enumerate(JaxDataset(split, seed=1).epoch_batches(0, B)):
        batch = dict(batch)
        batch.update(masks(batch, 10 * i + (7 if lp is None else 8)))
        out.append(batch)
    return out


def serve_params(params):
    """Predictions spread over tanh's linear range (test_torch_quant.py)."""
    out = jax.tree.map(np.asarray, params)
    for name in ("classifier1", "classifier2"):
        out["fusion"][name]["kernel"] = out["fusion"][name]["kernel"] * \
            HEAD_SCALE
    return out


def tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


WORKER = r"""
import hashlib, os, pickle, sys
for name in ("jax", "msa_tpu"):
    sys.modules[name] = None  # the workers run the port alone
import torch
torch.set_num_threads(1)
from msa_tpu_torch import configs
from msa_tpu_torch.cli import sample as cli_sample
from msa_tpu_torch.cli import train as cli_train
from msa_tpu_torch.data import MultimodalDataset
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.mmbert import mmbert_forward
from msa_tpu_torch.models.weights import cast_for_compute, named_leaves
from msa_tpu_torch.parallel import distributed, sharding
from msa_tpu_torch.training.checkpoint import epoch_dir
from msa_tpu_torch.training.trainer import Trainer

rank, work = int(os.environ["PROC_ID"]), os.environ["WORK"]
distributed.initialize(f"127.0.0.1:{os.environ['PORT']}", 4, rank,
                       device="cpu")
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
MASK = dict(mask_token_id=4, special_ids=(0, 2, 3, 4))


def leaves(tree):
    return {k: v.detach().clone() for k, v in named_leaves(tree)}


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def trainer_of(name):
    return Trainer(configs.ExperimentConfig.from_json(inp["exp"][name]),
                   "cpu", **MASK)


out = {}
for name, batch in inp["steps"]:
    trainer = trainer_of(name)
    state = trainer.init_state(0, 2, params=inp["params"])
    hist = []
    for b in inp[batch]:
        state, m = trainer.train_step(state, b, base_seed=1)
        hist.append({k: float(v) for k, v in m.items()})
    run = {"metrics": hist,
           "params": leaves(trainer.full_state(state).params),
           "shard": [trainer.dp.index, trainer.mp.index, trainer.mp.size,
                     trainer.mp.sequence_parallel]}
    if name in ("tp_drop", "sp_drop"):  # (c): what every rank holds alike
        local = leaves(state.params)
        run["replicated"] = digest(v for k, v in sorted(local.items())
                                   if sharding.split_dim(k) is None)
        b = trainer.upload(inp[batch][-1])
        rows = slice(trainer.dp.index * 4, trainer.dp.index * 4 + 4)
        ids = b["text_ids"][rows]
        with torch.no_grad():
            fwd = mmbert_forward(
                cast_for_compute(state.params, torch.float32), ids,
                b["text_mask"][rows], ids, ids, b["visual"][rows],
                b["speech"][rows], trainer.config.model, mp=trainer.mp)
        run["stream"] = digest([fwd["seq_text"], fwd["seq_joint"]])
    out[name] = run

# (d) eval and serving from the start parameters
for name in ("tp", "sp"):
    trainer = trainer_of(name)
    state = trainer.init_state(0, 2, params=inp["params"])
    em, preds, _ = trainer.eval_epoch(
        state, MultimodalDataset(inp["eval_split"], seed=2), 0, 1, 4)
    out[name]["eval"] = (em.averaged(), preds)
out["serve"] = {}
for mode, name in (("bf16", "tp_bf16"), ("int8", "tp"), ("int8_static", "tp"),
                   ("int8_sp", "sp")):
    quantize = None if mode == "bf16" else mode.replace("_sp", "")
    pred = Predictor(configs.ExperimentConfig.from_json(inp["exp"][name]),
                     inp["serve_params"], 4, "cpu", quantize=quantize,
                     calibration=inp["serve"])
    out["serve"][mode] = pred.predict_split(inp["serve"])

# (f) cli.train --dp 2 --mp 2: two epochs, then --resume from the first
os.chdir(work)
argv = ["--model", "tiny", "--dataset", "mosi", "--synthetic", "16",
        "--n_epochs", "2", "--train_batch_size", "4", "--val_batch_size", "4",
        "--test_batch_size", "4", "--compute_dtype", "float32",
        "--checkpoint_root", os.path.join(work, "model_save"),
        "--numpy_root", os.path.join(work, "numpy_save"), "--device", "cpu",
        "--dp", "2", "--mp", "2",
        "--coordinator", f"127.0.0.1:{os.environ['PORT']}",
        "--num_processes", "4", "--process_id", str(rank)]
trainer, full, result = cli_train.run(cli_train.build_parser().parse_args(argv))
run = os.path.join(work, "model_save",
                   sorted(os.listdir(os.path.join(work, "model_save")))[0])
_, resumed, _ = cli_train.run(cli_train.build_parser().parse_args(
    argv + ["--resume", epoch_dir(run, 0)]))
out["cli"] = {"steps": (full.step, resumed.step), "run": run,
              "mesh": trainer.mesh.shape, "history": len(result.history),
              "epochs": sorted(os.listdir(run)),
              "full": leaves(trainer.full_state(full).params),
              "resumed": leaves(trainer.full_state(resumed).params),
              "sample": cli_sample.main([
                  "--checkpoint", run, "--synthetic", "8", "--batch_size",
                  "4", "--dp", "2", "--mp", "2", "--device", "cpu"])}
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
"""


def spawn(work):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), WORK=str(work),
               PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, "-c", WORKER],
                             env=dict(env, PROC_ID=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(4)]


def collect(procs, work, timeout=300):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


def run_jax(params, batch, frame_batch, eval_split, serve, sparams):
    """JAX's dp=2 x mp=2 steps (word-aligned), its one-device frame-level
    steps, and its dp=2 x mp=2 eval epoch and predictions."""
    mesh = jax_make_mesh(2, 2)
    out = {}
    one = jax_make_mesh(1, 1, devices=jax.devices()[:1])
    for name, exp, b, m in (("tp", experiment(), batch, mesh),
                            ("frame_sp", experiment(1, 1, lp=LP),
                             frame_batch, one)):
        trainer = JaxTrainer(exp, mesh=m, mask_token_id=4,
                             special_ids=(0, 2, 3, 4))
        trainer.mlm_mask_injector = lambda e, i, bb: {}
        state = trainer.init_state(jax.random.key(0), total_steps=2)
        state = placed(state.replace(params=params), m,
                       param_shardings(params, m) if m is mesh else None)
        step, hist = trainer._build_train_step(), []
        for batch in b:
            state, m = step(state, trainer._shard_batch(batch), trainer.rng(1))
            hist.append({k: float(v) for k, v in jax.device_get(m).items()})
        out[name] = {"params": tree_np(state.params), "metrics": hist}
    trainer = JaxTrainer(experiment(), mesh=mesh, mask_token_id=4,
                         special_ids=(0, 2, 3, 4))
    state = trainer.init_state(jax.random.key(0), total_steps=2)
    state = state.replace(params=jax.device_put(
        params, param_shardings(params, mesh)))
    em, preds, _ = trainer.eval_epoch(state, JaxDataset(eval_split, seed=2),
                                      0, trainer.rng(1), EVAL_BATCH)
    out["eval"] = (em.averaged(), preds)
    out["serve"] = {
        mode: JaxPredictor(experiment(compute_dtype=dtype), sparams,
                           SERVE_BATCH, mesh=mesh, quantize=quantize,
                           calibration=serve).predict_split(serve)
        for mode, dtype, quantize in (
            ("f32", "float32", None), ("bf16", "bfloat16", None),
            ("int8", "float32", "int8"),
            ("int8_static", "float32", "int8_static"))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers run while JAX computes its references."""
    work = tmp_path_factory.mktemp("tp")
    params = tree_np(init_mmbert_params(jax.random.key(0), experiment().model))
    sparams = serve_params(params)
    batch, frame_batch = train_batches(), train_batches(LP)
    eval_split = synthetic_split(EVAL_N, L, 5, 7, vocab_size=VOCAB, seed=8)
    serve = synthetic_split(SERVE_N, L, 5, 7, vocab_size=VOCAB, seed=9)
    exps = {"tp": experiment(), "sp": experiment(sp=True),
            "tp_drop": experiment(dropout=RATE),
            "sp_drop": experiment(sp=True, dropout=RATE),
            "frame_sp": experiment(sp=True, lp=LP),
            "tp_bf16": experiment(compute_dtype="bfloat16"),
            **{f"sp_drop {p}": experiment(sp=True, dropout=RATE,
                                          remat_policy=p) for p in REMAT}}
    steps = [(k, "frame_batch" if k == "frame_sp" else "batch")
             for k in exps if k != "tp_bf16"]
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"exp": {k: e.to_json() for k, e in exps.items()},
                     "steps": steps,
                     "params": from_jax_params(params, "cpu"),
                     "serve_params": from_jax_params(sparams, "cpu"),
                     "batch": batch, "frame_batch": frame_batch,
                     "eval_split": port_split(eval_split),
                     "serve": port_split(serve)}, f)
    procs = spawn(work)
    try:
        ref = run_jax(params, batch, frame_batch, eval_split, serve, sparams)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ref["params"] = params
    return ref, collect(procs, work), work


def port_tree(tree):
    return {k: v.detach() for k, v in named_leaves(from_jax_params(tree,
                                                                   "cpu"))}


def check_metrics(got, want):
    """Both steps' loss terms and the global gradient norm (before the
    clip at 1.0; over the model group, replicated leaves counted once)."""
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in METRICS + ("grad_norm",):
            assert g[k] == pytest.approx(w[k], rel=TOL, abs=1e-6), k
        assert g["mlm_overflow"] == w["mlm_overflow"] == 0


def check_params(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=TOL, rtol=TOL, msg=k)


@pytest.mark.parametrize("name", ["tp", "sp"])
def test_train_step_matches_jax(runs, name):
    """(a) Two steps at dp=2 x mp=2 from JAX's initial parameters: every
    loss term and, gathered from the shards, every updated parameter
    against JAX's dp=2, mp=2 steps; the same on all four ranks."""
    ref, outs, _ = runs
    want = port_tree(ref["tp"]["params"])
    moved = max(float((want[k] - v).abs().max())
                for k, v in port_tree(ref["params"]).items())
    assert moved > 1e-4
    for r, out in enumerate(outs):
        run = out[name]
        assert run["shard"] == [r // 2, r % 2, 2, name == "sp"]
        check_metrics(run["metrics"], ref["tp"]["metrics"])
        check_params(run["params"], want)


def test_sequence_parallel_matches_tensor_parallel_with_dropout(runs):
    """(b) At dropout 0.1 (hidden, attention, joint) the sequence-parallel
    step equals the tensor-parallel one: each hidden mask is the shard's
    rows of the mask drawn over the whole sequence, and the attention
    seeds move by m + mp * d in both."""
    _, outs, _ = runs
    for out in outs:
        tp, sp = out["tp_drop"], out["sp_drop"]
        check_metrics(sp["metrics"], tp["metrics"])
        check_params(sp["params"], tp["params"])
        # dropout did act: the steps moved off the rate-0 ones
        assert abs(tp["metrics"][0]["loss"] -
                   out["tp"]["metrics"][0]["loss"]) > 1e-4


@pytest.mark.parametrize("policy", REMAT)
def test_remat_policies_under_sequence_parallelism(runs, policy):
    """(g) Each remat policy under tensor + sequence parallelism at dropout
    0.1 against the steps without checkpointing: its regions recompute
    through the same collectives (and draw the same masks), so the losses
    and the gathered parameters agree."""
    _, outs, _ = runs
    for out in outs:
        run = out[f"sp_drop {policy}"]
        assert run["shard"][3] is True
        check_metrics(run["metrics"], out["sp_drop"]["metrics"])
        check_params(run["params"], out["sp_drop"]["params"])


def test_residual_stream_equal_on_model_ranks(runs):
    """(c) After the dropout steps, the two model ranks of each data row hold
    bit-equal replicated leaves and compute a bit-equal encoder stream
    (each rank's hidden masks are the replicated stream's, never its own);
    the two data rows differ."""
    _, outs, _ = runs
    for name in ("tp_drop", "sp_drop"):
        for d in (0, 2):
            a, b = outs[d][name], outs[d + 1][name]
            assert a["replicated"] == b["replicated"], (name, d)
            assert a["stream"] == b["stream"], (name, d)
        assert outs[0][name]["stream"] != outs[2][name]["stream"]


def test_eval_and_predictor_match_jax(runs):
    """(d) eval_epoch (7 rows at batch 4, padded per data rank) under tensor
    and sequence parallelism, and the Predictor at dp=2 x mp=2 on a ragged
    split: f32 int8 and int8_static (also under sequence parallelism)
    within PRED_ATOL of JAX's mp=2 Predictor, bf16 within
    BF16_NOISE_FACTOR times JAX's own bf16-vs-f32 gap; every rank returns
    the same whole array."""
    ref, outs, _ = runs
    for out in outs:
        for name in ("tp", "sp"):
            em, preds = out[name]["eval"]
            assert preds.shape == ref["eval"][1].shape == (EVAL_N, 1)
            np.testing.assert_allclose(preds, ref["eval"][1], atol=1e-5,
                                       rtol=0)
            for k in METRICS:
                assert em[k] == pytest.approx(ref["eval"][0][k], rel=TOL,
                                              abs=1e-6), k
        serve = out["serve"]
        for mode in ("int8", "int8_static"):
            assert serve[mode].shape == (SERVE_N,)
            np.testing.assert_allclose(serve[mode], ref["serve"][mode],
                                       atol=PRED_ATOL, rtol=0)
        np.testing.assert_allclose(serve["int8_sp"], ref["serve"]["int8"],
                                   atol=PRED_ATOL, rtol=0)
        assert np.abs(serve["int8"] - ref["serve"]["f32"]).max() > \
            10 * PRED_ATOL  # it did quantize
        noise = np.abs(ref["serve"]["bf16"] - ref["serve"]["f32"]).max()
        assert noise > 0
        assert np.abs(serve["bf16"] - ref["serve"]["bf16"]).max() <= \
            BF16_NOISE_FACTOR * noise
        for mode, preds in serve.items():
            np.testing.assert_array_equal(preds, outs[0]["serve"][mode])


def test_frame_level_with_tp_and_sp(runs):
    """(e) Frame level, L=16 + Lp=17 (S=33 rows over mp=2: the stream's
    shards are padded to 17 rows and the padding dropped on the gather),
    tensor + sequence parallelism at dp=2: the steps' losses and gathered
    parameters against JAX's plain frame-level steps on one device (JAX's
    own test holds its sequence-parallel step to the plain one)."""
    ref, outs, _ = runs
    for out in outs:
        check_metrics(out["frame_sp"]["metrics"], ref["frame_sp"]["metrics"])
        check_params(out["frame_sp"]["params"],
                     port_tree(ref["frame_sp"]["params"]))


def test_cli_dp_mp_checkpoint_resume_and_load(runs):
    """(f) cli.train --dp 2 --mp 2 over four ranks: two epochs on a 2 x 2
    mesh, --resume from the first epoch's checkpoint ends on the
    uninterrupted run's parameters bit for bit on every rank, and that
    checkpoint (the gathered full state, rank 0 wrote it) loads into the
    one-process port and into JAX's load_checkpoint with equal values;
    cli.sample --dp 2 --mp 2 scores the run as one process does."""
    _, outs, _ = runs
    cli = outs[0]["cli"]
    assert cli["mesh"] == {"data": 2, "model": 2}
    assert cli["history"] == 2 and cli["steps"] == (8, 8)
    assert "epoch_000" in cli["epochs"]
    for out in outs:
        for k, v in cli["full"].items():
            assert torch.equal(v, out["cli"]["resumed"][k]), k
            assert torch.equal(v, out["cli"]["full"][k]), k
    directory = ckpt.epoch_dir(cli["run"], 0)
    state, meta = ckpt.load_checkpoint(directory, "cpu")
    assert meta["epoch"] == 0 and state.step == 4
    exp = ckpt.load_config(directory)
    word = state.params["bert"]["embeddings"]["word"]
    assert word.shape == (exp.model.bert.padded_vocab_size, 64)  # whole
    jexp = ExperimentConfig.from_json(exp.to_json())
    template = JaxTrainer(jexp, mesh=jax_make_mesh(1, 1, devices=jax.devices()[:1])
                          ).init_state(jax.random.key(0), 8)
    loaded, _ = jax_ckpt.load_checkpoint(directory, template)
    jax_tree = port_tree(tree_np(loaded.params))
    for k, v in named_leaves(state.params):
        assert torch.equal(v, jax_tree[k]), k
    assert int(loaded.step) == state.step
    # cli.sample at dp=2 x mp=2 (every rank the whole split) against one
    # process on the same (newest) checkpoint
    preds, labels = port_sample.main([
        "--checkpoint", cli["run"], "--synthetic", "8", "--batch_size", "4",
        "--device", "cpu"])
    for out in outs:
        got, got_labels = out["cli"]["sample"]
        assert got.shape == preds.shape == (8, 1)
        np.testing.assert_array_equal(got_labels, labels)
        np.testing.assert_allclose(got, preds, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# In-process pieces
# ---------------------------------------------------------------------------

def _port_paths(jpath, n_layers):
    """The port's paths of a JAX leaf path, with the JAX split axis's
    counterpart: a stacked [L, in, out] kernel is [out, in] a layer."""
    parts = jpath.split("/")
    if parts[:2] == ["bert", "layers"]:
        name, leaf = parts[2], parts[3]
        leaf = {"kernel": "weight", "qkernel": "qweight"}.get(leaf, leaf)
        return [f"bert/layers/{i}/{name}/{leaf}" for i in range(n_layers)]
    linear = parts[-1] == "kernel" and parts[0] != "joint"
    return ["/".join(parts[:-1] + ["weight"] if linear else parts)]


def _port_dim(jpath, spec):
    """The port's split dim of a JAX leaf's PartitionSpec."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    if not axes:
        return None
    a = axes[0]
    parts = jpath.split("/")
    if parts[:2] == ["bert", "layers"]:
        if parts[3] in ("kernel", "qkernel"):
            return {2: 0, 1: 1}[a]
        return a - 1
    return a


@pytest.mark.parametrize("quantized", [False, True])
def test_split_rule_matches_jax_param_specs(quantized):
    """``sharding.split_dim`` on every leaf of the port's tree against
    JAX's ``param_specs`` of the same tree, f32 and int8 (static scales):
    q/k/v/wi column-split in every leaf but ``ascale``, o/wo ``kernel``
    row-split with their ``qscale`` and ``bias`` replicated, the word
    table and ``decoder_bias`` vocab-split."""
    exp = experiment()
    params = tree_np(init_mmbert_params(jax.random.key(0), exp.model))
    port = from_jax_params(params, "cpu")
    if quantized:
        stats = {k: np.asarray([1.0, 2.0], np.float32)
                 for k in ("attn_in", "ctx", "mlp_in", "ffn_act")}
        params = tree_np(jq.quantize_bert_params(params, act_stats=stats))
        port = tq.quantize_bert_params(port, act_stats={
            k: torch.from_numpy(v) for k, v in stats.items()})
    specs = jax.tree_util.tree_flatten_with_path(param_specs(params),
                                                 is_leaf=lambda x: not isinstance(x, dict))[0]
    port_paths = {p for p, _ in named_leaves(port)}
    seen = set()
    for path, spec in specs:
        jpath = "/".join(str(getattr(k, "key", k)) for k in path)
        for p in _port_paths(jpath, exp.model.bert.num_hidden_layers):
            assert p in port_paths, (jpath, p)
            assert sharding.split_dim(p) == _port_dim(jpath, spec), (p, spec)
            seen.add(p)
    assert seen == port_paths
    if quantized:
        assert sharding.split_dim("bert/layers/0/o/qweight") == 1
        assert sharding.split_dim("bert/layers/0/o/qscale") is None
        assert sharding.split_dim("bert/layers/0/q/qscale") == 0
        assert sharding.split_dim("bert/layers/0/q/ascale") is None


def test_shard_gather_round_trip():
    """Each model rank's shard has the split leaves' share of the rows or
    columns, both data rows hold the same shards, and gather_params of the
    shards in model order is the full tree bit for bit; a split the group
    does not divide raises, naming the leaf and the sizes."""
    exp = port_configs.ExperimentConfig.from_json(experiment().to_json())
    full = from_jax_params(tree_np(init_mmbert_params(
        jax.random.key(1), experiment().model)), "cpu")
    mesh = make_mesh(2, 2, ranks=range(4))
    shards = [sharding.shard_params(full, mesh, r) for r in range(4)]
    lp0, lp1 = (s["bert"]["layers"][0] for s in shards[:2])
    assert lp0["q"]["weight"].shape == (16, 32)
    assert lp0["wo"]["weight"].shape == (32, 32)
    assert lp0["o"]["bias"].shape == (32,)
    assert shards[1]["bert"]["embeddings"]["word"].shape == (60, 32)
    assert torch.equal(lp1["wi"]["weight"],
                       full["bert"]["layers"][0]["wi"]["weight"][32:])
    for a, b in zip(named_leaves(shards[0]), named_leaves(shards[2])):
        assert torch.equal(a[1], b[1]), a[0]
    whole = sharding.gather_params(shards[:2])
    for (k, v), (k2, w) in zip(named_leaves(whole), named_leaves(full)):
        assert k == k2 and torch.equal(v, w), k
    sharding.check_divisible(exp.model.bert, 4)
    with pytest.raises(ValueError, match="num_attention_heads 4 is not "
                                         "divisible by model_parallel=3"):
        sharding.check_divisible(exp.model.bert, 3)
    with pytest.raises(ValueError, match="intermediate_size 60 is not "
                                         "divisible by model_parallel=8"):
        sharding.check_divisible(dataclasses.replace(
            exp.model.bert, num_attention_heads=8, intermediate_size=60), 8)
    with pytest.raises(ValueError, match="padded vocab size 120 is not "
                                         "divisible by model_parallel=16"):
        sharding.check_divisible(dataclasses.replace(
            exp.model.bert, num_attention_heads=16, intermediate_size=64), 16)
    with pytest.raises(ValueError, match=r"decoder_bias: dim 0 of \(120,\) "
                                         "is not divisible"):
        sharding.shard_params(full, make_mesh(1, 7, ranks=range(7)), 0)


class _ThreadGroup:
    """A model group of threads: every collective is an exchange at a
    barrier, so one process can run each rank's shard in lockstep."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size

    def exchange(self, index, x):
        self.slots[index] = x.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _ThreadRank:
    def __init__(self, group, index):
        self.group, self.size, self.index = group, group.size, index

    def all_reduce(self, x):
        return sum(self.group.exchange(self.index, x))

    def max(self, x):
        return torch.stack(self.group.exchange(self.index, x)).amax(0)


def test_vocab_parallel_cross_entropy_matches_full():
    """The MLM cross entropy over two vocabulary shards (two threads, each
    a rank) equals the full one on the whole logits, ignored and weighted
    rows included, on both ranks; each shard's gradient is its columns of
    the full gradient."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((2, 6, 10)) * 3.0).float()
    labels = torch.from_numpy(rng.integers(0, 10, (2, 6)))
    labels[0, :2] = losses.IGNORE_INDEX
    weights = torch.tensor([1.0, 0.5])
    full = logits.clone().requires_grad_()
    want = losses.cross_entropy(full, labels, weights)
    want.backward()
    group, results = _ThreadGroup(2), [None, None]

    def rank(i):
        shard = logits[..., 5 * i:5 * (i + 1)].clone().requires_grad_()
        loss = losses.cross_entropy(shard, labels, weights,
                                    mp=_ThreadRank(group, i))
        loss.backward()
        results[i] = (loss.detach(), shard.grad)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (loss, grad) in enumerate(results):
        torch.testing.assert_close(loss, want.detach(), atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(grad, full.grad[..., 5 * i:5 * (i + 1)],
                                   atol=1e-7, rtol=1e-6)


def test_fuse_qkv_refused_under_model_parallelism():
    """JAX's guard: the fused [*, 3H] projection cannot be split over a
    model axis (its contiguous chunks would mix q with k)."""
    exp = port_configs.ExperimentConfig.from_json(experiment(1, 2).to_json())
    with pytest.raises(ValueError, match="fuse_qkv requires a mesh without "
                                         "a model axis"):
        Predictor(exp, {}, 4, "cpu", quantize="int8", fuse_qkv=True)


def test_hybrid_mesh_model_groups(monkeypatch):
    """``Mesh.groups`` on a hybrid mesh of eight ranks, two slices with
    interleaved ranks, at mp=2: every rank creates the same groups in the
    same order (the four model columns' data groups, then the four rows'
    model groups), and each rank's model group lies in its own slice."""
    from msa_tpu_torch.parallel import mesh as mesh_mod
    from msa_tpu_torch.parallel.mesh import make_hybrid_mesh

    slice_ids = [0, 1, 0, 1, 0, 1, 0, 1]
    mesh = make_hybrid_mesh(2, model_parallel=2, ranks=range(8),
                            slice_ids=slice_ids)
    made = []
    monkeypatch.setattr(mesh_mod, "world_size", lambda: 8)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 8)
    monkeypatch.setattr(torch.distributed, "new_group",
                        lambda ranks: made.append(tuple(ranks)) or tuple(ranks))
    orders = []
    for rank in range(8):
        monkeypatch.setattr(mesh_mod, "_GROUPS", {})
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
        made.clear()
        groups = mesh.groups()
        orders.append(list(made))
        d, m = mesh.coords(rank)
        assert groups["model"] == tuple(mesh.ranks[d]) and rank in groups["model"]
        assert {slice_ids[r] for r in groups["model"]} == {slice_ids[rank]}
        assert groups["data"] == tuple(mesh.ranks[:, m])
    assert all(o == orders[0] for o in orders) and len(orders[0]) == 6
