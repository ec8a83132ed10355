"""msa_tpu_torch's data parallelism across processes against the JAX package.

Two gloo processes on the CPU (one spawn; the workers import only the
port) run the port's ``Trainer`` and ``Predictor`` at ``data_parallel=2``
on the weights, optimizer state, batches and MLM masks of a JAX
``Trainer(data_parallel=2)`` run on the conftest's fake CPU devices.  The
ranks' rows hold unequal masked counts, so a mean of per-rank means would
miss JAX's global losses.  Tiny config (H=64, 2 heads, 2 layers), f32,
dropout 0.  Tolerances as ``test_torch_train.py``'s f32 case: losses rtol
1e-5 (summation order, and here the split of each sum over two ranks),
parameters after Adam steps atol 1e-5.

The same spawn runs ``cli.train --dp 2`` for two epochs (rank 0 writes the
checkpoints) and ``--resume`` from the first epoch's, which must end on
the uninterrupted run's parameters bit for bit on both ranks.

Also here: the mesh of ranks (``parallel/mesh.py``) against JAX's
``make_mesh`` / ``make_hybrid_mesh`` cases, the backend rule, batch
sharding, and what one process cannot run.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config)
from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.parallel.mesh import make_hybrid_mesh as jax_make_hybrid_mesh
from msa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch import configs as port_configs
from msa_tpu_torch.data import FeaturizedSplit as PortSplit
from msa_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params, named_leaves)
from msa_tpu_torch.parallel import distributed
from msa_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, make_hybrid_mesh, make_mesh)
from msa_tpu_torch.training.trainer import Trainer
from test_torch_train import placed

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIAL_IDS = (0, 2, 3, 4)
MASK_ID = 4
L, B, VOCAB, STEPS = 12, 4, 120, 2
EVAL_BATCH, EVAL_N = 3, 7   # 3 rows a batch: dp=2 pads each to 4
SERVE_BATCH, SERVE_N = 4, 10
METRICS = ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")


def experiment(data_parallel=2, **train):
    bert = dataclasses.replace(
        tiny_bert_config(hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=128,
                         vocab_size=VOCAB),
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    train = {"compute_dtype": "float32", "data_parallel": data_parallel,
             "train_batch_size": B, "learning_rate": 1e-3,
             "warmup_proportion": 0.0, **train}
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7,
                           num_labels=1, joint_dropout_prob=0.0),
        data=DataConfig(max_seq_length=L), train=TrainConfig(**train))


def unequal_masks(epoch, bi, batch):
    """MLM masks whose masked counts differ between the two ranks' rows:
    rank 0's rows (0, 1) at 0.5, rank 1's (2, 3) at 0.1."""
    ids = np.asarray(batch["text_ids"])
    rng = np.random.default_rng(200 + 10 * epoch + bi)
    prob = np.where(np.arange(ids.shape[0]) < ids.shape[0] // 2, 0.5, 0.1)
    special = np.isin(ids, SPECIAL_IDS)
    masked = (rng.random((ids.shape[0], 3, ids.shape[1]))
              < prob[:, None, None]) & ~special[:, None]
    return {"mlm_masked": masked,
            "mlm_replaced": (rng.random(masked.shape) < 0.8) & masked}


def train_batches():
    split = synthetic_split(B * STEPS, L, 5, 7, vocab_size=VOCAB, seed=3)
    out = []
    for i, batch in enumerate(JaxDataset(split, seed=1).epoch_batches(0, B)):
        batch = dict(batch)
        batch.update(unequal_masks(0, i, batch))
        out.append(batch)
    return out


def port_split(split):
    """The JAX package's FeaturizedSplit as the port's (the workers cannot
    unpickle the former)."""
    return PortSplit(**{f.name: getattr(split, f.name)
                        for f in dataclasses.fields(split)})


def tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def run_jax():
    """JAX's dp=2 steps, eval epoch and predictions, and what the workers
    start from."""
    exp = experiment()
    trainer = JaxTrainer(exp, mesh=jax_make_mesh(2, 1), mask_token_id=MASK_ID,
                         special_ids=SPECIAL_IDS)
    trainer.mlm_mask_injector = unequal_masks
    state = placed(trainer.init_state(jax.random.key(0), total_steps=STEPS),
                   trainer.mesh)
    start = (tree_np(state.params), tree_np(state.opt_state))
    step = trainer._build_train_step()
    hist = []
    batches = train_batches()
    for batch in batches:
        state, m = step(state, trainer._shard_batch(batch), trainer.rng(1))
        hist.append({k: float(v) for k, v in jax.device_get(m).items()})
    eval_split = synthetic_split(EVAL_N, L, 5, 7, vocab_size=VOCAB, seed=8)
    em, epreds, _ = trainer.eval_epoch(state, JaxDataset(eval_split, seed=2),
                                       0, trainer.rng(1), EVAL_BATCH)
    serve = synthetic_split(SERVE_N, L, 5, 7, vocab_size=VOCAB, seed=9)
    preds = JaxPredictor(exp, state.params, SERVE_BATCH,
                         mesh=jax_make_mesh(2, 1)).predict_split(serve)
    with pytest.raises(ValueError, match="multiple of the") as indivisible:
        JaxPredictor(exp, state.params, 3, mesh=jax_make_mesh(2, 1))
    return {"indivisible": str(indivisible.value), "start": start,
            "batches": batches, "hist": hist,
            "params": tree_np(state.params), "eval": em.averaged(),
            "eval_preds": epreds, "eval_split": eval_split,
            "serve": serve, "serve_preds": preds}


WORKER = r"""
import os, pickle, sys
for name in ("jax", "msa_tpu"):
    sys.modules[name] = None  # the workers run the port alone
import numpy as np
import torch
torch.set_num_threads(1)
from msa_tpu_torch import configs
from msa_tpu_torch.cli import train as cli_train
from msa_tpu_torch.data import MultimodalDataset
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.weights import named_leaves
from msa_tpu_torch.parallel import distributed
from msa_tpu_torch.training.checkpoint import epoch_dir
from msa_tpu_torch.training.trainer import Trainer

rank, work = int(os.environ["PROC_ID"]), os.environ["WORK"]
backend = distributed.initialize(f"127.0.0.1:{os.environ['PORT']}", 2, rank,
                                 device="cpu")
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
exp = configs.ExperimentConfig.from_json(inp["exp"])
trainer = Trainer(exp, "cpu", mask_token_id=4, special_ids=(0, 2, 3, 4))
state = trainer.init_state(0, 2, params=inp["params"])
state.opt_state = inp["opt_state"]
hist = []
for batch in inp["batches"]:
    state, m = trainer.train_step(state, batch, base_seed=1)
    hist.append({k: float(v) for k, v in m.items()})
em, epreds, _ = trainer.eval_epoch(
    state, MultimodalDataset(inp["eval_split"], seed=2), 0, 1, 3)
serve = Predictor(exp, state.params, 4, "cpu").predict_split(inp["serve"])
try:  # a batch the data axis does not divide
    Predictor(exp, state.params, 3, "cpu")
    indivisible = None
except ValueError as e:
    indivisible = str(e)
out = {"backend": backend, "indivisible": indivisible, "hist": hist,
       "eval": em.averaged(),
       "eval_preds": epreds, "serve_preds": serve,
       "params": {k: v.detach() for k, v in named_leaves(state.params)}}

# cli.train --dp 2: two epochs, then --resume from the first epoch's
os.chdir(work)
argv = ["--model", "tiny", "--dataset", "mosi", "--synthetic", "16",
        "--n_epochs", "2", "--train_batch_size", "4", "--val_batch_size", "3",
        "--test_batch_size", "3", "--compute_dtype", "float32",
        "--checkpoint_root", os.path.join(work, "model_save"),
        "--numpy_root", os.path.join(work, "numpy_save"), "--device", "cpu",
        "--dp", "2", "--coordinator", f"127.0.0.1:{os.environ['PORT']}",
        "--num_processes", "2", "--process_id", str(rank)]
_, full, result = cli_train.run(cli_train.build_parser().parse_args(argv))
run = os.path.join(work, "model_save",
                   sorted(os.listdir(os.path.join(work, "model_save")))[0])
_, resumed, _ = cli_train.run(cli_train.build_parser().parse_args(
    argv + ["--resume", epoch_dir(run, 0)]))
out["cli"] = {"steps": (full.step, resumed.step),
              "runs": sorted(os.listdir(os.path.join(work, "model_save"))),
              "history": len(result.history),
              "epochs": sorted(os.listdir(run)),
              "full": {k: v.detach() for k, v in named_leaves(full.params)},
              "resumed": {k: v.detach()
                          for k, v in named_leaves(resumed.params)}}
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(work, timeout=300):
    """Two worker processes (``WORKER``) on one gloo group; their outputs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), WORK=str(work),
               PORT=str(_free_port()), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER],
                              env=dict(env, PROC_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
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
            for r in range(2)], logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    ref = run_jax()
    params, opt_state = ref["start"]
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"exp": experiment().to_json(),
                     "params": from_jax_params(params, "cpu"),
                     "opt_state": from_jax_opt_state(opt_state, "cpu"),
                     "batches": ref["batches"],
                     "eval_split": port_split(ref["eval_split"]),
                     "serve": port_split(ref["serve"])}, f)
    outs, logs = run_workers(work)
    return ref, outs, logs


def test_dp_train_steps_match_jax(runs):
    """Two dp=2 train steps of the port across two gloo processes against
    JAX's dp=2 step on the same global batches, whose ranks hold unequal
    masked counts: every loss term on both ranks, and every parameter."""
    ref, outs, logs = runs
    assert all(o["backend"] == "gloo" for o in outs)
    assert all("backend gloo" in log for log in logs)
    # the counts differ between the ranks' rows, so per-rank means would not do
    m = ref["batches"][0]["mlm_masked"]
    assert m[:B // 2].sum() > 2 * m[B // 2:].sum()
    for out in outs:
        for got, want in zip(out["hist"], ref["hist"]):
            for k in METRICS:
                assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
            assert got["mlm_overflow"] == want["mlm_overflow"] == 0
    want = {k: v.detach() for k, v in
            named_leaves(from_jax_params(ref["params"], "cpu"))}
    start = {k: v.detach() for k, v in
             named_leaves(from_jax_params(ref["start"][0], "cpu"))}
    assert max(float((want[k] - v).abs().max()) for k, v in start.items()) > 1e-4
    for k, v in outs[0]["params"].items():
        torch.testing.assert_close(v, want[k], atol=1e-5, rtol=0, msg=k)
        assert torch.equal(v, outs[1]["params"][k]), k  # replicas agree


def test_dp_eval_indivisible_batch_matches_jax(runs):
    """Eval batches of 3 rows at dp=2 (padded to 4 with weight-0 rows, as
    JAX's _shard_batch): every real prediction, no padding, and the
    averaged losses against JAX's dp=2 eval_epoch."""
    ref, outs, _ = runs
    for out in outs:
        assert out["eval_preds"].shape == ref["eval_preds"].shape == (EVAL_N, 1)
        np.testing.assert_allclose(out["eval_preds"], ref["eval_preds"],
                                   atol=1e-5, rtol=0)
        for k in METRICS:
            assert out["eval"][k] == pytest.approx(ref["eval"][k], rel=1e-5,
                                                   abs=1e-6), k


def test_dp_predictor_matches_jax(runs):
    """Predictor at dp=2 (batch 4: two rows a rank, a ragged last batch):
    the same whole array on both ranks, within f32 atol 1e-5 of JAX's dp=2
    Predictor; a batch of 3, which the data axis does not divide, raises
    on both ranks as JAX's does."""
    ref, outs, _ = runs
    assert "batch_size 3 must be a multiple of the" in ref["indivisible"]
    for out in outs:
        assert "batch_size 3 must be a multiple of the data-axis size 2" in (
            out["indivisible"] or "")
    np.testing.assert_array_equal(outs[0]["serve_preds"], outs[1]["serve_preds"])
    assert outs[0]["serve_preds"].shape == (SERVE_N,)
    np.testing.assert_allclose(outs[0]["serve_preds"], ref["serve_preds"],
                               atol=1e-5, rtol=0)


def test_dp_cli_checkpoint_resume(runs):
    """cli.train --dp 2 --coordinator ...: one run directory (rank 0 wrote
    it, every rank named it), the first epoch's checkpoint, and --resume
    from it ends on the uninterrupted run's parameters bit for bit, on both
    ranks alike."""
    _, outs, _ = runs
    for out in outs:
        cli = out["cli"]
        assert cli["history"] == 2 and len(cli["runs"]) == 2
        assert cli["steps"] == (8, 8)
        assert "epoch_000" in cli["epochs"]
        for k, v in cli["full"].items():
            assert torch.equal(v, cli["resumed"][k]), k
            assert torch.equal(v, outs[1]["cli"]["full"][k]), k


# ---------------------------------------------------------------------------
# In-process pieces
# ---------------------------------------------------------------------------

def test_mesh_shapes():
    """``make_mesh`` over a list of ranks, as JAX's over its devices."""
    mesh = make_mesh(4, 2, ranks=range(8))
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.shape == dict(jax_make_mesh(4, 2).shape)
    assert make_mesh(-1, 2, ranks=range(8)).shape == {"data": 4, "model": 2}
    assert mesh.coords(5) == (2, 1)
    assert make_mesh().shape == {DATA_AXIS: 1, MODEL_AXIS: 1}  # one process
    with pytest.raises(ValueError, match="requested 2 ranks, have 1"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(-1, 3, ranks=range(8))


SLICE_IDS = [0, 0, 0, 0, 1, 1, 1, 1]


@pytest.mark.parametrize("kw,shape", [
    ({"model_parallel": 2}, {"data": 4, "model": 2}),
    ({"ici_data_parallel": 4, "model_parallel": 1}, {"data": 8, "model": 1})])
def test_hybrid_mesh_shape_and_slice_locality(kw, shape):
    """Two slices of four ranks (tests/test_hybrid_mesh.py's layouts): the
    same shapes as JAX's on the fake devices; every model group inside one
    slice; slices own contiguous data blocks."""
    mesh = make_hybrid_mesh(dcn_data_parallel=2, ranks=range(8),
                            slice_ids=SLICE_IDS, **kw)
    assert mesh.shape == shape == dict(jax_make_hybrid_mesh(
        dcn_data_parallel=2, devices=jax.devices()[:8], slice_ids=SLICE_IDS,
        **kw).shape)
    assert mesh.size == 8
    for row in mesh.ranks:
        assert len({SLICE_IDS[r] for r in row}) == 1
    column = [SLICE_IDS[r] for r in mesh.ranks[:, 0]]
    assert column == sorted(column) and set(column) == {0, 1}


def test_hybrid_mesh_rejects_bad_topologies():
    for make, devs in ((make_hybrid_mesh, list(range(8))),
                       (jax_make_hybrid_mesh, jax.devices()[:8])):
        key = "ranks" if make is make_hybrid_mesh else "devices"
        with pytest.raises(ValueError, match="slices found"):
            make(dcn_data_parallel=4, model_parallel=2,
                 **{key: devs, "slice_ids": SLICE_IDS})
        with pytest.raises(ValueError, match="uneven"):
            make(dcn_data_parallel=2, model_parallel=1,
                 **{key: devs, "slice_ids": [0, 0, 0, 1, 1, 1, 1, 1]})
        with pytest.raises(ValueError, match="pass both"):
            make(dcn_data_parallel=2, **{key: devs})
    # by default the world's ranks (one process here) in contiguous slices
    assert make_hybrid_mesh(1).shape == {"data": 1, "model": 1}


def test_backend_rule_and_batch_sharding(monkeypatch):
    """gloo for the CPU and for ranks that share a card, NCCL with a card a
    rank; the process's own device without a card raises; each rank keeps
    its rows of the zero-padded global batch (weight 0 on the padding)."""
    assert distributed.choose_backend("cpu", 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend("cuda", 2) == "gloo"
    assert distributed.choose_backend("cuda", 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.rank_device("cuda", 1)
    assert distributed.rank_device("cpu", 1) == torch.device("cpu")
    monkeypatch.setenv("MSA_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("MSA_NUM_PROCESSES", "4")
    assert distributed.process_env_defaults() == {
        "coordinator_address": "10.0.0.1:1234", "num_processes": 4,
        "process_id": None}
    batch = {"x": np.arange(5.0), "weight": np.ones(5, np.float32)}
    shards = [distributed.shard_host_batch(batch, 2, i) for i in range(2)]
    np.testing.assert_array_equal(shards[0]["x"], [0, 1, 2])
    np.testing.assert_array_equal(shards[1]["x"], [3, 4, 0])
    np.testing.assert_array_equal(shards[1]["weight"], [1, 1, 0])


@pytest.mark.parametrize("train", [{"model_parallel": 2},
                                   {"sequence_parallel": True}])
def test_trainer_and_predictor_refuse_model_parallelism(train):
    """In one process a model axis of 2 has no ranks to split over: the
    Trainer and the Predictor raise as make_mesh does for a data axis.
    Sequence parallelism without a model axis is the identity, as in JAX:
    both run, with no model group.  Four ranks:
    test_torch_tensor_parallel.py."""
    from msa_tpu_torch.inference import Predictor

    exp = port_configs.ExperimentConfig.from_json(experiment(1, **train).to_json())
    makes = (lambda: Trainer(exp, "cpu"), lambda: Predictor(exp, {}, 4, "cpu"))
    if "model_parallel" in train:
        for make in makes:
            with pytest.raises(ValueError, match="requested 2 ranks, have 1"):
                make()
        return
    for make in makes:
        made = make()
        assert made.mp is None and made.mesh.shape == {DATA_AXIS: 1,
                                                       MODEL_AXIS: 1}


def test_initialize_needs_the_launch(monkeypatch):
    """A coordinator without the process count and id raises before any
    connection."""
    for var in ("MSA_NUM_PROCESSES", "MSA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="number of processes"):
        distributed.initialize("127.0.0.1:1", device="cpu")
