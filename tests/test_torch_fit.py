"""msa_tpu_torch's training entry point on the CPU against the JAX package:
``Trainer.fit``, resume, the fit checkpoints both ways, the train / sample /
score CLIs, pretrained BERT weights, and the port's copies of the scorers
and the run-dir utilities.

The model is test_torch_train.py's tiny one (H=128, 2 heads, 2 layers,
f32, dropout 0), with the same weights (``from_jax_params``) and the same
injected MLM masks on both sides.  Tolerances: history accuracies and MAEs
within 1e-5 (f32 summation order; the accuracies are counts of signs and
agree exactly unless a prediction sits at 0), resume bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.metrics import scores as jax_scores
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.models.weights import load_pretrained_bert as jax_load_pretrained
from msa_tpu.parallel.mesh import make_mesh
from msa_tpu.training import checkpoint as jax_ckpt
from msa_tpu.training.trainer import FitResult as JaxFitResult
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch.cli import sample as port_sample
from msa_tpu_torch.cli import score as port_score
from msa_tpu_torch.cli import train as port_train
from msa_tpu_torch.data import MultimodalDataset
from msa_tpu_torch.metrics import scores
from msa_tpu_torch.models.weights import (
    from_jax_params, load_pretrained_bert, load_torch_checkpoint,
    named_leaves, resolve_pretrained)
from msa_tpu_torch.training import checkpoint as ckpt
from msa_tpu_torch.training.trainer import FitResult, Trainer
from msa_tpu_torch.utils.logging import get_logger, make_date_dir
from test_cli_end_to_end import data_pkl, vocab_file, workdir  # noqa: F401
from test_torch_train import (
    MASK_ID, SPECIAL_IDS, VOCAB, B, L, experiment, mlm_masks, placed,
    port_experiment, tree_np)

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST_TOL = 1e-5
EPOCHS = 2
METRICS = ("val_acc", "val_mae", "test_acc", "test_mae", "test_f1")


def fit_experiment():
    return experiment(n_epochs=EPOCHS, val_batch_size=4, test_batch_size=4)


def splits(cls):
    return [cls(synthetic_split(n, L, 5, 7, vocab_size=VOCAB, seed=s), seed=s)
            for n, s in ((3 * B, 11), (8, 12), (8, 13))]


def port_trainer(exp):
    trainer = Trainer(port_experiment(exp), "cpu", mask_token_id=MASK_ID,
                      special_ids=SPECIAL_IDS)
    trainer.mlm_mask_injector = mlm_masks
    return trainer


def port_fit(exp, params, directory, start_epoch=0, resume=None):
    """The port's fit from ``params`` (a JAX tree), or resumed from the
    checkpoint directory ``resume``."""
    trainer = port_trainer(exp)
    total = 3 * EPOCHS
    result = None
    if resume is None:
        state = trainer.init_state(0, total, params=from_jax_params(params,
                                                                    "cpu"))
    else:
        loaded, meta = ckpt.load_checkpoint(resume, "cpu")
        state = trainer.init_state(0, total, params=loaded.params)
        state.opt_state, state.step = loaded.opt_state, loaded.step
        start_epoch = meta["epoch"] + 1
        result = FitResult.from_meta(meta["fit"], resume)
    return trainer.fit(state, *splits(MultimodalDataset), checkpoint_dir=directory,
                       base_seed=1, start_epoch=start_epoch,
                       resume_result=result)


def jax_fit(exp, directory, resume=None):
    trainer = JaxTrainer(exp, mesh=make_mesh(1, 1), mask_token_id=MASK_ID,
                         special_ids=SPECIAL_IDS)
    trainer.mlm_mask_injector = mlm_masks
    state = placed(trainer.init_state(jax.random.key(0), total_steps=3 * EPOCHS),
                   trainer.mesh)
    params = tree_np(state.params)
    start_epoch, result = 0, None
    if resume is not None:
        state, meta = jax_ckpt.load_checkpoint(resume, state)
        state = placed(state, trainer.mesh)
        start_epoch = meta["epoch"] + 1
        result = JaxFitResult.from_meta(meta["fit"], resume)
    state, result = trainer.fit(state, *splits(JaxDataset), checkpoint_dir=directory,
                                rng=trainer.rng(1), start_epoch=start_epoch,
                                resume_result=result)
    return params, tree_np(state.params), result


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """JAX's and the port's 2-epoch fits from the same weights, with their
    checkpoint directories."""
    d = tmp_path_factory.mktemp("fits")
    exp = fit_experiment()
    params, jax_final, jax_result = jax_fit(exp, str(d / "jax"))
    state, result = port_fit(exp, params, str(d / "port"))
    return {"exp": exp, "params": params, "dir": d, "jax": jax_result,
            "jax_final": jax_final, "port": result, "port_state": state}


def untimed(result):
    """A FitResult's meta without the host-clock samples/s of each epoch."""
    meta = result.to_meta()
    for h in meta["history"]:
        h["train"] = {k: v for k, v in h["train"].items()
                      if k != "samples_per_sec"}
    return meta


def assert_same_history(got, want):
    assert got.best_epoch == want.best_epoch
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        for k in METRICS:
            assert g[k] == pytest.approx(w[k], abs=HIST_TOL), k
        assert g["train"]["loss"] == pytest.approx(w["train"]["loss"],
                                                   rel=HIST_TOL)


def test_fit_matches_jax(fits):
    """Same best epoch, history and selection state as JAX's fit, and one
    checkpoint per improvement with the predictions beside it."""
    got, want = fits["port"], fits["jax"]
    assert_same_history(got, want)
    assert got.best_acc == pytest.approx(want.best_acc, abs=HIST_TOL)
    np.testing.assert_allclose(got.best_preds, want.best_preds, atol=HIST_TOL)
    np.testing.assert_array_equal(got.best_labels, want.best_labels)
    for side in ("port", "jax"):
        epochs = ckpt.list_epoch_checkpoints(str(fits["dir"] / side))
        assert epochs and got.best_epoch in epochs, (side, epochs)
    assert ckpt.list_epoch_checkpoints(str(fits["dir"] / "port")) == \
        jax_ckpt.list_epoch_checkpoints(str(fits["dir"] / "jax"))
    best = ckpt.epoch_dir(str(fits["dir"] / "port"), got.best_epoch)
    np.testing.assert_array_equal(np.load(os.path.join(best, "predict.npy")),
                                  got.best_preds)
    with open(os.path.join(best, "meta.json")) as f:
        assert json.load(f)["fit"]["best_epoch"] == got.best_epoch


def test_fit_checkpoints_load_in_either_package(fits):
    """A port-written fit checkpoint loads in JAX's load_checkpoint and
    FitResult.from_meta, and a JAX-written one in the port's: the same
    weights, step and selection state from either reader."""
    exp = fits["exp"]
    template = JaxTrainer(exp, mesh=make_mesh(1, 1)).init_state(
        jax.random.key(0), total_steps=3 * EPOCHS)
    for side in ("port", "jax"):
        d = ckpt.epoch_dir(str(fits["dir"] / side), 0)
        jstate, jmeta = jax_ckpt.load_checkpoint(d, template)
        pstate, pmeta = ckpt.load_checkpoint(d, "cpu")
        assert jmeta == pmeta and int(jstate.step) == pstate.step == 3
        want = dict(named_leaves(from_jax_params(tree_np(jstate.params), "cpu")))
        for k, v in named_leaves(pstate.params):
            assert torch.equal(v, want[k]), (side, k)
        jres = JaxFitResult.from_meta(jmeta["fit"], d)
        pres = FitResult.from_meta(pmeta["fit"], d)
        assert pres.to_meta() == jres.to_meta()
        np.testing.assert_array_equal(pres.best_preds, jres.best_preds)
        np.testing.assert_array_equal(pres.best_labels, jres.best_labels)


def test_resume_crosses_packages(fits, tmp_path):
    """Resumed from the other package's epoch-1 checkpoint, each package's
    second epoch matches the other's uninterrupted one."""
    exp = fits["exp"]
    _, result = port_fit(exp, None, str(tmp_path / "p"),
                         resume=ckpt.epoch_dir(str(fits["dir"] / "jax"), 0))
    assert_same_history(result, fits["jax"])
    _, _, jresult = jax_fit(exp, str(tmp_path / "j"),
                            resume=ckpt.epoch_dir(str(fits["dir"] / "port"), 0))
    assert_same_history(jresult, fits["port"])


def test_resume_is_bitwise(fits, tmp_path):
    """The port resumed from its own epoch-1 checkpoint ends its second
    epoch with the uninterrupted run's parameters, moments and step, bit for
    bit, and the same selection state."""
    state, result = port_fit(fits["exp"], None, str(tmp_path),
                             resume=ckpt.epoch_dir(str(fits["dir"] / "port"), 0))
    want = fits["port_state"]
    assert state.step == want.step == 3 * EPOCHS
    for tree in ("params", "mu", "nu"):
        a = state.params if tree == "params" else getattr(state.opt_state, tree)
        b = want.params if tree == "params" else getattr(want.opt_state, tree)
        b = dict(named_leaves(b))
        for k, v in named_leaves(a):
            assert torch.equal(v, b[k]), (tree, k)
    assert untimed(result) == untimed(fits["port"])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def test_train_sample_score_pipeline(workdir, vocab_file, data_pkl,  # noqa: F811
                                     monkeypatch):
    """python -m msa_tpu_torch.cli.train on the reference-format pickle
    (tiny model, the CPU), then --resume from its first checkpoint
    (bitwise the same final parameters), cli.sample on its checkpoint and
    cli.score on its saved predictions."""
    monkeypatch.chdir(workdir)
    argv = ["--device", "cpu", "--dataset", "mosi", "--num_labels", "1",
            "--model", "tiny", "--data_pkl", data_pkl, "--vocab", vocab_file,
            "--n_epochs", "2", "--train_batch_size", "8", "--val_batch_size",
            "8", "--test_batch_size", "8", "--compute_dtype", "float32",
            "--checkpoint_root", str(workdir / "port_model_save"),
            "--numpy_root", str(workdir / "port_numpy_save")]
    args = port_train.build_parser().parse_args(argv)
    trainer, state, result = port_train.run(args)
    assert trainer.device.type == "cpu" and len(result.history) == 2
    assert result.best_preds is not None
    runs = sorted(os.listdir(workdir / "port_model_save"))
    run_dir = str(workdir / "port_model_save" / runs[-1])
    assert 0 in ckpt.list_epoch_checkpoints(run_dir)

    args = port_train.build_parser().parse_args(
        argv + ["--resume", ckpt.epoch_dir(run_dir, 0)])
    _, resumed, resumed_result = port_train.run(args)
    assert resumed.step == state.step
    want = dict(named_leaves(state.params))
    for k, v in named_leaves(resumed.params):
        assert torch.equal(v, want[k]), k
    assert untimed(resumed_result) == untimed(result)

    preds, labels = port_sample.main([
        "--checkpoint", run_dir, "--data_pkl", data_pkl, "--vocab",
        vocab_file, "--batch_size", "8", "--device", "cpu"])
    assert preds.shape[0] == 8 and np.isfinite(preds).all()
    np_runs = sorted(os.listdir(workdir / "port_numpy_save"))
    report = port_score.main(["--path", np_runs[-1], "--numpy_root",
                              str(workdir / "port_numpy_save")])
    assert "mae" in report and np.isfinite(report["mae"])


def test_sample_cli_takes_jax_parallel_flags(fits):
    """cli.sample parses JAX's ``--dp 1 --mp 1`` and scores a synthetic
    split from a fit checkpoint on the CPU; ``--mp 2`` in one process has
    no second rank to split the weights over and raises make_mesh's
    ValueError, as cli.train does (four ranks:
    test_torch_tensor_parallel.py)."""
    run_dir = str(fits["dir"] / "port")
    preds, labels = port_sample.main([
        "--checkpoint", run_dir, "--synthetic", "8", "--batch_size", "4",
        "--dp", "1", "--mp", "1", "--device", "cpu"])
    assert preds.shape[0] == labels.shape[0] == 8 and np.isfinite(preds).all()
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        port_sample.main(["--checkpoint", run_dir, "--synthetic", "8",
                          "--mp", "2", "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--mp", "2"],
                                   ["--distributed"],
                                   ["--coordinator", "localhost:1234"]])
def test_train_cli_refuses_parallel_flags(flags, tmp_path, monkeypatch):
    """What a single process cannot run raises before any training: --dp 2
    and --mp 2 without a process group (make_mesh finds one rank),
    --distributed without torchrun's environment, --coordinator without
    the process count and id.  Real launches: test_torch_data_parallel.py
    (two ranks), test_torch_tensor_parallel.py (four, --dp 2 --mp 2)."""
    monkeypatch.chdir(tmp_path)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "MSA_COORDINATOR", "MSA_NUM_PROCESSES", "MSA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    error, match = {"--dp": (ValueError, "requested 2 ranks, have 1"),
                    "--mp": (ValueError, "not divisible by model_parallel=2"),
                    "--distributed": (ValueError, "env://"),
                    "--coordinator": (ValueError, "number of processes")
                    }[flags[0]]
    with pytest.raises(error, match=match):
        port_train.main(["--device", "cpu", "--model", "tiny",
                         "--synthetic", "8", "--n_epochs", "1", *flags])


def test_cli_runs_without_jax(tmp_path):
    """cli.train, cli.sample and cli.score on the CPU with jax, the JAX
    package, flax, msgpack and the orbax stack (orbax, tensorstore,
    zstandard, numcodecs) blocked (a subprocess); cli.sample also reads
    the committed two-process orbax checkpoint."""
    code = """
import sys
BLOCKED = {"jax", "msa_tpu", "flax", "msgpack", "orbax", "tensorstore",
           "zstandard", "numcodecs"}
for name in BLOCKED:
    sys.modules[name] = None
import os
import numpy as np
from msa_tpu_torch.cli import sample, score, train
result = train.main(["--device", "cpu", "--model", "tiny", "--dataset",
                     "mosi", "--synthetic", "16", "--n_epochs", "1",
                     "--train_batch_size", "8", "--val_batch_size", "8",
                     "--test_batch_size", "8", "--compute_dtype", "float32",
                     "--max_seq_length", "12"])
run = sorted(os.listdir("model_save"))[-1]
preds, _ = sample.main(["--checkpoint", os.path.join("model_save", run),
                        "--device", "cpu", "--synthetic", "8"])
report = score.main(["--path", sorted(os.listdir("numpy_save"))[-1]])
assert np.isfinite(preds).all() and np.isfinite(report["mae"])
preds, _ = sample.main(["--checkpoint", FIXTURE, "--device", "cpu",
                        "--synthetic", "8", "--dp", "1", "--mp", "1"])
assert len(preds) == 8 and np.isfinite(preds).all()
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert not loaded & BLOCKED, loaded & BLOCKED
print("ok", len(result.history))
""".replace("FIXTURE", repr(os.path.join(REPO, "tests", "data",
                                          "orbax_two_process")))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ["ok", "1"]


# ---------------------------------------------------------------------------
# Pretrained weights, scorers, run directories
# ---------------------------------------------------------------------------


def hf_state_dict(cfg, seed=0):
    """A random HF BertForPreTraining state dict of ``cfg``'s shapes."""
    rng = np.random.default_rng(seed)
    bc = cfg.bert
    h, i = bc.hidden_size, bc.intermediate_size

    def t(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd = {"bert.embeddings.word_embeddings.weight": t(bc.vocab_size, h),
          "bert.embeddings.position_embeddings.weight":
              t(bc.max_position_embeddings, h),
          "bert.embeddings.token_type_embeddings.weight":
              t(bc.type_vocab_size, h),
          "bert.pooler.dense.weight": t(h, h), "bert.pooler.dense.bias": t(h),
          "cls.predictions.bias": t(bc.vocab_size),
          "cls.predictions.transform.dense.weight": t(h, h),
          "cls.predictions.transform.dense.bias": t(h),
          "cls.seq_relationship.weight": t(2, h),
          "cls.seq_relationship.bias": t(2)}
    for ln in ("bert.embeddings.LayerNorm",
               "cls.predictions.transform.LayerNorm"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = 1 + t(h), t(h)
    for n in range(bc.num_hidden_layers):
        base = f"bert.encoder.layer.{n}."
        for name, shape in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (i, h)),
                            ("output.dense", (h, i))):
            sd[base + name + ".weight"] = t(*shape)
            sd[base + name + ".bias"] = t(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[base + ln + ".weight"], sd[base + ln + ".bias"] = 1 + t(h), t(h)
    return sd


def test_load_pretrained_bert_matches_jax(tmp_path):
    """An HF state dict written as a torch file, read back by
    load_torch_checkpoint and merged into fresh parameters, equals JAX's
    load_pretrained_bert of the same dict; names resolve to nothing."""
    exp = fit_experiment()
    sd = hf_state_dict(exp.model)
    path = str(tmp_path / "bert.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    read = load_torch_checkpoint(path)
    assert set(read) == set(sd)
    init = tree_np(init_mmbert_params(jax.random.key(3), exp.model))
    want = dict(named_leaves(from_jax_params(
        tree_np(jax_load_pretrained(sd, exp.model, init)), "cpu")))
    got = load_pretrained_bert(resolve_pretrained(path),
                               port_experiment(exp).model,
                               from_jax_params(init, "cpu"))
    got = dict(named_leaves(got))
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(FileNotFoundError, match="fetch_bert_weights"):
        resolve_pretrained("bert-large-uncased")


def test_scorers_match_jax():
    """The port's copies of the scorers against the JAX package's."""
    rng = np.random.default_rng(0)
    preds, labels = rng.uniform(-3, 3, 40), rng.uniform(-3, 3, 40)
    labels[:3] = 0.0
    classes = rng.integers(0, 7, 40), rng.integers(0, 7, 40)
    for fn, args in (("test_mse_score", (preds, labels)),
                     ("test_ce_score", classes), ("ACC3", (preds, labels)),
                     ("ACC7", (preds, labels)),
                     ("multiclass_acc", (preds, labels))):
        np.testing.assert_equal(getattr(scores, fn)(*args),
                                getattr(jax_scores, fn)(*args), err_msg=fn)
    for swap in (False, True):
        np.testing.assert_equal(
            scores.misa_report(labels, preds, swap_binary=swap),
            jax_scores.misa_report(labels, preds, swap_binary=swap))


def test_run_dirs_and_logger(tmp_path):
    a, b = make_date_dir(str(tmp_path / "runs")), make_date_dir(
        str(tmp_path / "runs"))
    assert a != b and a.endswith("-00") and b.endswith("-01")
    logger, path = get_logger(str(tmp_path / "logs"))
    logger.info("hello %d", 7)
    for handler in logger.handlers:
        handler.flush()
    with open(path) as f:
        assert "hello 7" in f.read()


def test_fit_result_meta_round_trip(tmp_path):
    r = FitResult(best_epoch=3, best_acc=0.75, best_mae=0.5, best_f1=0.7,
                  best_preds=np.arange(4.0), best_labels=np.ones(4),
                  history=[{"epoch": 1, "val_acc": 0.5}])
    np.save(tmp_path / "predict.npy", r.best_preds)
    np.save(tmp_path / "target.npy", r.best_labels)
    back = FitResult.from_meta(json.loads(json.dumps(r.to_meta())),
                               str(tmp_path))
    assert back.to_meta() == r.to_meta()
    np.testing.assert_array_equal(back.best_preds, r.best_preds)
    assert back.to_meta() == JaxFitResult.from_meta(r.to_meta()).to_meta()
    assert FitResult().to_meta() == JaxFitResult().to_meta()
