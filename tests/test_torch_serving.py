"""msa_tpu_torch's Predictor and JSONL service against the JAX package.

Tiny config (H=128, 2 heads, 2 layers), JAX parameters carried over by
``from_jax_params``, a ragged synthetic split (10 samples, batch 4: the
last batch is zero-padded).  f32 on both sides; tolerance atol = 1e-4 on
the predictions (tanh outputs in [-1, 1]; what differs is summation
order).  The no-jax check runs in a subprocess because this test process
has jax imported (tests/conftest.py).

bf16 against the JAX Predictor in bf16: the predictions may differ by at
most BF16_NOISE_FACTOR times the gap between JAX's own bf16 and f32
predictions (both sides round to bf16 at different points, which moves
the result about as much as the rounding itself); classes must agree.
"""

import dataclasses
import glob
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config,
)
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.data.wordpiece import Tokenizer, make_test_vocab
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu_torch.cli.serve import serve_stream
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.weights import from_jax_params

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

ATOL = 1e-4
BF16_NOISE_FACTOR = 3.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def experiment(num_labels=1, vocab_size=120, pair_seq_length=None):
    bert = tiny_bert_config(hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=256,
                            vocab_size=vocab_size)
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7,
                           num_labels=num_labels),
        data=DataConfig(dataset="mosi", max_seq_length=12,
                        pair_seq_length=pair_seq_length),
        train=TrainConfig(compute_dtype="float32", data_parallel=1))


def with_dtype(exp, compute_dtype):
    return dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, compute_dtype=compute_dtype))


def both_predictors(exp, batch_size=4, seed=0, jparams=None):
    if jparams is None:
        jparams = init_mmbert_params(jax.random.key(seed), exp.model)
    params = from_jax_params(jax.device_get(jparams), torch.device("cpu"))
    return (JaxPredictor(exp, jparams, batch_size=batch_size),
            Predictor(exp, params, batch_size, torch.device("cpu")))


@pytest.mark.parametrize("num_labels", [1, 7, 3])
def test_predictor_matches_jax_on_ragged_split(num_labels):
    """num_labels 1: tanh regression; 7: raw regression output; 3:
    argmax(sigmoid) classification."""
    exp = experiment(num_labels)
    jax_pred, pred = both_predictors(exp, seed=num_labels)
    split = synthetic_split(10, 12, 5, 7, vocab_size=120,
                            num_labels=num_labels, seed=num_labels)
    ref = jax_pred.predict_split(split)
    out = pred.predict_split(split)
    assert out.shape == ref.shape == (10,)
    if num_labels == 3:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if num_labels == 1:
        assert (np.abs(out) <= 1.0).all()


@pytest.mark.parametrize("num_labels", [1, 3])
def test_predictor_frame_level_matches_jax(num_labels):
    """Frame-level mode: 30 native-rate frames per modality beside 12 text
    tokens (joint pass [2B, 42]), a ragged split whose frame counts vary,
    f32 within the same atol as the word-aligned case."""
    exp = experiment(num_labels, pair_seq_length=30)
    jax_pred, pred = both_predictors(exp, seed=num_labels)
    split = synthetic_split(10, 12, 5, 7, vocab_size=120,
                            num_labels=num_labels, seed=num_labels,
                            pair_seq_length=30)
    assert split.visual.shape == (10, 30, 5)
    assert (np.abs(split.visual).sum(-1) == 0).any()  # padded frames
    ref = jax_pred.predict_split(split)
    out = pred.predict_split(split)
    assert out.shape == ref.shape == (10,)
    if num_labels == 3:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_predictor_padding_does_not_change_results():
    """The zero-padded rows of the last batch do not leak into real rows:
    batch 4 (ragged) and batch 16 (one padded batch) agree."""
    exp = experiment()
    _, pred = both_predictors(exp)
    params = pred.params
    split = synthetic_split(10, 12, 5, 7, vocab_size=120, seed=5)
    wide = Predictor(exp, params, 16, torch.device("cpu"))
    np.testing.assert_allclose(pred.predict_split(split),
                               wide.predict_split(split), atol=1e-6, rtol=0)


@pytest.mark.parametrize("num_labels", [1, 7, 3])
def test_predictor_bf16_matches_jax_bf16(num_labels):
    """Both Predictors in bf16 on the same weights, ragged split.  The
    fusion head's weights are scaled up so that predictions spread over
    tanh's range: at init they are all ~1e-4, where any drift hides."""
    exp = experiment(num_labels)
    jparams = jax.device_get(init_mmbert_params(jax.random.key(num_labels),
                                                exp.model))
    fusion = jparams["fusion"]
    for name in ("classifier1", "classifier2"):
        fusion[name]["kernel"] = np.asarray(fusion[name]["kernel"]) * 100.0
    split = synthetic_split(10, 12, 5, 7, vocab_size=120,
                            num_labels=num_labels, seed=num_labels)
    ref32 = both_predictors(exp, jparams=jparams)[0].predict_split(split)
    jax_pred, pred = both_predictors(with_dtype(exp, "bfloat16"),
                                     jparams=jparams)
    assert pred.params["bert"]["layers"][0]["q"]["weight"].dtype == \
        torch.bfloat16
    ref = jax_pred.predict_split(split)
    out = pred.predict_split(split)
    assert out.shape == ref.shape == (10,)
    if num_labels == 3:
        np.testing.assert_array_equal(out, ref)
        return
    assert np.abs(ref32).max() > 0.1  # the head spreads the predictions
    noise = np.abs(ref - ref32).max()
    assert noise > 0
    err = np.abs(out - ref).max()
    assert err <= BF16_NOISE_FACTOR * noise, (
        f"port vs JAX bf16 {err:.3g}, JAX bf16 vs f32 {noise:.3g}")


def test_predictor_bf16_on_cpu_tracks_f32():
    exp = experiment()
    exp16 = with_dtype(exp, "bfloat16")
    _, pred = both_predictors(exp)
    pred16 = Predictor(exp16, pred.params, 4, torch.device("cpu"))
    assert pred16.params["bert"]["layers"][0]["q"]["weight"].dtype == \
        torch.bfloat16
    assert pred16.params["bert"]["layers"][0]["attn_ln"]["scale"].dtype == \
        torch.float32
    split = synthetic_split(6, 12, 5, 7, vocab_size=120, seed=2)
    # bf16 compute: ~3 significant digits through two layers
    np.testing.assert_allclose(pred16.predict_split(split),
                               pred.predict_split(split), atol=3e-2, rtol=0)


@pytest.mark.parametrize("train_kw,kw", [
    ({}, {"fuse_qkv": True}),
    ({"data_parallel": 2}, {}),
    ({"model_parallel": 2}, {}),
])
def test_predictor_refuses_what_is_not_ported(train_kw, kw):
    """Data and model parallelism in one process raise make_mesh's
    ValueError (the ranks come from a process group:
    test_torch_data_parallel.py, test_torch_tensor_parallel.py).  fuse_qkv,
    refused until it was ported,
    is taken: with an int8 mode each layer gets one fused "qkv"
    projection; without ``quantize`` it is ignored, as in JAX."""
    exp = experiment()
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             **train_kw))
    if kw.get("fuse_qkv"):
        _, pred = both_predictors(exp)
        h = exp.model.bert.hidden_size
        layer = Predictor(exp, pred.params, 4, "cpu", quantize="int8",
                          **kw).params["bert"]["layers"][0]
        assert layer["qkv"]["qweight"].shape == (3 * h, h)
        assert not {"q", "k", "v"} & set(layer)
        layer = Predictor(exp, pred.params, 4, "cpu", **kw).params["bert"][
            "layers"][0]
        assert "qkv" not in layer and "weight" in layer["q"]
        return
    with pytest.raises(ValueError, match="requested 2 ranks, have 1"):
        Predictor(exp, {}, 4, torch.device("cpu"), **kw)


def test_predictor_runs_on_the_card_unless_asked_for_the_cpu():
    """``Predictor(config, params)`` defaults to batch 8 on CUDA; without a
    card that raises instead of quietly serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would serve on it")
    exp = experiment()
    _, pred = both_predictors(exp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(exp, pred.params)
    assert Predictor(exp, pred.params, device="cpu").batch_size == 8


def test_serve_stream_roundtrip_and_error_line():
    """Mirrors tests/test_serve_cli.py: valid lines are answered with the
    JAX Predictor's predictions for the same requests, an invalid line
    (bad JSON, misaligned frames) yields an error line and the service
    goes on."""
    vocab = make_test_vocab(extra_words=["love", "hate", "this"])
    exp = experiment(vocab_size=len(vocab))
    jax_pred, pred = both_predictors(exp, batch_size=2)
    reqs = [
        {"id": "a", "words": ["love", "this", "movie"],
         "visual": [[0.1] * 5] * 3, "speech": [[0.2] * 7] * 3},
        {"id": "b", "words": ["hate", "this"]},  # modalities absent
        "NOT JSON",
        {"id": "x", "words": ["love", "this"], "visual": [[0.1] * 5] * 7},
        {"id": "c", "words": ["movie"], "speech": [[0.3] * 7]},
    ]
    text = "".join((r if isinstance(r, str) else json.dumps(r)) + "\n"
                   for r in reqs)
    tokenizer = Tokenizer(vocab)
    fout = io.StringIO()
    counts = serve_stream(pred, tokenizer, io.StringIO(text), fout,
                          batch_size=2, max_wait=0.05, drain_flush=True)
    assert counts == {"answered": 3, "errors": 2}
    lines = [json.loads(x) for x in fout.getvalue().splitlines()]
    errors = {x["id"]: x["error"] for x in lines if "error" in x}
    assert set(errors) == {None, "x"}
    assert "one row per word" in errors["x"]
    got = {x["id"]: x["prediction"] for x in lines if "prediction" in x}
    assert set(got) == {"a", "b", "c"}

    # the same requests through the JAX Predictor
    from msa_tpu.cli.serve import featurize_request
    splits = [featurize_request(r, tokenizer, 12, None, 5, 7)
              for r in reqs if isinstance(r, dict) and r["id"] != "x"]
    ref = jax_pred.predict_arrays(
        *(np.concatenate([getattr(s, f) for s in splits])
          for f in ("input_ids", "attention_mask", "visual", "speech")))
    np.testing.assert_allclose([got[i] for i in "abc"], ref, atol=ATOL, rtol=0)


def test_serve_stream_frame_level_matches_jax():
    """A frame-level model takes native-rate frames: any number of rows per
    request (up to Lp; more are cut to Lp), answered as the JAX Predictor
    answers the same requests featurized by JAX's service."""
    vocab = make_test_vocab(extra_words=["love", "hate", "this"])
    exp = experiment(vocab_size=len(vocab), pair_seq_length=16)
    jax_pred, pred = both_predictors(exp, batch_size=2)
    reqs = [
        {"id": "a", "words": ["love", "this", "movie"],
         "visual": [[0.1 * i] * 5 for i in range(1, 10)],
         "speech": [[0.2] * 7] * 4},
        {"id": "b", "words": ["hate", "this"]},  # modalities absent
        {"id": "c", "words": ["movie"], "speech": [[0.3] * 7] * 21},  # > Lp
        "NOT JSON",
    ]
    text = "".join((r if isinstance(r, str) else json.dumps(r)) + "\n"
                   for r in reqs)
    tokenizer = Tokenizer(vocab)
    fout = io.StringIO()
    counts = serve_stream(pred, tokenizer, io.StringIO(text), fout,
                          batch_size=2, max_wait=0.05, drain_flush=True)
    assert counts == {"answered": 3, "errors": 1}
    lines = [json.loads(x) for x in fout.getvalue().splitlines()]
    got = {x["id"]: x["prediction"] for x in lines if "prediction" in x}
    assert set(got) == {"a", "b", "c"}

    from msa_tpu.cli.serve import featurize_request
    splits = [featurize_request(r, tokenizer, 12, 16, 5, 7)
              for r in reqs if isinstance(r, dict)]
    assert splits[0].visual.shape == (1, 16, 5)
    ref = jax_pred.predict_arrays(
        *(np.concatenate([getattr(s, f) for s in splits])
          for f in ("input_ids", "attention_mask", "visual", "speech")))
    np.testing.assert_allclose([got[i] for i in "abc"], ref, atol=ATOL, rtol=0)


def test_port_imports_and_serves_without_jax():
    """Every msa_tpu_torch module imports, a CPU Predictor serves (bf16 and
    int8) and a Trainer takes a train step, with jax, the JAX package, flax
    and msgpack blocked (a subprocess: this process already imported them).
    The port reaches its configs and data through its own copies."""
    code = """
import importlib, pkgutil, sys
BLOCKED = {"jax", "msa_tpu", "flax", "msgpack"}
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np, torch
import msa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(msa_tpu_torch.__path__,
                                               "msa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from msa_tpu_torch.configs import (DataConfig, ExperimentConfig, MMBertConfig,
                                   TrainConfig, tiny_bert_config)
from msa_tpu_torch.data import MultimodalDataset, synthetic_split
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.weights import init_params
from msa_tpu_torch.training.trainer import Trainer
exp = ExperimentConfig(
    model_name="tiny",
    model=MMBertConfig(bert=tiny_bert_config(hidden_size=128,
                       num_attention_heads=2, vocab_size=120),
                       visual_dim=5, speech_dim=7),
    data=DataConfig(max_seq_length=12),
    train=TrainConfig(compute_dtype="float32", data_parallel=1,
                      train_batch_size=4))
params = init_params(exp.model, torch.Generator().manual_seed(0))
split = synthetic_split(5, 12, 5, 7, vocab_size=120)
out = Predictor(exp, params, 4, torch.device("cpu")).predict_split(split)
assert out.shape == (5,) and np.isfinite(out).all()
out = Predictor(exp, params, 4, "cpu", quantize="int8_static",
                calibration=split).predict_split(split)
assert out.shape == (5,) and np.isfinite(out).all()
trainer = Trainer(exp, "cpu", mask_token_id=4, special_ids=(0, 2, 3, 4))
state = trainer.init_state(0, 10, params=params)
batch = next(MultimodalDataset(split).epoch_batches(0, 4))
state, metrics = trainer.train_step(state, batch, base_seed=1)
assert state.step == 1 and np.isfinite(float(metrics["loss"]))
import tempfile
from msa_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, state, exp, epoch=1)
    back, meta = load_checkpoint(d, "cpu")
    assert back.step == 1 and back.opt_state.count == 1 and meta["epoch"] == 1
    out = Predictor.from_checkpoint(d, 4, "cpu",
                                    quantize="int8").predict_split(split)
    assert out.shape == (5,) and np.isfinite(out).all()
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert not loaded & BLOCKED, loaded & BLOCKED
print("modules", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    # _build, configs, data x5, ops x9, models x3, training x5, utils x2,
    # inference, cli x2
    assert n >= 29


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No file of msa_tpu_torch/, and not chip_smoke.py, imports jax,
    msa_tpu, flax, msgpack or the orbax stack (orbax, tensorstore,
    zstandard, numcodecs): the port keeps its own copies of the host
    modules, its own checkpoint codec and its own orbax reader."""
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|msa_tpu|flax|msgpack|orbax|"
        r"tensorstore|zstandard|numcodecs)(?:\.|\s|$)", re.MULTILINE)
    files = sorted(glob.glob(os.path.join(REPO, "msa_tpu_torch", "**", "*.py"),
                             recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    offenders = {}
    for path in files:
        with open(path) as f:
            hits = pattern.findall(f.read())
        if hits:
            offenders[os.path.relpath(path, REPO)] = hits
    assert not offenders, offenders


@pytest.mark.parametrize("words", [
    ["the", "movie", "was", "great"],
    ["REALLY", "Bad", "ACTing", "don't", "stop...", "now?!"],
    ["zebra", "quixotic", "", "x" * 150],
])
def test_port_fast_tokenizer_builds_on_the_host_route(tmp_path, words):
    """The port's native WordPiece encoder is built by ``_build``'s host
    route (``csrc/wordpiece.cpp``) and encodes as the Python tokenizer."""
    from msa_tpu_torch import _build
    from msa_tpu_torch.data.fast_wordpiece import FastTokenizer

    vocab = make_test_vocab(extra_words=["zebra", "qui", "##xo", "##tic",
                                         "movie", "great"])
    path = tmp_path / "vocab.txt"
    path.write_text("".join(t + "\n" for t in sorted(vocab, key=vocab.get)))
    fast = FastTokenizer(str(path))
    assert fast.native_available
    assert _build.library_path("wordpiece").exists()
    ids, inv = fast.encode_words(words)
    want = fast._encode_words_python(words)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(inv, want[1])
