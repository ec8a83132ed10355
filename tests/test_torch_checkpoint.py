"""msa_tpu_torch's checkpoints and service CLI against the JAX package.

The port reads and writes the JAX package's msgpack checkpoints with its
own codec (``training/msgpack_codec.py``): it must encode every value as
``msgpack`` with flax's extension types does, byte for byte, and decode
what they write.  A checkpoint written by JAX's ``save_checkpoint`` loads
in the port with every leaf equal (after the layout change), and one
written by the port loads in JAX's ``load_checkpoint`` with every leaf
equal, for each shape of the optax state ``make_optimizer`` builds.  The
service CLI answers as JAX's on the same checkpoint and requests, within
PRED_ATOL (f32; summation order, as tests/test_torch_quant.py states).
"""

import json

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from msa_tpu.cli.serve import main as jax_serve_main
from msa_tpu.configs import (
    DataConfig, ExperimentConfig, MMBertConfig, TrainConfig, tiny_bert_config,
)
from msa_tpu.data.wordpiece import make_test_vocab
from msa_tpu.inference import Predictor as JaxPredictor
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.training import checkpoint as jax_ckpt
from msa_tpu.training.optim import make_fused_optimizer, make_optimizer
from msa_tpu.training.train_state import TrainState as JaxTrainState
from msa_tpu_torch.cli.serve import main as serve_main
from msa_tpu_torch.configs import ExperimentConfig as PortExperimentConfig
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params, named_leaves)
from msa_tpu_torch.training import checkpoint as ckpt
from msa_tpu_torch.training import msgpack_codec as codec

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

PRED_ATOL = 2e-6


def flax_packb(obj) -> bytes:
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack,
                         strict_types=not isinstance(obj, tuple))


def flax_unpackb(data):
    return msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                           raw=False)


VALUES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**64 - 1, -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**63,
    1.5, -0.0, float("inf"), "", "a" * 31, "a" * 32, "a" * 256, "é" * 40000,
    b"", b"x" * 300, b"y" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, {"x": None}] for i in range(16)}, (1, "2"), 1 + 2j,
    np.zeros((2, 3), np.float32), np.arange(5, dtype=np.int32),
    np.zeros((), np.int32), np.arange(6, dtype=np.int64).reshape(3, 2).T,
    np.zeros((0, 4), np.float32), np.int32(7), np.float32(2.5), np.bool_(True),
]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__)
def test_codec_encodes_and_decodes_as_msgpack_with_flax_types(value):
    ref = flax_packb(value)
    assert codec.packb(value) == ref
    got, want = codec.unpackb(ref), flax_unpackb(ref)
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_codec_bfloat16_through_torch():
    """bf16 leaves (JAX's bf16 Adam moments) decode to bf16 torch tensors
    and encode from them, byte-equal to flax's."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"mu": np.asarray(x), "scalar": np.asarray(x[0, 0])}
    ref = serialization.msgpack_serialize(tree)
    got = codec.unpackb(ref)
    assert got["mu"].dtype == torch.bfloat16 and got["mu"].shape == (3, 5)
    np.testing.assert_array_equal(got["mu"].float().numpy(),
                                  np.asarray(x, np.float32))
    assert got["scalar"].shape == ()
    assert codec.packb(got) == ref
    back = serialization.msgpack_restore(codec.packb(got))
    assert back["mu"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(back["mu"], np.asarray(x))


def test_codec_refuses_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    chunked = serialization.msgpack_serialize({"w": np.zeros(10, np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        codec.unpackb(chunked)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 16)
    with pytest.raises(ValueError, match="chunked"):
        codec.packb({"w": np.zeros(10, np.float32)})


def experiment(vocab_size=120, **train_kw):
    bert = tiny_bert_config(hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=256,
                            vocab_size=vocab_size)
    return ExperimentConfig(
        model_name="tiny",
        model=MMBertConfig(bert=bert, visual_dim=5, speech_dim=7, num_labels=1),
        data=DataConfig(dataset="mosi", max_seq_length=12),
        train=TrainConfig(compute_dtype="float32", data_parallel=1,
                          **train_kw))


# the optax state's shapes: optax.adamw inside the chain (nu f32), the
# casted Adam flattened into it with clipping (nu bf16), MultiSteps; and
# FusedAdamW's {"count", "mu", "nu"} (fused_optimizer, bf16 moments)
OPTIMIZERS = {
    "adamw": {},
    "clip_bf16_moments": {"max_grad_norm": 1.0, "adam_mu_dtype": "bfloat16",
                          "adam_nu_dtype": "bfloat16"},
    "accumulate": {"gradient_accumulation_steps": 2},
    "fused": {"fused_optimizer": True, "max_grad_norm": 1.0,
              "adam_mu_dtype": "bfloat16", "adam_nu_dtype": "bfloat16"},
}


def jax_optimizer(train, total_steps):
    """(init, update) of the optimizer JAX's Trainer builds for ``train``:
    ``update(grads, state, params) -> state``."""
    if train.fused_optimizer:
        tx = make_fused_optimizer(train, total_steps, use_pallas=False)
        return tx.init, jax.jit(lambda g, s, p: tx.apply(p, g, s)[1])
    tx = make_optimizer(train, total_steps)
    return tx.init, jax.jit(lambda g, s, p: tx.update(g, s, p)[1])


def jax_state(exp, steps=3, seed=0):
    """A JAX TrainState after ``steps`` optimizer updates on random
    gradients (non-zero moments; with accumulation, a pending mini-step)."""
    params = jax.device_get(init_mmbert_params(jax.random.key(seed), exp.model))
    init, update = jax_optimizer(exp.train, 100)
    opt_state = init(params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        opt_state = update(grads, opt_state, params)
    return JaxTrainState(params=params, opt_state=jax.device_get(opt_state),
                         step=np.asarray(steps, np.int32))


def jax_template(exp):
    """The template JAX's Predictor.from_checkpoint restores into."""
    params = init_mmbert_params(jax.random.key(0), exp.model)
    return JaxTrainState(params=params,
                         opt_state=jax_optimizer(exp.train, 1)[0](params),
                         step=jnp.zeros((), jnp.int32))


def assert_same_leaves(got, want):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert set(got) == set(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype, path
        assert torch.equal(got[path], t), path


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, optimizer):
    exp = experiment(**OPTIMIZERS[optimizer])
    state = jax_state(exp)
    jax_ckpt.save_checkpoint(str(tmp_path), state, exp, epoch=4,
                             extra={"best_val": 0.25})
    loaded, meta = ckpt.load_checkpoint(str(tmp_path), "cpu")
    assert loaded.step == 3
    assert meta == {"epoch": 4, "step": 3, "best_val": 0.25}
    assert_same_leaves(loaded.params, from_jax_params(state.params, "cpu"))
    want = from_jax_opt_state(state.opt_state, "cpu")
    got = loaded.opt_state
    assert (got.count, got.mini_step) == (want.count, want.mini_step)
    assert got.count == (1 if optimizer == "accumulate" else 3)
    assert_same_leaves(got.mu, want.mu)
    assert_same_leaves(got.nu, want.nu)
    if optimizer == "accumulate":
        assert got.mini_step == 1
        assert_same_leaves(got.acc, want.acc)
    else:
        assert got.acc is None
    mu = dict(named_leaves(got.mu))["bert/layers/0/q/weight"]
    assert mu.dtype == (torch.bfloat16 if "adam_mu_dtype" in
                        OPTIMIZERS[optimizer] else torch.float32)
    assert ckpt.load_config(str(tmp_path)) == \
        PortExperimentConfig.from_json(exp.to_json())
    assert_same_leaves(ckpt.load_params(str(tmp_path), "cpu"), loaded.params)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_port_checkpoint_loads_in_jax(tmp_path, optimizer):
    exp = experiment(**OPTIMIZERS[optimizer])
    state = jax_state(exp, seed=1)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), state, exp, epoch=2)
    port_state, _ = ckpt.load_checkpoint(str(tmp_path / "jax"), "cpu")
    ckpt.save_checkpoint(str(tmp_path / "port"), port_state,
                         PortExperimentConfig.from_json(exp.to_json()),
                         epoch=2, extra={"note": "port"})
    loaded, meta = jax_ckpt.load_checkpoint(str(tmp_path / "port"),
                                            jax_template(exp))
    assert meta == {"epoch": 2, "step": 3, "note": "port"}
    assert jax.tree.structure(loaded) == jax.tree.structure(state)
    for got, want in zip(jax.tree.leaves(loaded), jax.tree.leaves(state)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert jax_ckpt.load_config(str(tmp_path / "port")) == exp
    if not exp.train.fused_optimizer:
        # JAX's Predictor restores into make_optimizer's state, which is
        # not FusedAdamW's: it reads no fused checkpoint, JAX's own either
        JaxPredictor.from_checkpoint(str(tmp_path / "port"), batch_size=4)


def test_resolve_checkpoint_and_model_num_as_jax(tmp_path):
    run = tmp_path / "run"
    for name in ("epoch_001", "epoch_003"):
        (run / name).mkdir(parents=True)
        (run / name / ckpt.STATE_FILE).write_bytes(b"")
    (run / "epoch_002").mkdir()            # no state: not a checkpoint
    (run / "epoch_x" / "orbax").mkdir(parents=True)  # not a number
    for fn in (ckpt.list_epoch_checkpoints, jax_ckpt.list_epoch_checkpoints):
        assert fn(str(run)) == [1, 3]
    for model_num in (None, 1, 3):
        assert ckpt.resolve_checkpoint(str(run), model_num) == \
            jax_ckpt.resolve_checkpoint(str(run), model_num)
    assert ckpt.resolve_checkpoint(str(run)).endswith("epoch_003")
    direct = str(run / "epoch_001")
    assert ckpt.resolve_checkpoint(direct) == direct
    for resolve in (ckpt.resolve_checkpoint, jax_ckpt.resolve_checkpoint):
        with pytest.raises(FileNotFoundError, match=r"\[1, 3\]"):
            resolve(str(run), 2)
        with pytest.raises(FileNotFoundError):
            resolve(str(tmp_path / "empty"))


def test_orbax_zarr3_checkpoint_is_refused(tmp_path):
    """An orbax directory is read (tests/test_torch_orbax.py) unless its
    arrays are zarr v3, which the JAX package never writes."""
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text(json.dumps(
        {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": True}))
    assert ckpt.resolve_checkpoint(str(tmp_path)) == str(tmp_path)
    with pytest.raises(NotImplementedError, match="zarr3"):
        ckpt.load_checkpoint(str(tmp_path), "cpu")


def test_serve_cli_int8_static_answers_as_jax(tmp_path):
    """``python -m msa_tpu_torch.cli.serve --device cpu --quantize
    int8_static --calibration ...`` on a JAX-written checkpoint against the
    JAX CLI on the same requests; invalid lines give error lines."""
    vocab = make_test_vocab(extra_words=["love", "hate", "this", "movie"])
    vocab_path = tmp_path / "vocab.txt"
    vocab_path.write_text("".join(t + "\n" for t in sorted(vocab, key=vocab.get)))
    exp = experiment(vocab_size=len(vocab))
    state = jax_state(exp, steps=1)
    for name in ("classifier1", "classifier2"):  # spread the predictions
        kernel = state.params["fusion"][name]["kernel"]
        state.params["fusion"][name]["kernel"] = np.asarray(kernel) * 30.0
    run = tmp_path / "run"
    jax_ckpt.save_checkpoint(str(run / "epoch_000"), state, exp, epoch=0)
    rng = np.random.default_rng(5)
    words = ["love", "hate", "this", "movie", "the"]
    reqs = []
    for i in range(9):
        n = int(rng.integers(1, 6))
        req = {"id": f"r{i}", "words": [words[j] for j in rng.integers(0, 5, n)]}
        if i % 3 != 2:
            req["visual"] = rng.standard_normal((n, 5)).round(3).tolist()
        if i % 3 != 1:
            req["speech"] = rng.standard_normal((n, 7)).round(3).tolist()
        reqs.append(json.dumps(req))
    reqs.insert(4, "NOT JSON")
    reqs.insert(7, json.dumps({"id": "bad", "words": ["love", "this"],
                               "visual": [[0.1] * 5] * 3}))
    requests = tmp_path / "requests.jsonl"
    requests.write_text("\n".join(reqs) + "\n")
    calibration = tmp_path / "calibration.jsonl"
    calibration.write_text("\n".join(r for r in reqs[:4]) + "\n")
    answers = {}
    for name, main, device in (("port", serve_main, ["--device", "cpu"]),
                               ("jax", jax_serve_main, [])):
        out = tmp_path / f"{name}.jsonl"
        assert main(["--checkpoint", str(run), "--vocab", str(vocab_path),
                     "--batch_size", "4", "--quantize", "int8_static",
                     "--calibration", str(calibration), "--input",
                     str(requests), "--output", str(out), *device]) == 0
        answers[name] = [json.loads(x) for x in out.read_text().splitlines()]
    port, ref = answers["port"], answers["jax"]
    assert [x.get("id") for x in port] == [x.get("id") for x in ref]
    errors = [x for x in port if "error" in x]
    assert [x["id"] for x in errors] == [None, "bad"]
    assert "one row per word" in errors[1]["error"]
    got = np.array([x["prediction"] for x in port if "prediction" in x])
    want = np.array([x["prediction"] for x in ref if "prediction" in x])
    assert len(got) == 9 and np.ptp(want) > 1e-3
    np.testing.assert_allclose(got, want, atol=PRED_ATOL, rtol=0)
    # the same as the in-process Predictor on the same checkpoint
    pred = Predictor.from_checkpoint(str(run), batch_size=4, device="cpu",
                                     quantize="int8")
    assert pred.config == PortExperimentConfig.from_json(exp.to_json())
    assert pred.params["bert"]["layers"][1]["wo"]["qweight"].dtype == torch.int8


def test_serve_cli_needs_calibration_for_int8_static(tmp_path):
    with pytest.raises(SystemExit, match="calibration"):
        serve_main(["--checkpoint", str(tmp_path), "--vocab", "v.txt",
                    "--quantize", "int8_static", "--device", "cpu"])
