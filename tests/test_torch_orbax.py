"""msa_tpu_torch's reader of the JAX package's sharded orbax checkpoints.

A multi-process JAX run saves ``orbax/`` (``save_checkpoint_sharded``): an
OCDBT key-value store of zarr v2 arrays, every node and chunk compressed
with zstd.  The port reads it with its own modules
(``training/zstd.py`` over ``csrc/zstd_decode.cpp``, ``training/ocdbt.py``,
``training/orbax_reader.py``), with no orbax, tensorstore or zstd library.
Here JAX writes the checkpoints (on the 8-device CPU mesh at dp = 4, mp = 2,
and the committed two-process fixture) and the port must read every leaf
bit-equal to JAX's own restore, give the same ``TrainState`` as the msgpack
form of the same state, and serve, sample and resume from it as from
msgpack.  The decoder is held to libzstd's frames (written through
tensorstore's zarr arrays), and corrupt files raise.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

import jax
import tensorstore as ts
from flax import serialization

from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split as jax_synthetic_split
from msa_tpu.data.wordpiece import make_test_vocab
from msa_tpu.training import checkpoint as jax_ckpt
from msa_tpu.training.trainer import Trainer as JaxTrainer
from msa_tpu_torch.cli import sample as port_sample
from msa_tpu_torch.cli.serve import main as serve_main
from msa_tpu_torch.data import MultimodalDataset, synthetic_split
from msa_tpu_torch.inference import Predictor
from msa_tpu_torch.models.weights import named_leaves
from msa_tpu_torch.training import checkpoint as ckpt
from msa_tpu_torch.training import ocdbt, orbax_reader, zstd
from msa_tpu_torch.training.trainer import Trainer
from test_checkpoint_orbax import tiny_exp

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "orbax_two_process")
SPECIAL = dict(mask_token_id=4, special_ids=(0, 2, 3, 4))


def leaf_bytes(x) -> bytes:
    """A leaf's C-order bytes (a bf16 tensor's by its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def flat(tree, path=()):
    """{path joined by '/': leaf} of a nested dict; an empty dict is kept
    as one entry."""
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out["/".join(path)] = {}
        for key, value in tree.items():
            out.update(flat(value, path + (str(key),)))
    else:
        out["/".join(path)] = tree
    return out


def assert_bit_equal(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            assert g == {}, key
            continue
        assert isinstance(g, torch.Tensor) == (str(np.asarray(w).dtype) ==
                                               "bfloat16"), key
        g_dtype = "bfloat16" if isinstance(g, torch.Tensor) else str(g.dtype)
        assert g_dtype == str(np.asarray(w).dtype), key
        assert tuple(g.shape) == np.asarray(w).shape, key
        assert leaf_bytes(g) == leaf_bytes(w), key


def assert_same_state(a, b):
    assert a.step == b.step
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        x, y = dict(named_leaves(x)), dict(named_leaves(y))
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k
    assert a.opt_state.count == b.opt_state.count
    assert a.opt_state.mini_step == b.opt_state.mini_step
    assert (a.opt_state.acc is None) == (b.opt_state.acc is None)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """JAX writes one state after a train step (non-zero moments) both
    ways: orbax from the dp = 4 x mp = 2 mesh, and msgpack; and restores
    the orbax form with its own reader."""
    root = tmp_path_factory.mktemp("orbax")
    exp = tiny_exp(4, 2)
    trainer = JaxTrainer(exp, **SPECIAL)
    state = trainer.init_state(jax.random.key(0), 10)
    split = jax_synthetic_split(8, 16, 5, 7, vocab_size=120, seed=0)
    batch = next(JaxDataset(split, seed=0).epoch_batches(0, 8))
    state, _ = trainer._build_train_step()(
        state, trainer._shard_batch(batch), jax.random.key(1))
    orbax_dir = str(root / "orbax_run" / "epoch_000")
    msgpack_dir = str(root / "msgpack_run" / "epoch_000")
    jax_ckpt.save_checkpoint_sharded(orbax_dir, state, exp, epoch=0)
    jax_ckpt.save_checkpoint(msgpack_dir, jax.device_get(state), exp, epoch=0)
    restored, _ = jax_ckpt.load_checkpoint_sharded(
        orbax_dir, trainer.init_state(jax.random.key(7), 10))
    return {"root": root, "exp": exp, "orbax": orbax_dir,
            "msgpack": msgpack_dir,
            "restored": serialization.to_state_dict(
                jax.device_get(restored))}


# ---------------------------------------------------------------------------
# (a, b) the tree and the TrainState
# ---------------------------------------------------------------------------


def test_every_leaf_equals_jax_restore(written):
    tree = orbax_reader.read_state(os.path.join(written["orbax"], "orbax"))
    assert_bit_equal(tree, written["restored"])
    params = orbax_reader.read_state(os.path.join(written["orbax"], "orbax"),
                                     only=("params",))
    assert set(params) == {"params"}
    assert_bit_equal(params["params"], written["restored"]["params"])


def test_load_checkpoint_equals_msgpack_form(written):
    a, meta_a = ckpt.load_checkpoint(written["orbax"], "cpu")
    b, meta_b = ckpt.load_checkpoint(written["msgpack"], "cpu")
    assert_same_state(a, b)
    assert a.step == 1 and a.opt_state.count == 1
    assert meta_a == dict(meta_b, format="orbax")
    pa = dict(named_leaves(ckpt.load_params(written["orbax"], "cpu")))
    pb = dict(named_leaves(b.params))
    assert set(pa) == set(pb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    # a run directory resolves to its newest epoch, as for msgpack
    run = os.path.dirname(written["orbax"])
    assert ckpt.resolve_checkpoint(run) == written["orbax"]


# ---------------------------------------------------------------------------
# (c) serving and sampling
# ---------------------------------------------------------------------------


def port_split(exp, n=6, seed=3):
    return synthetic_split(n, exp.data.max_seq_length, exp.model.visual_dim,
                           exp.model.speech_dim, vocab_size=120, seed=seed)


def test_predictor_from_checkpoint_same_on_both_forms(written):
    split = port_split(written["exp"])
    # the run was saved at dp = 4 x mp = 2; it serves on one rank
    out = [Predictor.from_checkpoint(os.path.dirname(written[form]),
                                     batch_size=4, device="cpu"
                                     ).predict_split(split)
           for form in ("orbax", "msgpack")]
    assert out[0].shape == (6,) and np.isfinite(out[0]).all()
    np.testing.assert_array_equal(out[0], out[1])


def test_cli_sample_same_on_both_forms(written, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    preds = [port_sample.main(["--checkpoint", written[form], "--device",
                               "cpu", "--synthetic", "8", "--batch_size",
                               "4"])[0] for form in ("orbax", "msgpack")]
    assert np.isfinite(preds[0]).all()
    np.testing.assert_array_equal(preds[0], preds[1])


def test_cli_serve_same_on_both_forms(written, tmp_path):
    vocab = make_test_vocab(extra_words=["love", "hate", "this", "movie"])
    assert max(vocab.values()) < 120
    vocab_path = tmp_path / "vocab.txt"
    vocab_path.write_text("".join(t + "\n" for t in
                                  sorted(vocab, key=vocab.get)))
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(5):
        n = int(rng.integers(1, 6))
        reqs.append(json.dumps({
            "id": f"r{i}", "words": ["love", "this", "movie", "hate"][:n],
            "visual": rng.standard_normal((min(n, 4), 5)).round(3).tolist(),
            "speech": rng.standard_normal((min(n, 4), 7)).round(3).tolist()}))
    requests = tmp_path / "requests.jsonl"
    requests.write_text("\n".join(reqs) + "\n")
    answers = []
    for form in ("orbax", "msgpack"):
        out = tmp_path / f"{form}.jsonl"
        assert serve_main(["--checkpoint", os.path.dirname(written[form]),
                           "--vocab", str(vocab_path), "--batch_size", "4",
                           "--input", str(requests), "--output", str(out),
                           "--device", "cpu"]) == 0
        answers.append([json.loads(x) for x in out.read_text().splitlines()])
    assert len(answers[0]) == 5
    assert all("prediction" in a for a in answers[0]), answers[0]
    assert answers[0] == answers[1]


# ---------------------------------------------------------------------------
# (d) resume
# ---------------------------------------------------------------------------


def resume_and_fit(directory):
    """The calls ``cli.train --resume`` makes (``cli/train.py``), then one
    epoch of ``Trainer.fit``."""
    exp = ckpt.load_config(directory)
    loaded, meta = ckpt.load_checkpoint(directory, "cpu")
    start_epoch = int(meta.get("epoch", -1)) + 1
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, data_parallel=1, model_parallel=1,
        n_epochs=start_epoch + 1, train_batch_size=8))
    trainer = Trainer(exp, "cpu", **SPECIAL)
    state = trainer.init_state(exp.train.seed, 4, params=loaded.params)
    state.opt_state = trainer.local_opt_state(loaded.opt_state)
    state.step = loaded.step
    data = [MultimodalDataset(port_split(exp, 16, seed), seed=0)
            for seed in (0, 1, 2)]
    state, result = trainer.fit(state, *data, logger=None,
                                start_epoch=start_epoch)
    return state, result


def test_resume_same_on_both_forms(written):
    (a, ra), (b, rb) = (resume_and_fit(written[form])
                        for form in ("orbax", "msgpack"))
    assert a.step == b.step == 3
    timing = {"samples_per_sec", "seconds"}  # the wall clock's, not the run's
    for x, y in zip(ra.history, rb.history, strict=True):
        assert {k: v for k, v in x["train"].items() if k not in timing} == \
            {k: v for k, v in y["train"].items() if k not in timing}
        assert dict(x, train=None) == dict(y, train=None)
    assert np.isfinite(ra.history[0]["train"]["loss"])
    assert_same_state(a, b)


# ---------------------------------------------------------------------------
# The two-process fixture (scripts/make_orbax_fixture.py)
# ---------------------------------------------------------------------------


def test_two_process_fixture_matches_jax_digests():
    """Every leaf of the committed two-process checkpoint (one nested store
    a process under the root manifest) against the SHA-256 of JAX's
    restore of it; the root's references reach both processes' files."""
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        want = json.load(f)
    directory = os.path.join(FIXTURE, "epoch_000")
    tree = orbax_reader.read_state(os.path.join(directory, "orbax"))
    got = {k: hashlib.sha256(leaf_bytes(v)).hexdigest()
           for k, v in flat(tree).items() if not isinstance(v, dict)}
    assert got == want["leaves"]
    store = ocdbt.KvStore(os.path.join(directory, "orbax"))
    files = {store.locate(k).path.split("/")[0] for k in store.keys()
             if isinstance(store.locate(k), ocdbt.Ref)}
    assert files == {"ocdbt.process_0", "ocdbt.process_1"}
    state, meta = ckpt.load_checkpoint(directory, "cpu")
    assert state.step == want["step"] == meta["step"]


# ---------------------------------------------------------------------------
# (e) the decoder against libzstd's frames
# ---------------------------------------------------------------------------


def block_types(frame: bytes):
    """The type (0 raw, 1 RLE, 2 compressed) of each block of a frame."""
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
    pos += ((1 if fhd & 0x20 else 0), 2, 4, 8)[fhd >> 6]
    types = []
    while True:
        (head,) = struct.unpack("<I", frame[pos:pos + 3] + b"\0")
        kind, size = (head >> 1) & 3, head >> 3
        types.append(kind)
        pos += 3 + (1 if kind == 1 else size)
        if head & 1:
            return types


def zarr_chunks(path, data: np.ndarray, chunks, level, dtype):
    """The raw chunk files tensorstore's zarr store writes for ``data``
    (zstd at ``level``)."""
    store = ts.open({"driver": "zarr", "kvstore": f"file://{path}",
                     "metadata": {"compressor": {"id": "zstd",
                                                 "level": level},
                                  "dtype": dtype, "chunks": list(chunks)}},
                    create=True, shape=data.shape,
                    dtype=ts.bfloat16 if dtype == "bfloat16" else
                    data.dtype).result()
    store.write(data).result()
    out = []
    for index in np.ndindex(*[s // c for s, c in zip(data.shape, chunks)]):
        with open(os.path.join(path, ".".join(map(str, index))), "rb") as f:
            frame = f.read()
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(index, chunks))
        out.append((frame, np.ascontiguousarray(data[sl])))
    return out


@pytest.mark.parametrize("level", [1, 3, 19])
def test_decoder_matches_libzstd_frames(tmp_path, level):
    """All-zero chunks (RLE blocks), random bits (raw blocks), bf16
    weights and a 1.25 MB chunk (many compressed blocks)."""
    rng = np.random.default_rng(level)
    weights = (rng.standard_normal((512, 64)) * 0.02).astype(np.float32)
    cases = {
        "zeros": (np.zeros((512, 256), np.float32), (256, 256), "<f4"),
        "random": (rng.integers(0, 2**32, (64, 256), dtype=np.uint32)
                   .view(np.float32), (32, 256), "<f4"),
        "bf16": (weights.astype(jax.numpy.bfloat16), (128, 64), "bfloat16"),
        "large": (np.repeat(rng.standard_normal((1, 640)).astype(np.float32),
                            512, axis=0)
                  + rng.integers(0, 3, (512, 640)).astype(np.float32),
                  (512, 640), "<f4"),
    }
    seen = {}
    for name, (data, chunks, dtype) in cases.items():
        pairs = zarr_chunks(str(tmp_path / name), data, chunks, level, dtype)
        out = zstd.decompress([f for f, _ in pairs],
                              outs=[np.empty(d.nbytes, np.uint8)
                                    for _, d in pairs])
        for (frame, want), got in zip(pairs, out):
            assert got.tobytes() == want.tobytes(), name
        seen[name] = [t for f, _ in pairs for t in block_types(f)]
    assert 1 in seen["zeros"] and 0 in seen["random"]
    assert seen["large"].count(2) > 1
    assert cases["large"][0].nbytes >= 1 << 20
    # straight into a destination, as the reader decodes into a leaf
    frame, want = pairs[0]
    dest = np.empty(want.nbytes, np.uint8)
    assert zstd.decompress([frame], outs=[dest])[0] is dest
    assert dest.tobytes() == want.tobytes()


def test_committed_large_chunk_decodes():
    """The committed chunk of a large leaf (``scripts/make_zstd_chunk.py``:
    1 MiB of bf16 weights through tensorstore's zarr driver, zstd level 1),
    the frame ``chip_smoke.py`` times the decoder on: eight compressed
    blocks, decoded to the SHA-256 of its source."""
    directory = os.path.join(REPO, "tests", "data", "zstd_chunk")
    with open(os.path.join(directory, "chunk.json")) as f:
        meta = json.load(f)
    with open(os.path.join(directory, "chunk.zst"), "rb") as f:
        frame = f.read()
    assert [t for t in block_types(frame) if t != 0] == [2] * 8
    dest = np.empty(meta["decoded_bytes"], np.uint8)
    zstd.decompress([frame], outs=[dest])
    assert hashlib.sha256(dest.tobytes()).hexdigest() == meta["sha256"]


def test_crc32c_and_content_size():
    assert zstd.crc32c(b"123456789") == 0xE3069283  # the standard check
    assert zstd.crc32c(b"") == 0
    magic = b"\x28\xb5\x2f\xfd"
    raw_block = bytes([3 << 3 | 1, 0, 0]) + b"abc"  # last, raw, 3 bytes
    sized = magic + bytes([0x20, 3]) + raw_block  # single segment, size 3
    unsized = magic + bytes([0x00, 0x08]) + raw_block  # a window, no size
    assert zstd.content_size(sized) == 3
    assert zstd.content_size(unsized) is None
    assert [x.tobytes() for x in zstd.decompress([sized, unsized,
                                                  sized + unsized])] == [
        b"abc", b"abc", b"abcabc"]
    with pytest.raises(zstd.ZstdError, match="stated content size"):
        zstd.decompress([magic + bytes([0x20, 4]) + raw_block],
                        outs=[np.empty(4, np.uint8)])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress([magic + bytes([0x21, 7, 3]) + raw_block])


# ---------------------------------------------------------------------------
# (f) corruption raises
# ---------------------------------------------------------------------------


def copy_fixture(tmp_path):
    directory = str(tmp_path / "fixture")
    shutil.copytree(FIXTURE, directory)
    return os.path.join(directory, "epoch_000")


def flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([byte ^ 0x10]))


@pytest.mark.parametrize("where", ["manifest", "node"])
def test_flipped_byte_in_a_store_file_raises(tmp_path, where):
    directory = copy_fixture(tmp_path)
    store = ocdbt.KvStore(os.path.join(directory, "orbax"))
    store.keys()
    if where == "manifest":
        path = os.path.join(directory, "orbax", "manifest.ocdbt")
    else:
        path = os.path.join(directory, "orbax", store._root.path)
    flip(path, os.path.getsize(path) // 2)
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ckpt.load_checkpoint(directory, "cpu")


def test_flipped_byte_in_a_frame_raises(tmp_path):
    directory = copy_fixture(tmp_path)
    root = os.path.join(directory, "orbax")
    store = ocdbt.KvStore(root)
    ref = store.locate("params.bert.embeddings.word/0.0")
    assert isinstance(ref, ocdbt.Ref)
    frame = bytes(store.read_refs([ref])[0])
    # magic, frame header byte, window byte: then the first block's header,
    # whose type bits set to 3 make a reserved block type
    assert frame[:5] == b"\x28\xb5\x2f\xfd\x00"
    flip(os.path.join(root, ref.path), ref.offset + 6)
    with open(os.path.join(root, ref.path), "r+b") as f:
        f.seek(ref.offset + 6)
        f.write(bytes([frame[6] | 0x06]))
    with pytest.raises(zstd.ZstdError, match="reserved"):
        ckpt.load_params(directory, "cpu")
    # a frame cut short; a compressed block of no bytes
    spec = json.loads(store.read("params.bert.embeddings.word/.zarray"))
    size = int(np.prod(spec["chunks"])) * 4
    for bad in (frame[:len(frame) // 2],
                frame[:6] + bytes([0x05, 0, 0]) + frame[9:]):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress([bad], outs=[np.empty(size, np.uint8)])


def test_checksum_mismatch_raises():
    zstandard = pytest.importorskip("zstandard")
    data = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                      .compress(data.tobytes()))
    assert zstd.decompress([bytes(frame)])[0].tobytes() == data.tobytes()
    frame[-6] ^= 1  # the last block's bytes: only the checksum can tell
    with pytest.raises(zstd.ZstdError):
        zstd.decompress([bytes(frame)])


# ---------------------------------------------------------------------------
# (g) the tree's shapes: interior nodes, inline and indirect values
# ---------------------------------------------------------------------------


def test_store_with_interior_nodes_and_versions(tmp_path, written):
    """A store written with tensorstore's own ``ocdbt`` kvstore, with
    small nodes (height > 0) and twenty commits (older versions in the
    manifest), read key for key; the checkpoints' own stores hold inline
    and indirect values."""
    path = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": {"max_decoded_node_bytes": 2048,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(0)
    want = {}
    for commit in range(20):
        txn = ts.Transaction()
        for i in range(150):
            key = f"leaf.{i % 37}.name{commit * 150 + i:05d}/{i % 7}"
            want[key] = rng.bytes(int(rng.integers(0, 40)))
            kv.with_transaction(txn)[key] = want[key]
        txn.commit_sync()
    store = ocdbt.KvStore(path)
    keys = store.keys()
    assert keys == sorted(want)
    assert store.read_many(keys) == [want[k] for k in keys]
    assert store.stats["height"] > 0 and store.stats["interior_nodes"] > 0
    assert store.stats["inline_values"] > 0
    assert store.stats["indirect_values"] > 0
    # a prefix walks only the subtrees that can hold it
    sub = ocdbt.KvStore(path)
    assert sub.keys("leaf.3.") == sorted(k for k in want
                                         if k.startswith("leaf.3."))
    assert sub.stats["leaf_nodes"] < store.stats["leaf_nodes"]
    for directory in (os.path.join(written["orbax"], "orbax"),
                      os.path.join(FIXTURE, "epoch_000", "orbax")):
        s = ocdbt.KvStore(directory)
        s.keys()
        assert s.stats["inline_values"] > 0 and s.stats["indirect_values"] > 0


# ---------------------------------------------------------------------------
# Layouts the reader refuses
# ---------------------------------------------------------------------------


def rewrite_json(path, **changes):
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.mark.parametrize("change,match", [
    ({"use_ocdbt": False}, "use_ocdbt"),
    ("numbered", "manifest kind 1"),
    ("dtype", "'<c8'"),
    ("compressor", "'blosc'"),
])
def test_other_layouts_are_refused(tmp_path, change, match):
    directory = copy_fixture(tmp_path)
    root = os.path.join(directory, "orbax")
    if isinstance(change, dict):
        rewrite_json(os.path.join(root, "_METADATA"), **change)
    elif change == "numbered":
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            data = bytearray(f.read())
        body = bytearray(zstd.decompress([bytes(data[14:-4])])[0])
        body[16] = 1  # the manifest kind, after the uuid
        data = data[:13] + b"\x00" + body  # stored uncompressed
        data[4:12] = struct.pack("<Q", len(data) + 4)
        data += struct.pack("<I", zstd.crc32c(bytes(data)))
        with open(path, "wb") as f:
            f.write(data)
    else:
        # an array's .zarray is an inline value of a node: rewrite it as a
        # new version of the store, through tensorstore
        kv = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{root}"}).result()
        key = "params.fusion.classifier1.bias/.zarray"
        spec = json.loads(kv.read(key).result().value)
        if change == "dtype":
            spec["dtype"] = "<c8"
        else:
            spec["compressor"] = {"id": "blosc"}
        kv[key] = json.dumps(spec).encode()
    with pytest.raises(NotImplementedError, match=match):
        ckpt.load_checkpoint(directory, "cpu")
