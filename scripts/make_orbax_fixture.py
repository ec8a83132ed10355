"""Write ``tests/data/orbax_two_process/``: a sharded orbax checkpoint from a
two-process JAX run, the fixture the port's orbax reader is held to.

Two JAX processes on the CPU (two devices each) train a small MMBert at
dp = 2 x mp = 2 for one step and save it with the JAX package's
``save_checkpoint_auto`` into ``epoch_000/``, which a multi-process run
writes as an ``orbax/`` directory: an OCDBT store with one nested store a
process (``ocdbt.process_0``, ``ocdbt.process_1``) under a root manifest.
The parent then checks that ``meta.json`` parses (every process writes it),
restores the checkpoint in one process with JAX's
``load_checkpoint_sharded`` from where it was moved, and writes
``digests.json``: the SHA-256 of every leaf's C-order bytes as that restore
reads them, keyed by the leaf's path in the flax state dict joined by
``/``.

This script uses JAX and ``msa_tpu`` (the JAX package); the port does not.
Run it from the repository root:

    python scripts/make_orbax_fixture.py [--out tests/data/orbax_two_process]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "orbax_two_process")

CONFIG = textwrap.dedent("""
    from msa_tpu.configs import (DataConfig, ExperimentConfig, MMBertConfig,
                                 TrainConfig, tiny_bert_config)

    def experiment():
        bert = tiny_bert_config(hidden_size=64, num_attention_heads=2,
                                intermediate_size=128, vocab_size=120)
        return ExperimentConfig(
            model_name="tiny",
            model=MMBertConfig(bert=bert, visual_dim=47, speech_dim=74,
                               num_labels=1),
            data=DataConfig(dataset="mosi", max_seq_length=16),
            train=TrainConfig(compute_dtype="bfloat16", data_parallel=2,
                              model_parallel=2, train_batch_size=8,
                              adam_mu_dtype="bfloat16",
                              adam_nu_dtype="bfloat16"))
""")

WORKER = textwrap.dedent("""
    import os
    import jax
    jax.config.update("jax_platforms", "cpu")
    from msa_tpu.parallel.distributed import initialize
    initialize(coordinator_address=f"localhost:{os.environ['PORT']}",
               num_processes=2, process_id=int(os.environ["PROC_ID"]))
    assert jax.device_count() == 4 and jax.local_device_count() == 2
    from msa_tpu.data.dataset import MultimodalDataset
    from msa_tpu.data.featurize import synthetic_split
    from msa_tpu.training.checkpoint import save_checkpoint_auto
    from msa_tpu.training.trainer import Trainer
    exp = experiment()
    trainer = Trainer(exp, mask_token_id=4, special_ids=(0, 2, 3, 4))
    state = trainer.init_state(jax.random.key(0), 10)
    split = synthetic_split(8, 16, 47, 74, vocab_size=120, seed=0)
    batch = next(MultimodalDataset(split, seed=0).epoch_batches(0, 8))
    step = trainer._build_train_step()
    state, metrics = step(state, trainer._shard_batch(batch), trainer.rng(0))
    print("LOSS", float(jax.device_get(metrics["loss"])), flush=True)
    save_checkpoint_auto(os.path.join(os.environ["OUT"], "epoch_000"),
                         state, exp, epoch=0)
    print("SAVED", flush=True)
""")

RESTORE = textwrap.dedent("""
    import hashlib, json, os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from flax import serialization
    from msa_tpu.training.checkpoint import load_checkpoint_sharded
    from msa_tpu.training.trainer import Trainer
    exp = experiment()
    template = Trainer(exp, mask_token_id=4, special_ids=(0, 2, 3, 4)
                       ).init_state(jax.random.key(1), 10)
    state, meta = load_checkpoint_sharded(
        os.path.join(os.environ["OUT"], "epoch_000"), template)
    tree = serialization.to_state_dict(jax.device_get(state))
    digests = {}
    def walk(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, path + (str(key),))
        elif node is not None:
            data = np.ascontiguousarray(np.asarray(node)).tobytes()
            digests["/".join(path)] = hashlib.sha256(data).hexdigest()
    walk(tree, ())
    print("DIGESTS", json.dumps({"step": int(meta["step"]),
                                 "leaves": digests}), flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        written = os.path.join(tmp, "written")
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", CONFIG + WORKER],
            env=_env(PORT=port, PROC_ID=str(pid), OUT=written,
                     JAX_NUM_CPU_DEVICES="2"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        outs = [p.communicate(timeout=900)[0] for p in procs]
        for p, out in zip(procs, outs):
            if p.returncode != 0 or "SAVED" not in out:
                raise SystemExit(f"a JAX process failed:\n{out}")
        epoch = os.path.join(written, "epoch_000")
        with open(os.path.join(epoch, "meta.json")) as f:
            meta = json.load(f)  # every process writes it: it must parse
        assert meta["format"] == "orbax", meta
        assert os.path.isdir(os.path.join(epoch, "orbax", "ocdbt.process_1"))
        # restore where it was moved to, in one process
        if os.path.exists(args.out):
            shutil.rmtree(args.out)
        shutil.move(written, args.out)
        proc = subprocess.run(
            [sys.executable, "-c", CONFIG + RESTORE],
            env=_env(OUT=args.out, XLA_FLAGS=(
                "--xla_force_host_platform_device_count=4")),
            capture_output=True, text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith("DIGESTS ")]
        if proc.returncode != 0 or not lines:
            raise SystemExit(f"the JAX restore failed:\n{proc.stdout}"
                             f"{proc.stderr}")
    digests = json.loads(lines[-1][len("DIGESTS "):])
    digests["loss"] = [float(l.split()[1]) for l in outs[0].splitlines()
                       if l.startswith("LOSS ")][0]
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(args.out) for n in names)
    print(f"wrote {args.out}: {len(digests['leaves'])} leaves, {size} bytes")


if __name__ == "__main__":
    main()
