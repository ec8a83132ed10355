"""Checkpoints in the JAX package's formats.

Counterpart of ``msa_tpu/training/checkpoint.py``: a checkpoint directory
holds ``state.msgpack`` (the train state as ``flax.serialization.to_bytes``
writes it: params, optax state and step, in the JAX layout), ``meta.json``
(epoch, step and extras) and ``config.json``.  A run directory keeps one
``epoch_NNN`` subdirectory per retained epoch.  The port reads and writes
these files with its own codec (``msgpack_codec.py``), so a checkpoint
written by either package loads in the other.

A multi-process JAX run writes an ``orbax/`` subdirectory in place of
``state.msgpack`` (``save_checkpoint_sharded``: an OCDBT store of zarr
arrays).  The port reads it with its own reader (``orbax_reader.py``) into
the same tree, and writes msgpack only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..configs import ExperimentConfig
from ..models.weights import (
    from_jax_opt_state, from_jax_params, to_jax_opt_state, to_jax_params)
from . import msgpack_codec, orbax_reader
from .train_state import TrainState

STATE_FILE = "state.msgpack"
META_FILE = "meta.json"
CONFIG_FILE = "config.json"
EPOCH_DIR_FMT = "epoch_{:03d}"
ORBAX_SUBDIR = "orbax"


def epoch_dir(directory: str, epoch: int) -> str:
    """Numbered per-improvement checkpoint subdirectory."""
    return os.path.join(directory, EPOCH_DIR_FMT.format(epoch))


def _has_state(directory: str) -> bool:
    """A checkpoint directory holds the msgpack state or an orbax subdir."""
    return (os.path.exists(os.path.join(directory, STATE_FILE))
            or os.path.isdir(os.path.join(directory, ORBAX_SUBDIR)))


def list_epoch_checkpoints(directory: str):
    """Sorted epoch numbers of the retained checkpoints under ``directory``."""
    out = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith("epoch_") and _has_state(
                    os.path.join(directory, name)):
                try:
                    out.append(int(name[len("epoch_"):]))
                except ValueError:
                    pass
    return sorted(out)


def resolve_checkpoint(directory: str, model_num: Optional[int] = None) -> str:
    """A run directory (holding epoch_NNN subdirectories) or a checkpoint
    directory -> the directory that holds the state: the ``model_num``-th
    epoch's when given, else the directory itself when it holds one, else
    the newest epoch's."""
    if model_num is not None:
        d = epoch_dir(directory, model_num)
        if not _has_state(d):
            avail = list_epoch_checkpoints(directory)
            raise FileNotFoundError(
                f"no checkpoint for epoch {model_num} in {directory}; "
                f"available epochs: {avail}")
        return d
    if _has_state(directory):
        return directory
    epochs = list_epoch_checkpoints(directory)
    if not epochs:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return epoch_dir(directory, epochs[-1])


def _read_state(directory: str, only=None) -> Dict[str, Any]:
    """The state tree of a checkpoint directory, dispatched as JAX's
    ``load_checkpoint_auto``: the orbax subdirectory where it exists and
    ``state.msgpack`` does not, else ``state.msgpack``.  ``only`` names the
    top-level keys wanted (orbax reads no others)."""
    path = os.path.join(directory, STATE_FILE)
    orbax = os.path.join(directory, ORBAX_SUBDIR)
    if not os.path.exists(path) and os.path.isdir(orbax):
        return orbax_reader.read_state(orbax, only=only)
    with open(path, "rb") as f:
        return msgpack_codec.unpackb(f.read())


def _read_meta(directory: str) -> Dict[str, Any]:
    path = os.path.join(directory, META_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_params(directory: str, device):
    """Only the parameters of a checkpoint, in the port's layout on
    ``device``."""
    return from_jax_params(_read_state(directory, only=("params",))["params"],
                           device)


def load_checkpoint(directory: str, device) -> Tuple[TrainState, Dict[str, Any]]:
    """(TrainState with the port's params, AdamWState and step on
    ``device``, meta) of a checkpoint directory."""
    state = _read_state(directory)
    return (TrainState(params=from_jax_params(state["params"], device),
                       opt_state=from_jax_opt_state(state["opt_state"], device),
                       step=int(np.asarray(state["step"]))),
            _read_meta(directory))


def save_checkpoint(directory: str, state: TrainState,
                    config: ExperimentConfig, epoch: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` as the JAX package's ``save_checkpoint`` writes a
    TrainState of the same model and ``make_optimizer(config.train, ...)``
    chain (the chain's layout depends on the config), with meta.json and
    config.json beside it."""
    os.makedirs(directory, exist_ok=True)
    tree = {"params": to_jax_params(state.params),
            "opt_state": to_jax_opt_state(state.opt_state, config.train),
            "step": np.asarray(state.step, dtype=np.int32)}
    with open(os.path.join(directory, STATE_FILE), "wb") as f:
        msgpack_codec.dump(tree, f)
    meta = {"epoch": int(epoch), "step": int(state.step)}
    if extra:
        meta.update(extra)
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        f.write(config.to_json())
    return directory


def load_config(directory: str) -> Optional[ExperimentConfig]:
    path = os.path.join(directory, CONFIG_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ExperimentConfig.from_json(f.read())
