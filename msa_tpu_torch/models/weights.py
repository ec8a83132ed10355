"""MMBert parameter trees for the port: random init and the JAX bridge.

The tree follows ``msa_tpu/models/mmbert.py::init_mmbert_params`` with two
changes of layout for PyTorch:

  * ``bert.layers`` is a list of per-layer dicts (JAX stacks them on a
    leading [num_layers] axis);
  * dense layers hold ``weight`` [out, in] and ``bias`` [out], as
    ``torch.nn.functional.linear`` takes them (JAX: ``kernel`` [in, out]).
    The joint projections ``joint.Wv`` / ``joint.Ws`` keep ``kernel``
    [D, H]: the fused joint-embedding kernel reads them in that layout.

Everything else (embedding tables with the padded vocab, LayerNorm
``scale``/``bias``, the -1e9 padded ``cls.decoder_bias``) is as in JAX.
``from_jax_params`` / ``from_jax_opt_state`` carry a JAX tree into this
layout and ``to_jax_params`` / ``to_jax_opt_state`` carry it back (the
layout of ``flax.serialization.to_state_dict``, for checkpoints).
``load_pretrained_bert`` merges an HF-style BERT state dict (a local file,
``load_torch_checkpoint``) into fresh parameters, as the JAX package's
``models/weights.py`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs import MMBertConfig

Params = Dict[str, Any]
_LAYER_DENSE = ("q", "k", "v", "o", "wi", "wo")
_LAYER_LN = ("attn_ln", "mlp_ln")


def _arr(x):
    """A leaf as an array that indexes and transposes: torch tensors (the
    checkpoint codec's bf16 leaves) as they are, anything else as numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensor(x, device) -> torch.Tensor:
    """An f32 tensor, or bf16 where ``x`` is bf16 (numpy has no bf16 that
    torch reads, so through f32, which holds every bf16 value exactly), in
    the row-major layout of a fresh tensor: a transposed kernel kept in its
    transposed strides would run other GEMM kernels, so a model loaded from
    a checkpoint would not take bit for bit the steps of the one saved."""
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    t = torch.from_numpy(np.array(x, dtype=np.float32, order="C")).to(device)
    return t.to(torch.bfloat16) if str(np.asarray(x).dtype) == "bfloat16" else t


def _convert(node, device, linear: bool):
    """Leaves to tensors; {kernel, bias} dicts to {weight, bias} when
    ``linear``."""
    if isinstance(node, Mapping):
        if linear and set(node) == {"kernel", "bias"}:
            return {"weight": _tensor(_arr(node["kernel"]).T, device),
                    "bias": _tensor(node["bias"], device)}
        return {k: _convert(v, device, linear) for k, v in node.items()}
    return _tensor(node, device)


def from_jax_params(tree: Mapping, device) -> Params:
    """Load the JAX package's MMBert parameters (a tree of numpy arrays, e.g.
    ``jax.device_get(params)``) into the port's layout on ``device``."""
    tree = dict(tree)
    bert = dict(tree["bert"])
    stacked = bert.pop("layers")
    n = int(_arr(stacked["q"]["kernel"]).shape[0])
    layers = []
    for i in range(n):
        lp = {}
        for name in _LAYER_DENSE:
            lp[name] = {"weight": _tensor(_arr(stacked[name]["kernel"])[i].T,
                                          device),
                        "bias": _tensor(_arr(stacked[name]["bias"])[i],
                                        device)}
        for name in _LAYER_LN:
            lp[name] = {k: _tensor(_arr(stacked[name][k])[i], device)
                        for k in ("scale", "bias")}
        layers.append(lp)
    out = {k: _convert(v, device, linear=(k != "joint"))
           for k, v in tree.items() if k != "bert"}
    out["bert"] = {k: _convert(v, device, linear=True) for k, v in bert.items()}
    out["bert"]["layers"] = layers
    return out


def from_jax_opt_state(opt_state, device):
    """Carry an optax AdamW state (the JAX package's ``make_optimizer``
    chain, optionally inside ``optax.MultiSteps``; host numpy leaves, e.g.
    ``jax.device_get(state.opt_state)``, or its state dict as a checkpoint
    holds it) into the port's
    :class:`~msa_tpu_torch.training.optim.AdamWState` on ``device``.

    The state is read by its fields, not by its classes: the
    ``ScaleByAdamState`` (count, mu, nu) and, when present, the
    ``MultiStepsState`` (mini_step, acc_grads).  mu and nu keep their
    storage dtype.
    """
    from ..training.optim import AdamWState

    def find(node, fields):
        """The first node, depth first, with all ``fields`` (as attributes
        or as keys), as a dict of them."""
        if isinstance(node, Mapping):
            if all(f in node for f in fields):
                return {f: node[f] for f in fields}
            children = node.values()
        elif all(hasattr(node, f) for f in fields):
            return {f: getattr(node, f) for f in fields}
        elif isinstance(node, (tuple, list)):
            children = node
        else:
            children = [getattr(node, name) for name in
                        ("inner_opt_state", "inner_state") if hasattr(node, name)]
        for child in children:
            hit = find(child, fields)
            if hit is not None:
                return hit
        return None

    adam = find(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("from_jax_opt_state: no Adam state (count, mu, nu) "
                         "in the optimizer state")
    multi = find(opt_state, ("mini_step", "acc_grads"))
    return AdamWState(
        count=int(np.asarray(adam["count"])),
        mu=from_jax_params(adam["mu"], device),
        nu=from_jax_params(adam["nu"], device),
        mini_step=0 if multi is None else int(np.asarray(multi["mini_step"])),
        acc=None if multi is None else from_jax_params(multi["acc_grads"],
                                                       device))


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def to_jax_params(params: Params) -> Dict[str, Any]:
    """The port's parameter tree in the JAX package's layout, as CPU
    tensors: layers stacked on a leading axis, dense ``weight`` [out, in]
    back to ``kernel`` [in, out].  The inverse of :func:`from_jax_params`."""
    def convert(node, linear: bool):
        if isinstance(node, Mapping):
            if linear and set(node) == {"weight", "bias"}:
                return {"kernel": _cpu(node["weight"].t()),
                        "bias": _cpu(node["bias"])}
            return {k: convert(v, linear) for k, v in node.items()}
        return _cpu(node)

    layers = params["bert"]["layers"]
    stacked = {}
    for name in _LAYER_DENSE:
        stacked[name] = {
            "kernel": torch.stack([_cpu(lp[name]["weight"].t()) for lp in layers]),
            "bias": torch.stack([_cpu(lp[name]["bias"]) for lp in layers])}
    for name in _LAYER_LN:
        stacked[name] = {k: torch.stack([_cpu(lp[name][k]) for lp in layers])
                         for k in ("scale", "bias")}
    bert = {k: convert(v, True) for k, v in params["bert"].items()
            if k != "layers"}
    bert["layers"] = stacked
    out = {"bert": bert}
    out.update({k: convert(v, k != "joint") for k, v in params.items()
                if k != "bert"})
    return out


def to_jax_opt_state(state, train_cfg) -> Dict[str, Any]:
    """The port's :class:`AdamWState` as ``flax.serialization.to_state_dict``
    lays out the optax state of ``make_optimizer(train_cfg, ...)``: tuples
    become {"0": ..., "1": ...}, named tuples their fields, ``EmptyState``
    {}.  The chain is [clip_by_global_norm]? then ``optax.adamw`` (itself
    scale_by_adam, masked add_decayed_weights, scale_by_learning_rate) when
    nu is f32, else those three flattened into the chain; inside
    ``MultiSteps`` when accumulating.  Under ``fused_optimizer`` it is JAX
    ``FusedAdamW``'s state, {"count", "mu", "nu"}."""
    def scalar(v):
        return np.asarray(v, dtype=np.int32)

    if train_cfg.fused_optimizer:
        return {"count": scalar(state.count), "mu": to_jax_params(state.mu),
                "nu": to_jax_params(state.nu)}

    adam = [{"count": scalar(state.count), "mu": to_jax_params(state.mu),
             "nu": to_jax_params(state.nu)},
            {"inner_state": {}},             # masked add_decayed_weights
            {"count": scalar(state.count)}]  # scale_by_schedule
    parts = [{}] if train_cfg.max_grad_norm and train_cfg.max_grad_norm > 0 \
        else []
    if train_cfg.adam_nu_dtype == "float32":
        parts.append({str(i): p for i, p in enumerate(adam)})
    else:
        parts.extend(adam)
    chain = {str(i): p for i, p in enumerate(parts)}
    if train_cfg.gradient_accumulation_steps <= 1:
        return chain
    return {"mini_step": scalar(state.mini_step),
            "gradient_step": scalar(state.count),
            "inner_opt_state": chain,
            "acc_grads": to_jax_params(state.acc),
            "skip_state": {}}


def named_leaves(tree, prefix: str = ""):
    """(path, tensor) pairs of a parameter tree, paths joined by '/'."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------------------
# Pretrained BERT weights (HF BertModel / BertForPreTraining state dicts)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _hf_dense(sd, prefix):
    # torch Linear weight is [out, in]; the JAX layout's kernel [in, out]
    return {"kernel": _np(sd[f"{prefix}.weight"]).T,
            "bias": _np(sd[f"{prefix}.bias"])}


def _hf_ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _hf_bert(sd, cfg, prefix):
    """An HF BertModel state dict (under ``prefix``) as the JAX package's
    BERT tree (``convert_bert_state_dict``): stacked layers, the word
    table zero-padded to the padded vocab."""
    word = _np(sd[f"{prefix}embeddings.word_embeddings.weight"])
    padded = np.zeros((cfg.padded_vocab_size,) + word.shape[1:], word.dtype)
    padded[:word.shape[0]] = word
    emb = {"word": padded,
           "position": _np(sd[f"{prefix}embeddings.position_embeddings.weight"]),
           "type": _np(sd[f"{prefix}embeddings.token_type_embeddings.weight"]),
           "ln": _hf_ln(sd, f"{prefix}embeddings.LayerNorm")}
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense",
             "wi": "intermediate.dense", "wo": "output.dense"}
    lns = {"attn_ln": "attention.output.LayerNorm",
           "mlp_ln": "output.LayerNorm"}
    per_layer = []
    for i in range(cfg.num_hidden_layers):
        base = f"{prefix}encoder.layer.{i}."
        lp = {k: _hf_dense(sd, base + n) for k, n in names.items()}
        lp.update({k: _hf_ln(sd, base + n) for k, n in lns.items()})
        per_layer.append(lp)
    layers = {k: {f: np.stack([lp[k][f] for lp in per_layer])
                  for f in per_layer[0][k]} for k in per_layer[0]}
    out = {"embeddings": emb, "layers": layers}
    if f"{prefix}pooler.dense.weight" in sd:
        out["pooler"] = _hf_dense(sd, f"{prefix}pooler.dense")
    return out


def load_pretrained_bert(state_dict: Mapping[str, Any], cfg: MMBertConfig,
                         params: Params) -> Params:
    """Merge an HF BertForPreTraining (or BertModel) state dict into fresh
    MMBert ``params`` of the port's layout (JAX ``load_pretrained_bert``):
    the encoder, embeddings and, when present, the pooler and the MLM / NSP
    heads are replaced; the custom heads keep their initialisation."""
    sd = dict(state_dict)
    device = params["bert"]["embeddings"]["word"].device
    bert_prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    out = dict(params)
    out["bert"] = from_jax_params(
        {"bert": _hf_bert(sd, cfg.bert, bert_prefix)}, device)["bert"]
    if "pooler" not in out["bert"]:
        out["bert"]["pooler"] = params["bert"]["pooler"]
    cls = dict(params["cls"])
    if "cls.predictions.bias" in sd or "predictions.bias" in sd:
        head = "cls." if "cls.predictions.bias" in sd else ""
        bias = _np(sd[f"{head}predictions.bias"])
        decoder_bias = np.full((cfg.bert.padded_vocab_size,), -1e9, bias.dtype)
        decoder_bias[:bias.shape[0]] = bias
        heads = {"transform_dense": _hf_dense(
                     sd, f"{head}predictions.transform.dense"),
                 "transform_ln": _hf_ln(
                     sd, f"{head}predictions.transform.LayerNorm"),
                 "decoder_bias": decoder_bias}
        if f"{head}seq_relationship.weight" in sd:
            heads["seq_relationship"] = _hf_dense(sd, f"{head}seq_relationship")
        cls.update(_convert(heads, device, linear=True))
    out["cls"] = cls
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch ``state_dict`` file as numpy arrays (host-side)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def resolve_pretrained(path: str) -> Dict[str, np.ndarray]:
    """The state dict of a local torch file.  The port resolves no model
    names: the JAX package looks names up through ``transformers`` (its
    cache or the network); here a name that is not a file raises."""
    import os

    if os.path.exists(path):
        return load_torch_checkpoint(path)
    raise FileNotFoundError(
        f"'{path}' is not a local state-dict file, and the port resolves no "
        "model names.  On a networked machine run "
        "scripts/fetch_bert_weights.py and pass the exported .pt file.")


def init_params(cfg: MMBertConfig, generator: torch.Generator) -> Params:
    """Random MMBert parameters with ``init_mmbert_params``'s shapes and
    stds (normal(0, initializer_range) weights, zero biases, unit LN
    scales), drawn from ``generator`` on its device.  The numbers differ
    from JAX's (another generator); the layout does not."""
    device = generator.device
    bc = cfg.bert
    h, i, std = bc.hidden_size, bc.intermediate_size, bc.initializer_range
    vp = bc.padded_vocab_size

    def normal(*shape):
        return torch.empty(shape, device=device).normal_(
            0.0, std, generator=generator)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def linear(d_in, d_out):
        return {"weight": normal(d_out, d_in), "bias": zeros(d_out)}

    def ln(d):
        return {"scale": torch.ones(d, device=device), "bias": zeros(d)}

    word = normal(vp, h)
    word[bc.vocab_size:] = 0.0
    decoder_bias = zeros(vp)
    decoder_bias[bc.vocab_size:] = -1e9  # padded vocab never wins
    layers = [{"q": linear(h, h), "k": linear(h, h), "v": linear(h, h),
               "o": linear(h, h), "attn_ln": ln(h), "wi": linear(h, i),
               "wo": linear(i, h), "mlp_ln": ln(h)}
              for _ in range(bc.num_hidden_layers)]
    out_dim = 1 if cfg.regression else cfg.num_labels
    return {
        "bert": {
            "embeddings": {"word": word,
                           "position": normal(bc.max_position_embeddings, h),
                           "type": normal(bc.type_vocab_size, h),
                           "ln": ln(h)},
            "layers": layers,
            "pooler": linear(h, h),
        },
        "joint": {"Wv": {"kernel": normal(cfg.visual_dim, h), "bias": zeros(h)},
                  "Ws": {"kernel": normal(cfg.speech_dim, h), "bias": zeros(h)},
                  "ln": ln(h)},
        "cls": {"transform_dense": linear(h, h), "transform_ln": ln(h),
                "decoder_bias": decoder_bias, "align": linear(h, 2),
                "seq_relationship": linear(h, 2)},
        "fusion": {"attn": linear(2 * h, h), "vt": linear(h, 1),
                   "vv": linear(h, 1), "vs": linear(h, 1),
                   "classifier1": linear(3 * h, h),
                   "classifier2": linear(h, out_dim)},
        "cpc": {"zt": linear(h, cfg.cpc_x_size), "zv": linear(h, cfg.cpc_x_size),
                "za": linear(h, cfg.cpc_x_size)},
    }


def map_tree(tree, fn):
    """The same tree (dicts and lists) with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def to_device(params: Params, device) -> Params:
    """The same tree with every tensor on ``device``."""
    return map_tree(params, lambda p: p.to(device))


def cast_for_compute(params: Params, dtype: torch.dtype) -> Params:
    """Cast what the forward casts anyway -- dense weights and biases, the
    embedding tables -- to ``dtype`` once, so serving does not re-cast them
    every batch.  LayerNorm parameters and the joint projections stay f32:
    the forward reads them in f32."""
    def walk(node, key=None):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            if "weight" in node:  # dense layer
                return {k: v.to(dtype) for k, v in node.items()}
            return {k: walk(v, k) for k, v in node.items()}
        return node.to(dtype) if key in ("word", "position", "type") else node
    return walk(params)
