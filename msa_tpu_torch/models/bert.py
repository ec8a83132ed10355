"""BERT encoder core as plain functions over a parameter tree of tensors.

Counterpart of ``msa_tpu/models/bert.py``: post-LN layers with LayerNorm
and softmax in f32 and matmuls in the compute dtype, dropout at the
embedding, attention-output and FFN-output sites (``ops/dropout.py``) and
inside the attention kernels, and the named rematerialisation policies
(:func:`remat_layer`).
Layers are a list of per-layer dicts (the JAX tree stacks them on a
leading axis and scans; PyTorch runs a loop).  Dense layers hold ``weight``
[out, in] and ``bias`` [out], as ``torch.nn.functional.linear`` takes them
(``models/weights.py`` transposes the JAX [in, out] kernels), or, on the
int8 serving path, ``qweight`` / ``qscale`` / ``bias`` [/ ``ascale``]
(``ops/quant.py``).

Randomness: a training forward takes a host ``torch.Generator`` and draws
one integer seed per dropout site from it, in a fixed order; each site
seeds its own draw (or the attention kernel's Philox mask) from that
integer.  A layer therefore receives its seeds as arguments, and the
recompute of a checkpointed layer reproduces its dropout exactly.

Rematerialisation (``remat_policy``, JAX's ``jax.checkpoint`` policies of
``bert_encoder``): each policy saves what JAX's saves and recomputes the
rest.  The layer is split into regions; a region that the policy
recomputes runs under its own non-reentrant ``torch.utils.checkpoint``,
whose inputs -- the values the policy saves -- stay alive until the
backward, and what a policy saves stays outside the regions.  JAX's names
map to the port's values as follows:

* ``attn_io``: q, k, v (the attention Function keeps them);
* ``attn_ctx`` / ``attn_lse``: the attention output and the kernel's own
  residuals (the f32 output and the row lse of the short and flash2
  kernels), kept by its autograd Function, so a policy that saves them
  never re-runs the attention forward;
* ``narrow``: the attention projection's output and the post-attention
  LayerNorm's output; ``ffn_wide``: the FFN's up-projection and its gelu;
* ``drop_mask`` (``+drop``): the two hidden-dropout bool masks, drawn
  before the layer and handed to the regions, so a recompute draws
  nothing; without it a recompute redraws them from the site's seed;
* ``attn_probs`` (``+probs``): the signed probabilities of the short
  kernel (``short_attention_probs``), whose backward then reads them;
* ``attn_pack`` (``save_pack``): the packed [*, 3H] q|k|v of
  ``short_attention_packed``.

``+probs`` and ``save_pack`` change kernels only on the short-attention
route (``ops/attention.py::attention_route``); elsewhere -- the flash2
route, the plain route of the CPU or ``use_flash="never"`` -- they act as
their base (``save_pack`` as ``save_attn``), as JAX's do where its short
kernel does not run.  Selective activation checkpointing
(``create_selective_checkpoint_contexts``) sees only dispatcher ops and
could not cache the attention kernels, which are ctypes calls inside
autograd Functions; hence the regions.

Tensor parallelism (``mp``, a ``parallel.distributed.ModelParallel``; the
tree is the rank's shard, ``parallel/sharding.py``) places Megatron's
collectives as JAX's GSPMD places them for ``param_specs``: the stream
enters the column-split q/k/v and ``wi`` through an identity whose
backward all-reduces, the row-split ``o`` and ``wo`` sum their partial
products over the group before their bias, attention runs the rank's
``num_heads / mp`` heads through the same kernels, and the word embedding
is looked up in the rank's vocabulary rows and summed.  Under sequence
parallelism the residual stream keeps the rank's rows of the sequence
(padded to a multiple of the group) between the LayerNorm boundaries: it
is all-gathered before q/k/v and ``wi`` and the ``o`` / ``wo`` sums are
reduce-scattered, so LayerNorm, dropout and the residual run on the
shard; each hidden-dropout mask is the shard's rows of the mask drawn
over the whole sequence, so the numerics are tensor parallelism's.  Under
``mp`` the ``+probs`` and ``save_pack`` rungs act as their base, as JAX's
head-parallel attention takes neither.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import BertConfig
from ..ops.attention import (attention_route, multi_head_attention,
                             packed_attention)
from ..ops.dropout import (apply_dropout_mask, draw_seed, dropout_mask,
                           seeded_generator, shard_seed)
from ..ops.ln_quant import ln_quant
from ..ops.quant import (dequantize, int8_dense, int8_matmul_pre,
                         int8_product, quantize_act)
from ..parallel.distributed import pad_rows

STATS = ("attn_in", "ctx", "mlp_in", "ffn_act")
# JAX's remat policy bases (msa_tpu/models/bert.py); "none" is the port's
# no-checkpointing rung.  "+drop" / "+probs" compose only with the bases in
# SUFFIX_BASES, as in JAX.
REMAT_BASES = ("full", "dots", "save_small", "save_wide", "save_attn",
               "save_ctx", "save_pack")
SUFFIX_BASES = ("full", "save_small", "save_attn", "save_ctx", "save_pack",
                "save_wide")

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """f32 LayerNorm; output cast back to the input dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "qweight" in p:  # int8 serving path (ops/quant.py)
        return int8_dense(x, p["qweight"], p["qscale"], p["bias"],
                          p.get("ascale"))
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """BERT's gelu: the tanh approximation in bf16 unless ``exact``
    (``BertConfig.exact_gelu``), exact erf otherwise (as the JAX package)."""
    tanh = x.dtype == torch.bfloat16 and not exact
    return F.gelu(x, approximate="tanh" if tanh else "none")


class TensorParallel:
    """How an encoder layer reaches its model group: ``mp`` (a
    ``parallel.distributed.ModelParallel``) and, under sequence
    parallelism, ``seq``: the full length the residual stream's rows were
    cut from (None: the stream is whole on every rank)."""

    def __init__(self, mp, seq: Optional[int] = None):
        self.mp, self.seq = mp, seq

    def heads(self, cfg: BertConfig) -> int:
        """The rank's attention heads."""
        return cfg.num_attention_heads // self.mp.size

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """The stream as the input of a column-split product: the identity
        whose backward sums over the group, or, under sequence
        parallelism, the all-gathered rows (the backward reduce-scatters),
        padding dropped."""
        if self.seq is None:
            return self.mp.copy(h)
        return self.mp.gather(h, 1)[:, :self.seq]

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A row-split product's partial sums in the stream's layout: summed
        over the group, or reduce-scattered over the padded rows."""
        if self.seq is None:
            return self.mp.reduce(y)
        return self.mp.scatter(pad_rows(y, self.mp.size), 1)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The stream's rows of a whole-sequence tensor (no gradient): the
        rank's chunk of the padded rows under sequence parallelism."""
        if self.seq is None:
            return x
        return self.mp.chunk(pad_rows(x, self.mp.size), 1)

    def real(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of a stream shard that are not padding."""
        if self.seq is None:
            return x
        n = x.shape[1]
        return x[:, :max(0, min(n, self.seq - self.mp.index * n))]

    def enter_int8(self, xi: torch.Tensor, row):
        """An int8 view of the stream (and its per-row scales) as the input
        of column-split int8 products."""
        if self.seq is None:
            return xi, row
        if isinstance(row, torch.Tensor) and row.dim():
            row = self.mp.all_gather(row, 1)[:, :self.seq]
        return self.mp.all_gather(xi, 1)[:, :self.seq], row

    def leave_int8(self, acc: torch.Tensor, row):
        """A row-split int8 product's int32 partial sums (exact to sum) and
        its per-row scales, in the stream's layout."""
        if self.seq is None:
            return self.mp.all_reduce(acc), row
        if isinstance(row, torch.Tensor) and row.dim():
            row = self.rows(row)
        return self.mp.reduce_scatter(pad_rows(acc, self.mp.size), 1), row


def site_dropout(x: torch.Tensor, rate: float, site,
                 tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Hidden dropout at one site.  ``site``: None (identity), an int seed
    (the mask is drawn from a generator seeded with it on ``x``'s device)
    or a bool keep mask from :func:`site_mask` (applied, nothing drawn).
    Under sequence parallelism (``tp``) ``x`` is a stream shard and the
    mask is its rows of the whole sequence's."""
    if site is None or rate == 0.0:
        return x
    if not isinstance(site, torch.Tensor):
        site = site_mask(x.shape, rate, site, x.device, tp)
    return apply_dropout_mask(x, site, rate,
                              None if tp is None else tp.seq)


def site_mask(shape, rate: float, seed: Optional[int], device,
              tp: Optional[TensorParallel] = None):
    """The keep mask :func:`site_dropout` would draw from ``seed`` for a
    tensor of ``shape`` (None when there is no dropout); for a stream
    shard (``tp`` under sequence parallelism), the shard's rows of the
    mask of the whole sequence."""
    if seed is None or rate == 0.0:
        return None
    if tp is None or tp.seq is None:
        return dropout_mask(shape, rate, seeded_generator(seed, device),
                            device)
    full = (shape[0], tp.seq) + tuple(shape[2:])
    return tp.rows(dropout_mask(full, rate, seeded_generator(seed, device),
                                device))


def bert_embeddings(params: Params, input_ids: torch.Tensor, cfg: BertConfig,
                    *, compute_dtype: torch.dtype = torch.float32,
                    seed: Optional[int] = None, mp=None) -> torch.Tensor:
    """Word + position + type-0 embeddings -> LN -> dropout.  [B, S, H].

    Every token has segment 0: no caller of the JAX ``bert_embeddings``
    passes token types, and the joint passes zero them by definition.
    ``seed`` None is the deterministic forward.  Under tensor parallelism
    (``mp``) the rank holds rows of the vocabulary: ids outside them look
    up row 0, are zeroed, and the rows are summed over the group.
    """
    p = params["embeddings"]
    if mp is None:
        word = F.embedding(input_ids, p["word"]).to(compute_dtype)
    else:
        rows = p["word"].shape[0]
        local = input_ids - mp.index * rows
        inside = (local >= 0) & (local < rows)
        word = F.embedding(torch.where(inside, local, 0), p["word"])
        word = mp.reduce(word * inside[..., None].to(word.dtype)) \
            .to(compute_dtype)
    pos = p["position"][:input_ids.shape[-1]].to(compute_dtype)
    x = word + pos[None, :, :] + p["type"][0].to(compute_dtype)
    x = layer_norm(x, p["ln"], cfg.layer_norm_eps)
    return site_dropout(x, cfg.hidden_dropout_prob, seed)


def _absmax(x: torch.Tensor) -> torch.Tensor:
    if not x.numel():
        return x.new_zeros((), dtype=torch.float32)
    return x.abs().amax().float()  # exact in any float dtype


def _stat(x: torch.Tensor, tp: Optional[TensorParallel],
          stream: bool = False) -> torch.Tensor:
    """The absmax of an int8 site's input over the model group (of the
    real rows of a stream shard)."""
    if tp is None:
        return _absmax(x)
    return tp.mp.max(_absmax(tp.real(x) if stream else x))


def _qkv(lp: Params, h: torch.Tensor, tp: Optional[TensorParallel] = None):
    if tp is not None:
        h = tp.enter(h)
    if "qkv" in lp:  # the fused int8 projection (ops/quant.py fuse_qkv)
        return dense(h, lp["qkv"]).chunk(3, dim=-1)
    return dense(h, lp["q"]), dense(h, lp["k"]), dense(h, lp["v"])


def _row_dense(x: torch.Tensor, p: Params,
               tp: Optional[TensorParallel]) -> torch.Tensor:
    """A row-split projection (``o``, ``wo``) of the rank's columns ``x``:
    the partial products summed over the group, then the bias, once.  The
    int8 form quantizes at the whole row's scale and sums the int32
    products before the dequantize, which is exact."""
    if tp is None:
        return dense(x, p)
    if "qweight" in p:
        xi, row = quantize_act(x, p.get("ascale"), row_max=tp.mp.max)
        acc, row = tp.leave_int8(int8_product(xi, p["qweight"]), row)
        return dequantize(acc, row, p["qscale"], p["bias"], x.dtype)
    y = tp.leave(F.linear(x, p["weight"].to(x.dtype)))
    return y + p["bias"].to(y.dtype)


def _attend(q, k, v, attn_bias, cfg: BertConfig, use_flash: str,
            seed: Optional[int], tp: Optional[TensorParallel] = None,
            **kernel):
    return multi_head_attention(
        q, k, v, attn_bias,
        num_heads=cfg.num_attention_heads if tp is None else tp.heads(cfg),
        dropout_rate=cfg.attention_probs_dropout_prob, seed=seed,
        deterministic=seed is None, use_flash=use_flash, **kernel)


def _attn_ln(lp: Params, h, attn_out, cfg: BertConfig, drop, tp=None):
    """The post-attention LayerNorm over the residual and the dropped
    attention projection."""
    return layer_norm(h + site_dropout(attn_out, cfg.hidden_dropout_prob,
                                       drop, tp),
                      lp["attn_ln"], cfg.layer_norm_eps)


def _ffn_ln(lp: Params, h1, down, cfg: BertConfig, drop, tp=None):
    """The closing LayerNorm over the residual and the dropped FFN output."""
    return layer_norm(h1 + site_dropout(down, cfg.hidden_dropout_prob, drop,
                                        tp),
                      lp["mlp_ln"], cfg.layer_norm_eps)


def _wi(lp: Params, h1, tp=None):
    """The FFN's up-projection (the rank's columns under ``tp``)."""
    return dense(h1 if tp is None else tp.enter(h1), lp["wi"])


def _up(lp: Params, h1, cfg: BertConfig, tp=None):
    """The FFN's up-projection and its gelu."""
    return gelu(_wi(lp, h1, tp), cfg.exact_gelu)


def _ffn(lp: Params, h1, cfg: BertConfig, drop, tp=None):
    return _ffn_ln(lp, h1, _row_dense(_up(lp, h1, cfg, tp), lp["wo"], tp),
                   cfg, drop, tp)


def _post_attention(lp: Params, h, ctx, cfg: BertConfig, drop1, drop2,
                    tp=None):
    """The layer from the attention output on."""
    return _ffn(lp, _attn_ln(lp, h, _row_dense(ctx, lp["o"], tp), cfg, drop1,
                             tp), cfg, drop2, tp)


def bert_layer(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
               cfg: BertConfig, *, use_flash: str = "auto",
               seeds: Optional[Tuple[int, int, int]] = None,
               stats: Optional[Dict[str, list]] = None,
               tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """One post-LN transformer layer (the split q/k/v branch of the JAX
    ``bert_encoder`` layer body).  ``seeds``: (attention probs, attention
    output, FFN output) dropout seeds; None is the deterministic layer.
    ``stats``: lists that gain this layer's absmax of each int8 site's
    input (``STATS``), for static-scale calibration.  ``tp``: the model
    group (see :class:`TensorParallel`)."""
    attn_seed, post_seed, mlp_seed = seeds if seeds is not None else (None,) * 3
    if stats is None:
        return _post_attention(
            lp, h, _attend(*_qkv(lp, h, tp), attn_bias, cfg, use_flash,
                           attn_seed, tp), cfg, post_seed, mlp_seed, tp)
    stats["attn_in"].append(_stat(h, tp, stream=True))
    ctx = _attend(*_qkv(lp, h, tp), attn_bias, cfg, use_flash, attn_seed, tp)
    stats["ctx"].append(_stat(ctx, tp))
    h = _attn_ln(lp, h, _row_dense(ctx, lp["o"], tp), cfg, post_seed, tp)
    stats["mlp_in"].append(_stat(h, tp, stream=True))
    up = _up(lp, h, cfg, tp)
    stats["ffn_act"].append(_stat(up, tp))
    return _ffn_ln(lp, h, _row_dense(up, lp["wo"], tp), cfg, mlp_seed, tp)


def parse_remat_policy(policy: str) -> Tuple[str, bool, bool]:
    """(base, +drop, +probs) of a policy name, the suffixes in any order,
    as JAX parses them; raises for an unknown base or a suffix on a base
    that cannot honour it ("dots", "auto")."""
    base, save_drop, save_probs = policy, False, False
    while True:
        if base.endswith("+drop"):
            save_drop, base = True, base[:-len("+drop")]
        elif base.endswith("+probs"):
            save_probs, base = True, base[:-len("+probs")]
        else:
            break
    if (save_drop or save_probs) and base not in SUFFIX_BASES:
        raise ValueError(
            f"remat_policy suffix (+drop/+probs) does not compose with base "
            f"{base!r}; use one of the save_* named policies or 'full'")
    if base not in REMAT_BASES + ("none",):
        raise ValueError(f"unknown remat_policy {policy!r}")
    return base, save_drop, save_probs


def _region(fn, *args):
    """A region the policy recomputes: its inputs are saved, nothing else.
    Every random draw in a region is seeded from its arguments (or reads a
    saved mask), so the global RNG states need not be stashed and
    restored around the recompute.  A recompute runs the region's
    collectives again, in the same order on every rank."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def remat_layer(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
                cfg: BertConfig, policy: str, *, use_flash: str = "auto",
                seeds: Optional[Tuple[int, int, int]] = None,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """:func:`bert_layer` under the remat ``policy`` (a JAX policy name;
    see the module docstring): the same values, with what the policy does
    not save recomputed in the backward."""
    base, save_drop, save_probs = parse_remat_policy(policy)
    attn_seed, drop1, drop2 = seeds if seeds is not None else (None,) * 3
    if save_drop:  # 'drop_mask': draw both masks now, save them
        rate = cfg.hidden_dropout_prob
        drop1 = site_mask(h.shape, rate, drop1, h.device, tp)
        drop2 = site_mask(h.shape, rate, drop2, h.device, tp)
    seq = h.shape[1] if tp is None or tp.seq is None else tp.seq
    route = attention_route(use_flash, seq, h.is_cuda)
    # JAX's head-parallel attention takes neither the v2s nor the v2p entry
    stash = save_probs and route == "short" and tp is None
    pack = base == "save_pack" and route == "short" and tp is None

    def attend(q, k, v, **kernel):
        return _attend(q, k, v, attn_bias, cfg, use_flash, attn_seed, tp,
                       stash_probs=stash, **kernel)

    def qkv(x):
        return _qkv(lp, x, tp)

    def post(x, c, d1, d2):
        return _post_attention(lp, x, c, cfg, d1, d2, tp)

    if base == "full":
        return _region(lambda x, d1, d2: post(x, attend(*qkv(x)), d1, d2),
                       h, drop1, drop2)
    if base == "dots":  # every matmul output; the attention is re-run
        q, k, v = qkv(h)
        attn_out = _region(lambda *t: _row_dense(attend(*t), lp["o"], tp),
                           q, k, v)
        up = _region(lambda x, a: _wi(lp, _attn_ln(lp, x, a, cfg, drop1, tp),
                                      tp), h, attn_out)
        down = _region(lambda u: _row_dense(gelu(u, cfg.exact_gelu),
                                            lp["wo"], tp), up)
        return _region(lambda x, a, dn: _ffn_ln(
            lp, _attn_ln(lp, x, a, cfg, drop1, tp), dn, cfg, drop2, tp),
            h, attn_out, down)

    if pack:
        qkv_packed = torch.cat(qkv(h), dim=-1)  # 'attn_pack'
        ctx = packed_attention(
            qkv_packed, attn_bias, num_heads=cfg.num_attention_heads,
            dropout_rate=cfg.attention_probs_dropout_prob, seed=attn_seed,
            deterministic=attn_seed is None)
    elif base == "save_ctx" and route == "plain":
        # no kernel residuals to keep: the plain attention is recomputed
        ctx = _region(lambda x: attend(*qkv(x)), h)
    elif base == "save_ctx":  # q, k, v recomputed, the kernel never re-run
        ctx = attend(*qkv(h), recompute=lambda: qkv(h))
    else:
        ctx = attend(*qkv(h))
    if base in ("save_attn", "save_ctx", "save_pack"):
        return _region(post, h, ctx, drop1, drop2)
    h1 = _region(lambda x, a, d1: _attn_ln(lp, x, a, cfg, d1, tp), h,
                 _row_dense(ctx, lp["o"], tp), drop1)
    if base == "save_small":
        return _region(lambda x, d2: _ffn(lp, x, cfg, d2, tp), h1, drop2)
    up = _up(lp, h1, cfg, tp)  # save_wide
    return _region(lambda x, u, d2: _ffn_ln(
        lp, x, _row_dense(u, lp["wo"], tp), cfg, d2, tp), h1, up, drop2)


def bert_layer_int8(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
                    cfg: BertConfig, *, use_flash: str = "auto",
                    xi_attn: Optional[torch.Tensor] = None,
                    next_ascale: Optional[torch.Tensor] = None,
                    tp: Optional[TensorParallel] = None):
    """The deterministic int8 serving layer with the fused LayerNorm +
    quantize sites (``ops/ln_quant.py``).  Returns (h, int8 view of h or
    None).

    * mlp_in: the post-attention LayerNorm emits the stream and wi's int8
      view in one pass (at wi's static scale, or per row).
    * attn_in (``xi_attn`` given): q, k and v read this layer's int8 input,
      quantized at q's static scale, and are all dequantized against q's
      scale; the closing LayerNorm then emits the next layer's view at
      ``next_ascale``.  Without ``next_ascale`` it is a plain LayerNorm.
    * otherwise (per-row scales) q, k and v share one quantize of h: three
      would give the same int8 view, as XLA's CSE makes of JAX's three
      ``int8_dense`` calls.
    * a fused "qkv" entry (``fuse_qkv``): one quantize of h (at its static
      scale, or per row) and one [*, 3H] int8 product.  On the short route
      the packed attention kernel reads its thirds in place (JAX's
      ``int8_qkv_direct``); elsewhere the thirds are sliced out.

    Under tensor parallelism (``tp``) the column-split q/k/v and wi read
    the int8 views as they are (all-gathered rows under sequence
    parallelism), and ``o`` / ``wo`` quantize at the whole row's scale and
    sum their int32 products over the group (:func:`_row_dense`).
    """
    eps = cfg.layer_norm_eps
    if "qkv" in lp:
        fused = lp["qkv"]
        xi_attn, row = quantize_act(h, fused.get("ascale"))
        qkv = int8_matmul_pre(xi_attn, row, fused["qweight"], fused["qscale"],
                              fused["bias"], h.dtype)
        if attention_route(use_flash, h.shape[1], h.is_cuda) == "short":
            ctx = packed_attention(qkv, attn_bias,
                                   num_heads=cfg.num_attention_heads)
        else:
            ctx = multi_head_attention(*qkv.chunk(3, dim=-1), attn_bias,
                                       num_heads=cfg.num_attention_heads,
                                       use_flash=use_flash)
    else:
        if xi_attn is None:
            xi_attn, row = quantize_act(h)
        else:
            row = lp["q"]["ascale"]
        if tp is not None:
            xi_attn, row = tp.enter_int8(xi_attn, row)
        q, k, v = (int8_matmul_pre(xi_attn, row, lp[n]["qweight"],
                                   lp[n]["qscale"], lp[n]["bias"], h.dtype)
                   for n in ("q", "k", "v"))
        ctx = multi_head_attention(
            q, k, v, attn_bias, num_heads=cfg.num_attention_heads
            if tp is None else tp.heads(cfg), use_flash=use_flash)
    wi = lp["wi"]
    h, xi, row = ln_quant(h, _row_dense(ctx, lp["o"], tp), lp["attn_ln"],
                          eps, wi.get("ascale"))
    row = row if row is not None else wi["ascale"]
    if tp is not None:
        xi, row = tp.enter_int8(xi, row)
    up = int8_matmul_pre(xi, row, wi["qweight"], wi["qscale"], wi["bias"],
                         h.dtype)
    down = _row_dense(gelu(up, cfg.exact_gelu), lp["wo"], tp)
    if next_ascale is None:
        return layer_norm(h + down, lp["mlp_ln"], eps), None
    h, xi_next, _ = ln_quant(h, down, lp["mlp_ln"], eps, next_ascale)
    return h, xi_next


def bert_encoder(params: Params, hidden: torch.Tensor, attn_bias: torch.Tensor,
                 cfg: BertConfig, *, use_flash: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 remat_policy: str = "none", collect_act_stats: bool = False,
                 shard: int = 0, mp=None):
    """``hidden`` [B, S, H]; ``attn_bias`` additive [B, 1, 1, S].

    ``generator``: a host generator for a training forward (three seeds per
    layer are drawn from it, in layer order, each moved for the rank by
    ``ops.dropout.shard_seed``: the attention seed by m + mp * d, the
    hidden ones by the data index ``shard`` d); None is deterministic.
    ``remat_policy``: "none" (nothing checkpointed) or a JAX policy name,
    applied to every layer by :func:`remat_layer`.
    ``mp``: the model group (``parallel.distributed.ModelParallel``) under
    tensor parallelism, ``params`` the rank's shard; the encoder takes and
    returns the whole [B, S, H] also under sequence parallelism.

    ``collect_act_stats=True`` (int8 static-scale calibration) returns
    ``(hidden, stats)``: {"attn_in", "ctx", "mlp_in", "ffn_act"} -> [L] f32
    absmax of the inputs of each quantized projection class.

    int8 parameters on the deterministic path, without remat or stats,
    take :func:`bert_layer_int8`; with static scales and split q, k, v,
    each layer's closing LayerNorm also emits the next layer's int8 view
    (layer 0's is one standalone quantize; the last layer's, at layer 0's
    scale, is discarded, as JAX's scan computes it).  With a fused "qkv"
    entry each layer quantizes its own input, as JAX's fused path does.
    """
    layers = params["layers"]
    remat = remat_policy != "none"
    if remat:
        parse_remat_policy(remat_policy)
    tp, seq = None, hidden.shape[1]
    if mp is not None:
        tp = TensorParallel(mp, seq if mp.sequence_parallel else None)
        if tp.seq is not None:  # the rank's rows of the stream
            hidden = mp.split(pad_rows(hidden, mp.size), 1)
    attn_shard = shard if mp is None else mp.index + mp.size * shard
    if generator is None and not remat and not collect_act_stats and \
            "qweight" in layers[0]["wi"]:
        n = len(layers)
        # static scales on every projection, split q/k/v
        chain = "ascale" in layers[0].get("q", {})
        xi = quantize_act(hidden, layers[0]["q"]["ascale"])[0] if chain else None
        for i, lp in enumerate(layers):
            hidden, xi = bert_layer_int8(
                lp, hidden, attn_bias, cfg, use_flash=use_flash, xi_attn=xi,
                next_ascale=layers[(i + 1) % n]["q"]["ascale"] if chain
                else None, tp=tp)
        return _whole(hidden, tp, seq)
    stats = {k: [] for k in STATS} if collect_act_stats else None
    for lp in layers:
        seeds = None
        if generator is not None:
            attn, post, mlp = (draw_seed(generator) for _ in range(3))
            seeds = (shard_seed(attn, attn_shard), shard_seed(post, shard),
                     shard_seed(mlp, shard))
        if remat:
            hidden = remat_layer(lp, hidden, attn_bias, cfg, remat_policy,
                                 use_flash=use_flash, seeds=seeds, tp=tp)
        else:
            hidden = bert_layer(lp, hidden, attn_bias, cfg,
                                use_flash=use_flash, seeds=seeds, stats=stats,
                                tp=tp)
    hidden = _whole(hidden, tp, seq)
    if collect_act_stats:
        return hidden, {k: torch.stack(v) for k, v in stats.items()}
    return hidden


def _whole(hidden: torch.Tensor, tp: Optional[TensorParallel], seq: int):
    """The encoder's output: the stream shards gathered under sequence
    parallelism (every rank then uses it alike), padding dropped."""
    if tp is None or tp.seq is None:
        return hidden
    return tp.mp.gather_replicated(hidden, 1)[:, :seq]


def bert_pooler(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """tanh(dense(first token)), the tanh in f32."""
    first = dense(hidden[:, 0], params["pooler"])
    return torch.tanh(first.float()).to(hidden.dtype)


def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 mask -> additive f32 [B, 1, 1, S] bias (0 keep, -10000
    drop, the reference's fill)."""
    return ((1.0 - mask.to(torch.float32)) * -10000.0)[:, None, None, :]
