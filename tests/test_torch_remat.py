"""msa_tpu_torch's remat policies and the '+probs' / 'save_pack' attention
pairs on the CPU, against the JAX package.

* The plain versions of the v2s (signed-probs) and v2p (packed q|k|v)
  pairs against JAX's ``short_attention_v2s`` / ``short_attention_v2p``
  (Pallas in interpret mode) at rate 0, and the signed-probs backward
  against autograd through the plain attention with a keep mask.
  Tolerances: f32 forward 1e-5, gradients 1e-4 (the same math, summed in
  another order; JAX's kernels in base-2 softmax blocks), at head dim 64
  and (``-d32``, H = 64) 32 for the entries' gradients; the bf16 v2s and
  v2p forwards 2e-2 absolute and relative (both sides round pd and the
  outputs to bf16, from probabilities a base-2 and a natural softmax
  compute a few f32 ulps apart: an occasional one-ulp step of a bf16 value
  of order one); their bf16 gradients within 2e-3 absolute and 8e-3
  relative (two bf16 ulps, as test_torch_short_attention_v3.py): both
  sides round dS and the dropped p to bf16 before their products, and a
  sum taken in another order can move a rounded dS to its neighbour.
* Every policy of JAX's own policy tests (tests/test_remat_policies.py),
  plus ``save_pack``: the port's loss and gradients equal its no-remat step
  within 1e-6 (f32, every dropout on, the plain paths of the CPU: the
  recompute reproduces the same arithmetic), and JAX's same-policy step
  within 1e-5 relative (dropout off: the two frameworks draw different
  random numbers): the loss relative to itself, each gradient element
  relative to the largest gradient element (the small InfoNCE-head
  gradients differ by up to ~0.2 % of their own size between the two
  frameworks' f32 summation orders; the whole gradient by ~2e-6).
* The bytes each policy keeps for the backward, counted by a
  ``saved_tensors_hooks`` pair, fall in the order JAX's ladder assumes.
* ``auto`` walks the ladder under a faked card memory (as
  tests/test_remat_auto.py does for JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd.graph import saved_tensors_hooks

import jax
import jax.numpy as jnp

from msa_tpu.configs import MMBertConfig, tiny_bert_config
from msa_tpu.data.dataset import MultimodalDataset as JaxDataset
from msa_tpu.data.featurize import synthetic_split
from msa_tpu.models.mmbert import init_mmbert_params
from msa_tpu.models.mmbert import mmbert_forward as jax_mmbert_forward
from msa_tpu.models.mmbert import mmbert_loss as jax_mmbert_loss
from msa_tpu.ops.short_attention import (
    _v2s_fwd_call, short_attention_v2p, short_attention_v2s)
from msa_tpu_torch import configs as port_configs
from msa_tpu_torch.models import bert as port_bert
from msa_tpu_torch.models.mmbert import mmbert_forward, mmbert_loss
from msa_tpu_torch.models.weights import from_jax_params, named_leaves
from msa_tpu_torch.ops import attention as port_attention
from msa_tpu_torch.ops.dropout import keep_mask_plain, quantize_dropout_rate
from msa_tpu_torch.ops.short_attention import (
    probs_width, short_attention_packed, short_attention_packed_backward_plain,
    short_attention_packed_plain, short_attention_plain, short_attention_probs,
    short_attention_probs_backward_plain, short_attention_probs_plain)
from msa_tpu_torch.training import trainer as trainer_mod
from msa_tpu_torch.training.trainer import Trainer

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
BF16_GRAD_TOL = (2e-3, 8e-3)  # (atol, rtol)
SAME_TOL = 1e-6
JAX_RTOL = 1e-5
HEADS = 2

# tests/test_remat_policies.py's POLICIES and PROBS_POLICIES, and save_pack
POLICIES = ["full", "dots", "save_small", "save_attn", "save_ctx",
            "save_wide", "full+drop", "save_ctx+drop", "save_attn+drop",
            "save_attn+probs", "save_attn+drop+probs", "save_ctx+drop+probs",
            "full+probs", "save_pack"]


def attention_inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, s, h)).astype(np.float32)
                     for _ in range(4))
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0
    mask[1, 3:] = 0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    return q, k, v, dout, bias


def probs_to_jax(probs, s):
    """The port's [B, heads, S, probs_width(S)] signed probs in JAX's v2s
    layout [B, S, heads * round_up(S, 128)]: head h's row i at columns
    h * round_up(S, 128) + j."""
    b, heads = probs.shape[:2]
    sp = -(-s // 128) * 128
    out = np.zeros((b, s, heads, sp), np.float32)
    out[..., :s] = np.asarray(probs)[..., :s].transpose(0, 2, 1, 3)
    return out.reshape(b, s, heads * sp)


@pytest.mark.parametrize("s, dtype", [
    pytest.param(12, "float32", id="12"), pytest.param(40, "float32", id="40"),
    pytest.param(12, "bfloat16", id="12-bfloat16"),
    pytest.param(40, "bfloat16", id="40-bfloat16")])
def test_probs_plain_forward_matches_jax_v2s(s, dtype):
    """ctx and the signed probs of the plain v2s forward against JAX's v2s
    forward kernel (interpret mode), rate 0, both sides on the same values
    in ``dtype``.  In bf16 both round pd to bf16 before the PV product
    (JAX's ``pd.astype(vg.dtype)``), the rule the port's tensor-core
    forward follows."""
    q, k, v, _, bias = attention_inputs(3, s, 128, seed=s)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jout, jprobs = _v2s_fwd_call(jq, jk, jv, jnp.asarray(bias), None, HEADS,
                                 0.0, True)
    ctx, probs = short_attention_probs_plain(
        *(torch.from_numpy(np.array(x, np.float32)).to(tdt)
          for x in (jq, jk, jv)), torch.from_numpy(bias), HEADS)
    assert probs.shape == (3, HEADS, s, probs_width(s))
    assert ctx.dtype == probs.dtype == tdt
    assert not probs[..., s:].any()  # the 16-key padding holds zeros
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ctx.float().numpy(), np.asarray(jout, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(probs_to_jax(probs.float().numpy(), s),
                               np.asarray(jprobs, np.float32), atol=tol,
                               rtol=tol)


def jax_and_port(arrays, dtype):
    """``arrays`` (numpy f32) in ``dtype`` as JAX arrays, and the same
    values as torch tensors of that dtype."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = [jnp.asarray(x, jdt) for x in arrays]
    return jx, [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in jx]


def assert_grads_close(got, ref, dtype, names):
    atol, rtol = ((GRAD_TOL, GRAD_TOL) if dtype == "float32"
                  else BF16_GRAD_TOL)
    for name, g, r in zip(names, got, ref):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


# (S, dtype, H) of the entries' parity cases: head dim 64, and 32 at the
# tiny preset's H = 64
ENTRY_CASES = [
    pytest.param(12, "float32", 128, id="12"),
    pytest.param(40, "float32", 128, id="40"),
    pytest.param(12, "bfloat16", 128, id="12-bfloat16"),
    pytest.param(40, "bfloat16", 128, id="40-bfloat16"),
    pytest.param(40, "bfloat16", 64, id="40-bfloat16-d32"),
    # above 128 keys: the tiled pair's range (JAX pads the rows to 256)
    pytest.param(130, "bfloat16", 128, id="130-bfloat16"),
    pytest.param(200, "bfloat16", 64, id="200-bfloat16-d32")]


@pytest.mark.parametrize("s, dtype, h", ENTRY_CASES)
def test_probs_entry_grads_match_jax_v2s(s, dtype, h):
    """The v2s pair on CPU tensors (the plain forward stashing the probs,
    the plain backward reading them) against jax.vjp through
    short_attention_v2s (its _bwd_kernel_v2s), rate 0, both on the same
    values in ``dtype`` (bf16: both round dS and pd)."""
    q, k, v, dout, bias = attention_inputs(3, s, h, seed=10 + s)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = jax_and_port((q, k, v, dout), dtype)
    _, vjp = jax.vjp(lambda *x: short_attention_v2s(
        *x, jnp.asarray(bias), None, HEADS, 0.0, True), jq, jk, jv)
    ref = vjp(jdo)
    qq, kk, vv = (x.requires_grad_() for x in (tq, tk, tv))
    out = short_attention_probs(qq, kk, vv, torch.from_numpy(bias), HEADS)
    got = torch.autograd.grad(out, (qq, kk, vv), tdo)
    assert all(g.dtype == tq.dtype for g in got)
    assert_grads_close(got, ref, dtype, ("dq", "dk", "dv"))


def test_probs_backward_with_dropout_matches_autograd():
    """With dropout (the kernels' keep mask at a seed), the backward from
    the signed probs equals autograd through the plain attention given the
    same mask; the sign of each stashed probability is its keep bit."""
    s, rate = 40, quantize_dropout_rate(0.1)
    q, k, v, dout, bias = (torch.from_numpy(x)
                           for x in attention_inputs(2, s, 128, seed=3))
    keep = keep_mask_plain(1234, rate, 2, HEADS, s)
    ctx, probs = short_attention_probs_plain(q, k, v, bias, HEADS, rate, keep)
    assert torch.equal(probs[..., :s] > 0, keep & (probs[..., :s] != 0))
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    ref_out = short_attention_plain(qq, kk, vv, bias, HEADS, rate, keep)
    torch.testing.assert_close(ctx, ref_out, atol=0, rtol=0)
    ref = torch.autograd.grad(ref_out, (qq, kk, vv), dout)
    got = short_attention_probs_backward_plain(q, k, v, probs, dout, HEADS,
                                               rate)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(g, r, atol=FWD_TOL, rtol=FWD_TOL, msg=name)


@pytest.mark.parametrize("s, dtype, h", ENTRY_CASES)
def test_packed_entry_matches_jax_v2p(s, dtype, h):
    """The v2p pair on a CPU qkv [B, S, 3H] (plain forward, plain packed
    backward: JAX's _bwd_kernel_v2p rule, delta from each side's own ctx,
    dS and pd rounded to bf16 in bf16) against JAX's short_attention_v2p
    (interpret mode), rate 0, on the same values in ``dtype``: the output,
    and the gradient of qkv as one [B, S, 3H] tensor."""
    q, k, v, dout, bias = attention_inputs(3, s, h, seed=20 + s)
    (jqkv, jdo), (tqkv, tdo) = jax_and_port(
        (np.concatenate([q, k, v], axis=-1), dout), dtype)
    jout, vjp = jax.vjp(lambda x: short_attention_v2p(
        x, jnp.asarray(bias), None, HEADS, 0.0, True), jqkv)
    (ref,) = vjp(jdo)
    t = tqkv.requires_grad_()
    out = short_attention_packed(t, torch.from_numpy(bias), HEADS)
    (got,) = torch.autograd.grad(out, t, tdo)
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), atol=tol, rtol=tol)
    assert got.shape == t.shape and got.is_contiguous()
    assert got.dtype == t.dtype
    assert_grads_close((got,), (ref,), dtype, ("dqkv",))


def test_packed_backward_with_dropout_matches_autograd():
    """The plain packed backward with a keep mask against autograd through
    the plain packed forward given the same mask."""
    s, rate = 40, quantize_dropout_rate(0.1)
    q, k, v, dout, bias = (torch.from_numpy(x)
                           for x in attention_inputs(2, s, 128, seed=4))
    keep = keep_mask_plain(99, rate, 2, HEADS, s)
    qkv = torch.cat([q, k, v], -1).requires_grad_()
    out = short_attention_packed_plain(qkv, bias, HEADS, rate, keep)
    (ref,) = torch.autograd.grad(out, qkv, dout)
    got = short_attention_packed_backward_plain(qkv.detach(), bias, dout,
                                                HEADS, rate, keep)
    torch.testing.assert_close(got, ref, atol=FWD_TOL, rtol=FWD_TOL)


# ---------------------------------------------------------------------------
# The policies, in the whole model
# ---------------------------------------------------------------------------

L, B, VOCAB = 12, 4, 120


def model_config(dropout: bool):
    rate = 0.1 if dropout else 0.0
    bert = dataclasses.replace(
        tiny_bert_config(hidden_size=128, num_hidden_layers=2,
                         num_attention_heads=HEADS, intermediate_size=256,
                         vocab_size=VOCAB),
        hidden_dropout_prob=rate, attention_probs_dropout_prob=rate)
    return MMBertConfig(bert=bert, visual_dim=5, speech_dim=7,
                        joint_dropout_prob=0.5 if dropout else 0.0)


@pytest.fixture(scope="module")
def setup():
    cfg = model_config(False)
    jparams = init_mmbert_params(jax.random.key(0), cfg)
    split = synthetic_split(B, L, 5, 7, vocab_size=VOCAB, seed=3)
    batch = dict(next(JaxDataset(split, seed=1).epoch_batches(0, B)))
    # MLM labels on ~20% of the real tokens (under the gather cap)
    picked = np.random.default_rng(5).random(batch["text_ids"].shape) < 0.2
    batch["labels"] = np.where(picked & (batch["text_mask"] > 0),
                               batch["text_ids"], -100).astype(np.int64)
    return jax.tree.map(np.asarray, jparams), batch


def port_cfg(dropout, attention_dropout=True):
    raw = dataclasses.asdict(model_config(dropout))
    bert = port_configs.BertConfig(**raw.pop("bert"))
    if not attention_dropout:
        bert = dataclasses.replace(bert, attention_probs_dropout_prob=0.0)
    return port_configs.MMBertConfig(bert=bert, **raw)


def port_loss_and_grads(setup, policy, dropout, saved=None,
                        attention_dropout=True):
    """The port's loss and gradients (by leaf path) for ``policy``; with
    ``saved`` (a dict), the storages autograd keeps, by pointer."""
    jparams, batch = setup
    cfg = port_cfg(dropout, attention_dropout)
    params = from_jax_params(jparams, "cpu")
    leaves = dict(named_leaves(params))
    for leaf in leaves.values():
        leaf.requires_grad_()
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    t.update({k: t[k].long() for k in ("text_ids", "visual_ap", "speech_ap")})
    ids, labels = t["text_ids"], t["labels"]

    def pack(x):
        saved[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return x

    with saved_tensors_hooks(pack if saved is not None else (lambda x: x),
                             lambda x: x):
        out = mmbert_forward(
            params, ids, t["text_mask"], ids, ids, t["visual"], t["speech"],
            cfg, deterministic=not dropout,
            generator=torch.Generator().manual_seed(7), remat_policy=policy)
    loss = mmbert_loss(params, out, labels, labels, labels, t["visual_ap"],
                       t["speech_ap"], t["target"], cfg,
                       weights=t["weight"])["loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    if saved is not None:
        for leaf in leaves.values():  # the parameters are not activations
            saved.pop(leaf.untyped_storage().data_ptr(), None)
    return float(loss), dict(zip(leaves, grads))


@pytest.fixture(scope="module")
def no_remat(setup):
    return {dropout: port_loss_and_grads(setup, "none", dropout)
            for dropout in (True, False)}


def jax_loss_and_grads(setup, policy):
    jparams, batch = setup
    cfg = model_config(False)
    ids, labels = jnp.asarray(batch["text_ids"]), jnp.asarray(batch["labels"])

    def loss_fn(p):
        out = jax_mmbert_forward(
            p, ids, jnp.asarray(batch["text_mask"]), ids, ids,
            jnp.asarray(batch["visual"]), jnp.asarray(batch["speech"]), cfg,
            deterministic=True, mlm_scores=False, remat=True,
            remat_policy=policy)
        return jax_mmbert_loss(
            p, out, labels, labels, labels, jnp.asarray(batch["visual_ap"]),
            jnp.asarray(batch["speech_ap"]), jnp.asarray(batch["target"]),
            cfg, weights=jnp.asarray(batch["weight"]))["loss"]

    loss, grads = jax.value_and_grad(loss_fn)(jparams)
    return float(loss), dict(named_leaves(from_jax_params(
        jax.tree.map(np.asarray, grads), "cpu")))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_no_remat_and_jax(setup, no_remat, policy):
    """With every dropout on, the policy's loss and gradients equal the
    no-remat step's (the recompute redraws each mask from its site's seed,
    or reads it under '+drop'); with dropout off they equal JAX's step
    under the same policy."""
    loss, grads = port_loss_and_grads(setup, policy, dropout=True)
    ref_loss, ref_grads = no_remat[True]
    assert loss == pytest.approx(ref_loss, abs=SAME_TOL)
    for k, g in grads.items():
        torch.testing.assert_close(g, ref_grads[k], atol=SAME_TOL, rtol=0,
                                   msg=k)
    loss, grads = port_loss_and_grads(setup, policy, dropout=False)
    jloss, jgrads = jax_loss_and_grads(setup, policy)
    assert loss == pytest.approx(jloss, rel=JAX_RTOL)
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for k, g in grads.items():
        torch.testing.assert_close(g, jgrads[k], rtol=0,
                                   atol=JAX_RTOL * scale, msg=k)


def test_saved_bytes_follow_the_ladder(setup):
    """The activation bytes each policy keeps (every storage autograd saves
    in the forward, the parameters left out) fall in the order of JAX's
    ladder and its comments: save_wide > save_small > save_attn+drop >
    save_attn > save_ctx+drop > save_ctx > full+drop > full, none above
    all, dots between save_small and save_wide; save_pack keeps
    save_attn's bytes (here it acts as save_attn: the CPU's plain route)."""
    saved = {}
    for policy in ("none", "save_wide", "dots", "save_small", "save_pack",
                   "save_attn+drop", "save_attn", "save_ctx+drop", "save_ctx",
                   "full+drop", "full"):
        kept = {}
        port_loss_and_grads(setup, policy, dropout=True, saved=kept)
        saved[policy] = sum(kept.values())
    ladder = ["none", "save_wide", "save_small", "save_attn+drop",
              "save_attn", "save_ctx+drop", "save_ctx", "full+drop", "full"]
    for big, small in zip(ladder, ladder[1:]):
        assert saved[big] > saved[small], (big, small, saved)
    assert saved["save_wide"] > saved["dots"] > saved["save_small"], saved
    assert saved["save_pack"] == saved["save_attn"], saved


@pytest.mark.parametrize("policy", ["save_pack", "save_attn+probs",
                                    "save_ctx+drop+probs", "full+probs",
                                    "save_ctx"])
def test_short_route_policies_on_the_cpu(setup, monkeypatch, policy):
    """With the short route forced on CPU tensors (attention dropout off:
    the kernels' dropout needs the card), '+probs' runs the v2s entry and
    save_pack the packed one, each on its plain versions, and the step
    equals the no-remat step on the same route."""
    calls = {"probs": 0, "packed": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(port_attention, "attention_route",
                        lambda use_flash, seq, on_cuda: "short")
    monkeypatch.setattr(port_bert, "attention_route",
                        lambda use_flash, seq, on_cuda: "short")
    monkeypatch.setattr(port_attention, "short_attention_probs",
                        counted("probs", short_attention_probs))
    monkeypatch.setattr(port_attention, "short_attention_packed",
                        counted("packed", short_attention_packed))
    ref_loss, ref_grads = port_loss_and_grads(setup, "none", dropout=True,
                                              attention_dropout=False)
    loss, grads = port_loss_and_grads(setup, policy, dropout=True,
                                      attention_dropout=False)
    # two encoder calls of two layers each; 'full' re-runs each layer's
    # attention in its recompute
    want_probs = (8 if policy == "full+probs" else 4) if "+probs" in policy \
        else 0
    want_packed = 4 if policy == "save_pack" else 0
    assert calls == {"probs": want_probs, "packed": want_packed}
    assert loss == pytest.approx(ref_loss, abs=SAME_TOL)
    for k, g in grads.items():
        torch.testing.assert_close(g, ref_grads[k], atol=SAME_TOL, rtol=0,
                                   msg=k)


# ---------------------------------------------------------------------------
# Policy names and the 'auto' ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["dots+drop", "auto+drop", "dots+probs"])
def test_suffix_with_incompatible_base_raises(policy):
    """As in JAX: a suffix on a base that cannot honour it raises."""
    with pytest.raises(ValueError, match="does not compose"):
        port_bert.parse_remat_policy(policy)
    exp = port_configs.build_experiment("mosi", "tiny", remat_policy=policy)
    with pytest.raises(ValueError, match="does not compose"):
        Trainer(exp, "cpu")


def test_policy_names_parse_as_jax():
    assert port_bert.parse_remat_policy("save_attn+drop+probs") == \
        ("save_attn", True, True)
    assert port_bert.parse_remat_policy("full+probs+drop") == \
        ("full", True, True)
    with pytest.raises(ValueError, match="unknown"):
        port_bert.parse_remat_policy("save_everything")


def _trainer(batch, seq=40, pair=None, **train):
    exp = port_configs.build_experiment("mosi", "bert-large-uncased",
                                        train_batch_size=batch, **train)
    exp = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, max_seq_length=seq, pair_seq_length=pair))
    return Trainer(exp, "cpu")


def test_auto_walks_the_ladder(monkeypatch):
    """bert-large word-aligned B=96 in bf16: 471.9M token-layer-H elements,
    a 20.8 GB activation estimate and stashes of 5.66 (save_attn+drop),
    4.72, 2.83 and 1.89 GB (save_ctx): JAX's 6, 5, 3 and 2 bf16 units, the
    short route keeping no f32 output.  With a faked card memory M, 'auto'
    checkpoints nothing while 20.8 GB <= M / 2, then takes the first rung
    whose stash fits 6/16 of M."""
    assert _trainer(96).remat_policy == "none"  # no card: nothing
    for memory, want in ((80e9, "none"), (40e9, "save_attn+drop"),
                         (14e9, "save_attn"), (10e9, "save_ctx+drop"),
                         (6e9, "save_ctx"), (4e9, "full")):
        monkeypatch.setattr(trainer_mod, "_card_memory", lambda d: memory)
        assert _trainer(96).remat_policy == want, memory
    # an 80 GB card: B=224 passes the no-checkpoint limit (48.4 GB > 40 GB)
    monkeypatch.setattr(trainer_mod, "_card_memory", lambda d: 80e9)
    t = _trainer(224)
    assert t.activation_bytes() > 40e9 and t.remat_policy == "save_attn+drop"
    # an explicit policy always wins; remat off is "none"
    assert _trainer(224, remat_policy="save_ctx").remat_policy == "save_ctx"
    assert _trainer(224, remat=False).remat_policy == "none"


def test_auto_ladder_frame_level(monkeypatch):
    """Frame level on the flash2 route takes JAX's 10/16 budget; with
    use_flash='never' the 6/16 one.  B=16, Lp=984: 821M elements, 36.1 GB
    estimated.  On flash2 the joint passes' 98 % of the tokens also keep
    its f32 output: save_attn+drop 13.1 GB, save_attn 11.4; without it
    (never) save_attn+drop 9.9 GB, save_attn 8.2, save_ctx+drop 4.9."""
    monkeypatch.setattr(trainer_mod, "_card_memory", lambda d: 80e9)
    assert _trainer(16, pair=984).remat_policy == "none"
    monkeypatch.setattr(trainer_mod, "_card_memory", lambda d: 24e9)
    assert _trainer(16, pair=984).remat_policy == "save_attn+drop"
    assert _trainer(16, pair=984, use_flash_attention="never").remat_policy \
        == "save_attn"
