"""msa_tpu_torch's fused AdamW on the CPU against the JAX package.

* ``fused_adamw_leaf_plain`` (what CPU tensors run, and what the card
  holds the CUDA kernel against) against JAX's ``fused_adamw_leaf`` with
  the Pallas kernel in interpret mode, for each pair of moment dtypes and
  leaves of odd length: the same f32 arithmetic in the same order, so p
  within 1e-6 relative (lr, c1 and c2 enter both as the same f32 values)
  and each moment within one ulp of its dtype, taken of the size of the
  sum's terms (b1|mu| + (1-b1)|g|, b2 nu + (1-b2) g^2): the interpreted
  Pallas kernel contracts the sum into a fused multiply-add, one rounding
  fewer (one f32 ulp of a term apart on ~26 % of the elements, which a
  bf16 moment can carry into one bf16 ulp; where the terms cancel, that
  is many ulps of the result).  JAX's plain expression (use_pallas=False)
  equals the port's bit for bit.
* The port's ``FusedAdamW`` against JAX's over five steps (optax's
  schedule and count convention, the decay mask, JAX's clip rule), as
  tests/test_fused_adamw.py holds JAX's against optax: parameters within
  1e-6 (the port computes lr, c1 and c2 in double and rounds once, JAX in
  f32 on the device: one f32 ulp apart at most).
* ``Trainer(fused_optimizer=True)`` against JAX's Trainer on the same
  weights, batches and injected MLM masks (f32): test_torch_train.py's
  tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msa_tpu.ops.fused_adamw import fused_adamw_leaf as jax_fused_adamw_leaf
from msa_tpu.training.optim import FusedAdamW as JaxFusedAdamW
from msa_tpu.training.optim import linear_warmup_decay as jax_schedule
from msa_tpu_torch import configs as port_configs
from msa_tpu_torch.models.weights import from_jax_params, named_leaves
from msa_tpu_torch.ops.fused_adamw import (
    fused_adamw_leaf, fused_adamw_leaf_plain)
from msa_tpu_torch.training.optim import (
    FusedAdamW, linear_warmup_decay, make_fused_optimizer)
from test_torch_train import STEPS, run_jax, run_port

# One intra-op thread: the lane's xdist workers share the CPUs, and a
# full torch pool in each of them oversubscribes them (2x the wall time).
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# one unit in the last place, relative: 2^-23 (f32), 2^-7 (bf16)
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
MOMENTS = [("float32", "float32"), ("float32", "bfloat16"),
           ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


@pytest.mark.parametrize("shape", [(37, 29), (5,)], ids=["1073", "5"])
@pytest.mark.parametrize("mu_dt,nu_dt", MOMENTS)
def test_leaf_plain_matches_jax_kernel(mu_dt, nu_dt, shape):
    rng = np.random.default_rng(0)
    p, g, mu = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    nu = np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.01
    mu = jnp.asarray(mu, DTYPES[mu_dt][0])
    nu = jnp.asarray(nu, DTYPES[nu_dt][0])
    # the scalars as JAX's FusedAdamW makes them at count 2: f32 values
    lr, wd, c1, c2 = (np.float32(x) for x in (3e-4, 0.01, 1 - 0.9 ** 3,
                                              1 - 0.999 ** 3))
    want = jax_fused_adamw_leaf(
        jnp.asarray(p), jnp.asarray(g), mu, nu, jnp.float32(lr),
        jnp.float32(wd), jnp.float32(c1), jnp.float32(c2), use_pallas=True,
        interpret=True)
    got = fused_adamw_leaf_plain(
        torch.from_numpy(p), torch.from_numpy(g), to_torch(mu, DTYPES[mu_dt][1]),
        to_torch(nu, DTYPES[nu_dt][1]), float(lr), float(wd), float(c1),
        float(c2))
    torch.testing.assert_close(got[0], torch.from_numpy(np.array(want[0])),
                               atol=1e-6, rtol=1e-6)
    g64 = np.asarray(g, np.float64)
    terms = {"mu": 0.9 * np.abs(np.asarray(mu, np.float64)) + 0.1 * np.abs(g64),
             "nu": 0.999 * np.asarray(nu, np.float64) + 0.001 * g64 ** 2}
    for name, t, w, dt in (("mu", got[1], want[1], mu_dt),
                           ("nu", got[2], want[2], nu_dt)):
        assert t.dtype == DTYPES[dt][1], name
        err = np.abs(t.double().numpy() - np.asarray(w, np.float64))
        assert (err <= ULP[dt] * terms[name]).all(), (name, err.max())
    plain = jax_fused_adamw_leaf(
        jnp.asarray(p), jnp.asarray(g), mu, nu, jnp.float32(lr),
        jnp.float32(wd), jnp.float32(c1), jnp.float32(c2), use_pallas=False)
    for t, w, dt in zip(got, plain, ("float32", mu_dt, nu_dt)):
        assert torch.equal(t, to_torch(w, DTYPES[dt][1]))


def test_leaf_updates_in_place_on_the_cpu():
    """The entry point on CPU tensors: the plain version, written into p,
    mu and nu; the clip scale multiplies g first; no kernel launch."""
    rng = np.random.default_rng(1)
    p, g, mu, nu = (torch.from_numpy(rng.standard_normal(7).astype(np.float32))
                    for _ in range(4))
    nu = nu.abs()
    mu16 = mu.to(torch.bfloat16)
    scale = torch.tensor(0.5)
    want = fused_adamw_leaf_plain(p, g * 0.5, mu16, nu, 1e-3, 0.01, 0.1,
                                  0.001)
    launches = fused_adamw_leaf.launches
    out = fused_adamw_leaf(p, g, mu16, nu, 1e-3, 0.01, 0.1, 0.001,
                           clip_scale=scale)
    assert fused_adamw_leaf.launches == launches
    assert out[0] is p and out[1] is mu16 and out[2] is nu
    for a, b in zip((p, mu16, nu), want):
        assert torch.equal(a, b)


def tree():
    """tests/test_fused_adamw.py's tree, with odd-sized leaves."""
    k = jax.random.split(jax.random.key(0), 4)
    return {
        "layers": {"wi": {"kernel": jax.random.normal(k[0], (3, 16, 40)),
                          "bias": jnp.zeros((3, 40))}},
        "ln": {"scale": jnp.ones((16,)), "bias": jnp.zeros((16,))},
        "head": {"kernel": jax.random.normal(k[1], (16, 5)) * 0.1,
                 "bias": jnp.zeros((5,))},
        "odd": {"kernel": jax.random.normal(k[2], (7, 13))},
    }


def grads_for(params, seed):
    ks = jax.random.split(jax.random.key(seed), len(jax.tree.leaves(params)))
    flat, td = jax.tree.flatten(params)
    return jax.tree.unflatten(
        td, [jax.random.normal(k, p.shape) * 0.1 for k, p in zip(ks, flat)])


def torch_tree(params):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)),
                        params)


@pytest.mark.parametrize("clip,moments", [
    (0.0, "float32"), (0.1, "float32"), (0.0, "bfloat16")],
    ids=["f32", "clip", "bf16_moments"])
def test_fused_optimizer_matches_jax(clip, moments):
    """Five steps of the port's FusedAdamW against JAX's FusedAdamW (its
    Pallas kernel in interpret mode) on the same gradients: parameters
    within 1e-6.  With max_grad_norm 0.1 every step clips (the gradients'
    norm is ~2.6)."""
    jsched = jax_schedule(1e-3, 100, 0.1)
    fused = JaxFusedAdamW(jsched, weight_decay=0.01, max_grad_norm=clip,
                          mu_dtype=moments, nu_dtype=moments, use_pallas=True,
                          interpret=True)
    port = FusedAdamW(linear_warmup_decay(1e-3, 100, 0.1), weight_decay=0.01,
                      max_grad_norm=clip, mu_dtype=moments, nu_dtype=moments)
    p_j = tree()
    s_j = fused.init(p_j)
    p_t = torch_tree(p_j)
    s_t = port.init(p_t)
    apply = jax.jit(fused.apply)
    for step in range(5):
        g = grads_for(p_j, step)
        p_j, s_j = apply(p_j, g, s_j)
        port.step(p_t, dict(named_leaves(torch_tree(g))), s_t)
    assert s_t.count == int(s_j["count"]) == 5
    want = dict(named_leaves(torch_tree(p_j)))
    for path, t in named_leaves(p_t):
        torch.testing.assert_close(t, want[path], atol=1e-6, rtol=1e-6,
                                   msg=path)
    mu = dict(named_leaves(s_t.mu))["layers/wi/kernel"]
    assert mu.dtype == DTYPES[moments][1]


def test_make_fused_optimizer_refuses_accumulation_as_jax():
    tc = port_configs.TrainConfig(fused_optimizer=True,
                                  gradient_accumulation_steps=2)
    with pytest.raises(ValueError, match="gradient accumulation"):
        make_fused_optimizer(tc, 10)
    opt = make_fused_optimizer(dataclasses.replace(
        tc, gradient_accumulation_steps=1, adam_nu_dtype="bfloat16"), 10)
    assert isinstance(opt, FusedAdamW) and opt.nu_dtype == torch.bfloat16


@pytest.fixture(scope="module")
def jax_fused_run():
    return run_jax("float32", fused_optimizer=True)


def test_train_step_fused_optimizer_matches_jax_f32(jax_fused_run):
    """Four f32 steps of Trainer(fused_optimizer=True) against JAX's
    Trainer with its FusedAdamW (the plain expression, as JAX's Trainer
    runs it off the TPU) on the same weights, optimizer state, batches and
    MLM masks: test_torch_train.py's f32 tolerances (losses rtol 1e-5,
    parameters atol 1e-5)."""
    start, jhist, jparams = jax_fused_run
    hist, params = run_port("float32", start, fused_optimizer=True)
    assert len(hist) == len(jhist) == STEPS
    for got, want in zip(hist, jhist):
        for k in ("loss", "mlm_loss", "ap_loss", "label_loss", "nce"):
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k
    ref = {k: v.detach() for k, v in named_leaves(
        from_jax_params(jparams, "cpu"))}
    for k, v in params.items():
        torch.testing.assert_close(v.detach(), ref[k], atol=1e-5, rtol=0,
                                   msg=k)
