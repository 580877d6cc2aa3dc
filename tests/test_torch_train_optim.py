"""The port's optimizer (posteriflow_torch/train/trainer.py Optimizer)
against optax on the CPU, on the same parameters and gradients: the
warmup-cosine schedule, global-norm clipping, adaptive gradient clipping
with optax 0.2.6's per-unit norms over axis 0 of the flax layout, and
three AdamW steps of the JAX package's chain (make_optimizer).

Gradients are handed to both sides from numpy (the same arrays), so that
the test holds the optimizer's formulas and not the model's gradients,
which tests/test_torch_train_step.py holds. Tolerances, from float32
rounding: the schedule to 1e-6 relative (optax computes it in float32,
the port in float64 before one rounding); the clipped gradients to 1e-5 of
their largest entry (the global norm of ~3e5 float32 squares is summed in
other orders: optax's and the port's differ from the float64 norm by
1.5e-6 and 4.9e-6 on these gradients); the parameters after each of three
steps to 2e-5 of the largest distance they moved (the clip's factor
reaches the update where |g| is near Adam's eps, and the bias correction
and schedule round in float32 in optax) plus two float32 steps of the
largest parameter (the rounding of p + u).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posteriflow_tpu.train.trainer import make_optimizer
from posteriflow_torch.train.checkpoints import flax_view
from posteriflow_torch.train.trainer import Optimizer, learning_rate
from torch_train_helpers import (CONFIGS, jax_params, port_config,
                                 port_model, to_state_dict)


def _random_grads(params, seed, spread=True):
    """A gradient tree like `params`: N(0, 1) entries, each leaf (and with
    `spread` each unit along the last axis) scaled by 10^U(-4, 0), so that
    clipping takes some units and leaves others."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for leaf in leaves:
        g = rng.standard_normal(leaf.shape)
        scale = 10.0 ** rng.uniform(-4, 0, leaf.shape[-1:] if spread
                                    and leaf.ndim else ())
        out.append(jnp.asarray((g * scale).astype(np.float32)))
    return jax.tree_util.tree_unflatten(treedef, out)


def _set_grads(model, grads):
    sd = to_state_dict(grads)
    for name, p in model.named_parameters():
        p.grad = sd[name].clone()


@pytest.mark.parametrize("warmup,total", [(2, 10), (5, 50), (500, 60000)])
def test_schedule_matches_optax(warmup, total):
    """lr 0 at count 0, the linear warmup, the cosine to the 1% floor, and
    the floor after total_steps."""
    cfg = dataclasses.replace(port_config(CONFIGS["conv"]), lr=3e-4,
                              warmup_steps=warmup, total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.lr, warmup_steps=warmup,
        decay_steps=total, end_value=0.01 * cfg.lr)
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 7, *range(0, 12)})
    assert learning_rate(cfg, 0) == 0.0
    for c in counts:
        ref = float(sched(c))
        assert abs(learning_rate(cfg, c) - ref) <= 1e-6 * cfg.lr, c


@pytest.mark.parametrize("scale", [1e-3, 1e3], ids=["under", "over"])
def test_global_clip_matches_optax(scale):
    """Under the threshold the gradients pass unchanged; over it they are
    scaled to norm grad_clip."""
    jcfg = CONFIGS["conv"]
    params = jax_params(jcfg)
    grads = jax.tree_util.tree_map(lambda g: g * scale,
                                   _random_grads(params, 1))
    clip = optax.clip_by_global_norm(jcfg.grad_clip)
    ref, _ = clip.update(grads, clip.init(params))
    model = port_model(jcfg, params)
    _set_grads(model, grads)
    opt = Optimizer(model, port_config(jcfg))
    opt.clip_(opt.grads())
    _assert_grads_close(model, ref)
    norm = float(optax.global_norm(grads))
    assert (norm < jcfg.grad_clip) == (scale < 1.0)


def test_agc_matches_optax_per_unit_over_flax_axis_0():
    """adaptive_grad_clip(0.01·grad_clip) on the coherent config, whose
    leaves cover Dense, Conv, attention q/k/v/out kernels and biases,
    LayerNorm, Embed and the raw params: the port's per-unit norms are
    taken on each leaf's flax view, and clipping takes some units and
    leaves others."""
    jcfg = dataclasses.replace(CONFIGS["coherent"], grad_clip_mode="agc")
    params = jax_params(jcfg)
    grads = _random_grads(params, 2)
    agc = optax.adaptive_grad_clip(0.01 * jcfg.grad_clip)
    ref, _ = agc.update(grads, agc.init(params), params)
    model = port_model(jcfg, params)
    _set_grads(model, grads)
    before = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt = Optimizer(model, port_config(jcfg))
    opt.clip_(opt.grads())
    _assert_grads_close(model, ref)
    grads_now = {n: p.grad for n, p in model.named_parameters()}
    changed = sum(int((grads_now[n] != g).sum()) for n, g in before.items())
    assert 0 < changed < sum(g.numel() for g in before.values())
    # a q/k/v kernel [in, heads, hd] is clipped per (head, hd) entry
    name = "encoder.fusion_0.MultiHeadDotProductAttention_0.query.weight"
    ratio = (flax_view(model, name, grads_now[name])
             / flax_view(model, name, before[name]))
    assert ratio.shape == (32, 4, 8)
    assert torch.allclose(ratio, ratio[:1], rtol=1e-6)
    assert len(torch.unique(ratio[0])) > 1


def _assert_grads_close(model, ref_tree):
    ref = to_state_dict(ref_tree)
    for name, p in model.named_parameters():
        r = ref[name]
        d = float((p.grad - r).abs().max())
        assert d <= 1e-5 * float(r.abs().max()) + 1e-12, (name, d)


@pytest.mark.parametrize("mode", ["global", "agc"])
def test_three_adamw_steps_match_optax(mode):
    """make_optimizer's chain (clip, then AdamW with the schedule and the
    weight decay, 1e-2 here so that it shows) for three steps from the same
    parameters with the same gradients: the first step moves nothing (lr
    0), and every leaf decays, biases included."""
    jcfg = dataclasses.replace(CONFIGS["conv"], grad_clip_mode=mode,
                               weight_decay=1e-2, grad_clip=0.5)
    params = jax_params(jcfg)
    tx = make_optimizer(jcfg)
    state = tx.init(params)
    model = port_model(jcfg, params)
    opt = Optimizer(model, port_config(jcfg))
    jp = params
    p0 = to_state_dict(params)
    for step in range(3):
        grads = _random_grads(params, 10 + step)
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        _set_grads(model, grads)
        before = [p.detach().clone() for p in model.parameters()]
        opt.step()
        moved = any(not torch.equal(a, p) for a, p in
                    zip(before, model.parameters()))
        assert moved == (step > 0)
        ref = to_state_dict(jp)
        for name, p in model.named_parameters():
            r = ref[name]
            d = float((p.detach() - r).abs().max())
            tol = (2e-5 * float((r - p0[name]).abs().max())
                   + 2.4e-7 * float(r.abs().max()) + 1e-12)
            assert d <= tol, (step, name, d, tol)
    assert opt.count == 3
