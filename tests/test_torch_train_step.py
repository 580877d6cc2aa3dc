"""The port's training step against the JAX package on the CPU:
batch_nll's loss and every gradient leaf against
jax.value_and_grad(batch_nll) on the same batch and parameters, init_params
against flax's initial distribution, and flax_view against the flax layout.

The batch is built from numpy (port prior draws, N(0, 1) strain), so no
simulator is compiled; JAX's init_state parameters are carried into the
port with flax_to_state_dict, and its gradients through the same map.

Tolerances. float32 (flow and encoder): the loss to 1e-5 relative, each
gradient leaf's max |Δ| to 1e-4 of its largest entry, after an allowance
of 1e-6 of the largest entry of any leaf for leaves that are zero or near
it (measured: the losses equal, the leaves within 7.3e-7 of their largest
entry). bfloat16 as the conditioner runs it by default (the encoder
float32): the loss to 1e-3 relative and the global gradient norm to 1e-2
(measured 2.4e-7 and 2.1e-4); bf16 rounds at other places in the two
frameworks, and one flipped rounding moves a gradient far more than it
moves the loss.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.train.trainer import batch_nll as jbatch_nll
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.train.checkpoints import flax_view
from posteriflow_torch.train.trainer import (backward, batch_nll,
                                             component_grad_norms,
                                             global_norm, init_params)
from torch_train_helpers import (CONFIGS, batches, jax_params, port_config,
                                 port_model, to_state_dict, with_dtype)

B = 4


def _jax_loss_and_grads(jcfg, params, jbatch):
    model = JNPE(jcfg.npe)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jbatch_nll(model, p, b)))(params, jbatch)
    return float(loss), to_state_dict(grads)


def _port_loss_and_grads(jcfg, params, tbatch):
    model = port_model(jcfg, params)
    loss = batch_nll(model, tbatch)
    backward(loss)
    return (float(loss.detach()), model,
            {n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("enc", sorted(CONFIGS))
def test_batch_nll_loss_and_grads_float32(enc):
    jcfg = with_dtype(CONFIGS[enc], "float32")
    params = jax_params(jcfg)
    (jb, tb), = batches(jcfg, 1, B, seed=3)
    assert int(jb.n_sig.sum()) >= 2
    jl, jg = _jax_loss_and_grads(jcfg, params, jb)
    tl, model, tg = _port_loss_and_grads(jcfg, params, tb)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    scale = max(float(g.abs().max()) for g in jg.values())
    for name, g in jg.items():
        d = float((tg[name] - g).abs().max())
        assert d <= 1e-4 * float(g.abs().max()) + 1e-6 * scale, (name, d)
    # the component norms are the norms of the JAX subtrees' leaves
    norms = component_grad_norms(model)
    for key, prefix in (("gn_encoder", "encoder."), ("gn_flow", "flow."),
                        ("gn_rank", "rank_embed.")):
        ref = global_norm([g for n, g in jg.items() if n.startswith(prefix)])
        assert abs(float(norms[key]) - float(ref)) <= 1e-4 * float(ref)


def test_batch_nll_bfloat16_conditioner_coarse():
    jcfg = with_dtype(CONFIGS["conv"], "float32")
    jcfg = dataclasses.replace(jcfg, npe=dataclasses.replace(
        jcfg.npe, flow_dtype="bfloat16"))
    params = jax_params(jcfg)
    (jb, tb), = batches(jcfg, 1, B, seed=4)
    jl, jg = _jax_loss_and_grads(jcfg, params, jb)
    tl, _, tg = _port_loss_and_grads(jcfg, params, tb)
    assert abs(tl - jl) <= 1e-3 * abs(jl), (tl, jl)
    jn = float(global_norm(list(jg.values())))
    tn = float(global_norm(list(tg.values())))
    assert abs(tn - jn) <= 1e-2 * jn, (tn, jn)


def test_dead_slots_take_no_gradient_from_their_params():
    """Slots past n_sig are masked: moving their parameters does not move
    the loss."""
    jcfg = CONFIGS["conv"]
    params = jax_params(jcfg)
    (_, tb), = batches(jcfg, 1, B, seed=5)
    model = port_model(jcfg, params)
    loss = batch_nll(model, tb)
    dead = torch.arange(tb.params.shape[1])[None, :] >= tb.n_sig[:, None]
    assert bool(dead.any())
    moved = tb._replace(params=torch.where(dead[..., None], tb.params * 1.3,
                                           tb.params))
    assert float(batch_nll(model, moved).detach()) == float(loss.detach())


@pytest.mark.parametrize("enc", sorted(CONFIGS))
def test_flax_view_is_the_flax_layout(enc):
    """Every parameter viewed through flax_view is JAX's leaf, and a write
    to the view writes the parameter."""
    jcfg = CONFIGS[enc]
    params = jax_params(jcfg)
    leaves = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params["params"])[0]:
        keys = [k.key for k in path]
        leaf = "weight" if keys[-1] in ("kernel", "scale",
                                        "embedding") else keys[-1]
        leaves[".".join(keys[:-1] + [leaf])] = np.asarray(v)
    model = port_model(jcfg, params)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(leaves)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(
            flax_view(model, name, p.detach()).numpy(), leaves[name],
            err_msg=name)
    w = model.flow.cond_0.in_x.weight.detach().clone()
    flax_view(model, "flow.cond_0.in_x.weight", w)[0, 1] = 7.0
    assert float(w[1, 0]) == 7.0


@pytest.mark.parametrize("enc", sorted(CONFIGS))
def test_init_params_matches_flax_moments(enc):
    """Each leaf of init_params against the same leaf of JAX's init_state:
    constant leaves (zero biases, LayerNorm ones, the conditioners' zero
    output projections) equal; random ones within 5 standard errors in mean
    and standard deviation (two independent estimates of n entries: the
    std's ratio within 5/sqrt(n), the means within 5·σ·sqrt(2/n))."""
    jcfg = CONFIGS[enc]
    jp = to_state_dict(jax_params(jcfg, seed=1))
    model = init_params(TNPE(port_config(jcfg).npe),
                        torch.Generator().manual_seed(1))
    n_random = 0
    for name, p in model.named_parameters():
        t, j = p.detach().double(), jp[name].double()
        assert t.shape == j.shape, name
        if float(j.std()) == 0.0 or t.numel() < 2:
            assert torch.equal(t, j), name
            continue
        n = t.numel()
        sj, st = float(j.std()), float(t.std())
        assert abs(st / sj - 1.0) <= 5.0 / np.sqrt(n), (name, st, sj)
        assert abs(float(t.mean() - j.mean())) <= 5.0 * sj * np.sqrt(2.0 / n)
        assert float(t.abs().max()) <= float(j.abs().max()) * 1.5 + 1e-12, \
            name
        n_random += 1
    assert n_random >= 10
