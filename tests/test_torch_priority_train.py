"""The PriorityNet trainer of the port against the JAX package on the CPU:
make_priority_batch on JAX's simulation and jitter draws (hard-pair mining
on), one training step's loss and gradients, the Adam update against
optax, a short fit that learns, and loading what fit writes.

Tolerances: the mined events are the same (recovered from JAX's candidate
rows); candidate params, snr_est and targets within 1e-4 of their largest
|value|; segments within 1e-4 plus 2e-3 of the peak of the whitened
signal, the simulator tests' strain tolerance (tests/test_torch_sim_*.py:
the float32 waveform phase of the two packages differs at that level);
the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
largest |entry| plus 1e-6 of the largest entry of any leaf; the Adam
update within 1e-6 of each parameter's largest |entry| (float32 formulas
in another order)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch_overlap_helpers import (  # noqa: F401
    jax_priority_draws, one_torch_thread)

from posteriflow_tpu.models.priority_net import PriorityNet as JNet
from posteriflow_tpu.models.priority_net import ranking_loss as jloss_fn
from posteriflow_tpu.train.train_priority import PriorityTrainConfig as JCfg
from posteriflow_tpu.train.train_priority import \
    make_priority_batch as jmake_batch
from posteriflow_torch.train import train_priority as tp

JCFG = JCfg(batch_size=4, max_signals=3, d_model=32, mine_pool=2,
            use_dt=True, residual_snr=True, close_boost=2.0)
TCFG = tp.PriorityTrainConfig(**dataclasses.asdict(JCFG))


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_priority_batch_matches_jax_draws():
    key = jax.random.PRNGKey(3)
    ref = [np.asarray(a) for a in jax.jit(
        lambda k: jmake_batch(k, JCFG))(key)]
    sim, jitter = jax_priority_draws(key, JCFG)
    got = [a.numpy() for a in tp.make_priority_batch(TCFG, device="cpu",
                                                     sim=sim, jitter=jitter)]
    segs, cand, mask, targets, snr, snr_est = got
    # the mined events: JAX's candidate rows back to the pool's events
    ev = tp.simulate_batch(8, TCFG.sim, device="cpu", params=sim[0],
                           n_sig=sim[1], draws=sim[2])
    pool = ev.params.numpy()                          # gated, ranked
    j_true = ref[1] / (1.0 + JCFG.param_jitter * jitter.numpy())
    j_idx = [int(np.argmin(np.abs(pool - row).sum(axis=(1, 2))))
             for row in j_true]
    idx = tp.hardest_events(ev.n_sig, ev.sig_snr, 4).tolist()
    assert idx == j_idx
    np.testing.assert_array_equal(mask, ref[2])
    for name, a, b in (("cand", cand, ref[1]), ("targets", targets, ref[3]),
                       ("snr", snr, ref[4]), ("snr_est", snr_est, ref[5])):
        assert _max_rel(a, b) <= 1e-4, (name, _max_rel(a, b))
    # the whitened signal of the kept events: JAX's strain less the noise
    signal = ev.strain.numpy() - sim[2].noise.numpy()
    peak = float(np.abs(signal[idx]).max())
    assert np.abs(segs - ref[0]).max() <= 1e-4 + 2e-3 * peak
    assert segs.shape == (4, 3, 3, 2048) and np.isfinite(snr_est).all()


def _batch(seed=5):
    gen = torch.Generator().manual_seed(seed)
    return tp.make_priority_batch(TCFG, gen, "cpu")


def _pair(seed=0):
    batch = [a.numpy() for a in _batch()]
    segs, cand, mask, _, _, snr_est = batch
    jnet = JNet(d_model=32, use_energy=True, use_snr_est=True, use_dt=True,
                residual_snr=True)
    jp = jax.jit(lambda k: jnet.init(
        k, jnp.asarray(segs), jnp.asarray(cand), jnp.asarray(mask),
        with_aux=True, snr_est=jnp.asarray(snr_est)))(
        jax.random.PRNGKey(seed))
    net = tp.net_from_config(TCFG)
    net.load_state_dict(tp.priority_flax_to_state_dict(jax.device_get(jp)))
    return jnet, jp, net, batch


def test_train_step_loss_and_gradients_match_jax():
    jnet, jp, net, batch = _pair()
    segs, cand, mask, targets, snr, snr_est = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        scores, sigma, aux = jnet.apply(p, segs, cand, mask, with_aux=True,
                                        snr_est=snr_est)
        return jloss_fn(scores, targets, sigma, mask, aux=aux, snr=snr,
                        close_boost=JCFG.close_boost)

    j_loss, j_grad = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss = tp.priority_loss(net, [torch.from_numpy(a) for a in batch], TCFG)
    tp.backward(loss)
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    ref = tp.priority_flax_to_state_dict(jax.device_get(j_grad))
    top = max(float(g.abs().max()) for g in ref.values())
    for k, p in net.named_parameters():
        err = float((p.grad - ref[k]).abs().max())
        assert err <= 1e-4 * float(ref[k].abs().max()) + 1e-6 * top, (k, err)


def test_adam_update_matches_optax():
    net = tp.init_priority_net(tp.net_from_config(TCFG),
                               torch.Generator().manual_seed(1))
    steps, lr = 50, 1e-3
    opt = tp.PriorityOptimizer(net, lr, steps)
    assert opt.lr() == 0.0 and opt.warmup == 5
    names = [n for n, _ in net.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    tx = optax.adam(optax.warmup_cosine_decay_schedule(
        0.0, lr, min(100, steps // 10), max(steps, 2), 0.05 * lr))
    state = tx.init(params)
    rng = np.random.default_rng(2)
    for _ in range(8):
        grads = {n: rng.standard_normal(v.shape).astype(np.float32)
                 for n, v in params.items()}
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
    assert opt.count == 8
    for n, p in zip(names, net.parameters()):
        ref = np.asarray(params[n])
        err = float(np.abs(p.detach().numpy() - ref).max())
        assert err <= 1e-6 * max(float(np.abs(ref).max()), 1.0), (n, err)


def test_fit_priority_learns_and_reloads(tmp_path):
    cfg = tp.PriorityTrainConfig(batch_size=8, max_signals=3, d_model=32)
    net, hist = tp.fit_priority(tmp_path, cfg, steps=60, eval_every=30,
                                device="cpu")
    assert [h["step"] for h in hist] == [1, 30, 60]
    assert set(hist[0]) == {"step", "loss", "top1_acc", "seconds"}
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert json.loads((tmp_path / "history.json").read_text()) == hist
    meta = json.loads((tmp_path / "net.json").read_text())
    assert meta == {"d_model": 32, "use_energy": True, "use_snr_est": True,
                    "use_dt": False, "residual_snr": False,
                    "train": {"close_boost": 0.0, "mine_pool": 1}}
    again = tp.load_priority_net(tmp_path, device="cpu")
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_load_release_by_directory_or_file():
    from torch_overlap_helpers import ROOT
    d = ROOT / "model_release" / "priority_v5"
    a = tp.load_priority_net(d, device="cpu")
    b = tp.load_priority_net(d / "priority_params.msgpack", device="cpu")
    assert not a.use_dt and not a.residual_snr and not a.training
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
