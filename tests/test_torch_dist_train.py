"""The port's data parallelism (posteriflow_torch/parallel/mesh.py) on the
CPU: two gloo processes on a ('data' 2, 'model' 1) mesh against one
process without a group, and against the JAX package's sharded step on
the conftest's CPU mesh, for the flagship's step, its simulated step, the
batched decompose and fit; the mesh's own checks; a one-rank group
bit-equal to no group; and tools/dryrun_multichip.py.

Every process runs the port with one torch thread; the rank functions
are in tests/torch_dist_helpers.py.

Tolerances (float32 flow and encoder). World 2 against world 1 on the
same global batch: the loss within 1e-6 relative, each gradient leaf and
each parameter after one step within 1e-5 of the leaf's largest entry
plus 1e-7 of the largest entry of any leaf (the two worlds sum the
gradient in another order). Against JAX's sharded loss and gradient:
tests/test_torch_train_step.py's float32 bars (loss 1e-5 relative,
leaves 1e-4 + 1e-6). The decompositions as
tests/test_torch_overlap_decompose.py holds them (1e-3 of each array's
largest |value|, accepted flags equal).
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from posteriflow_tpu.parallel.mesh import shard_batch as jshard_batch
from posteriflow_tpu.physics.simulator import SimConfig as JSimConfig
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.train import trainer as jtrainer
from posteriflow_torch.models.npe import LeanNPE
from posteriflow_torch.parallel import mesh as pmesh
from posteriflow_torch.physics.simulator import simulate_batch
from posteriflow_torch.tools import dryrun_multichip
from posteriflow_torch.train.checkpoints import (_cfg_to_dict,
                                                 train_cfg_from_dict)
from torch_dist_helpers import (flagship_decompose, flagship_loss_grads,
                                flagship_one_step, flagship_sim_step,
                                flagship_suite, run_ranks)
from torch_sim_helpers import one_torch_thread  # noqa: F401
from torch_train_helpers import (CONFIGS, batches, jax_params, port_config,
                                 to_state_dict, with_dtype)

JCFG = with_dtype(CONFIGS["conv"], "float32")
# tests/test_multihost.py's child config (its two processes' step)
MULTIHOST = dataclasses.replace(
    CONFIGS["conv"], sim=JSimConfig(prior=JPrior(max_signals=2)),
    batch_size=16, lr=3e-4)
# the shards of the fixed batch carry 8 and 3 live slots
N_SIG = np.array([2, 2, 2, 2, 1, 0, 1, 1], np.int32)
DECOMPOSE_KW = dict(n_samples=64, max_stages=2, quality_threshold=0.01,
                    n_template_draws=16)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _cfg(jcfg, **kw):
    return _cfg_to_dict(dataclasses.replace(port_config(jcfg), **kw))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The flagship suite on two ranks, with its inputs."""
    tmp = tmp_path_factory.mktemp("dist")
    params = jax_params(JCFG)
    (jb, tb), = batches(JCFG, 1, 8, seed=3)
    jb = jb._replace(n_sig=jax.numpy.asarray(N_SIG))
    tb = tb._replace(n_sig=torch.from_numpy(N_SIG))
    cfg = port_config(JCFG)
    ev = simulate_batch(4, cfg.sim, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    payload = dict(
        cfg=_cfg(JCFG), step_cfg=_cfg(JCFG, warmup_steps=0),
        sim_cfg=_cfg(MULTIHOST), sim_seed=7,
        fit_cfg=_cfg(JCFG, batch_size=4, warmup_steps=1, total_steps=50),
        fit_dir=str(tmp / "fit"), state_dict=to_state_dict(params),
        batch=tb._asdict(), strain=ev.strain, bands=ev.asd_bands,
        decompose_kw=DECOMPOSE_KW)
    outs = run_ranks(tmp / "ranks", 2, flagship_suite, payload)
    return params, jb, payload, outs


def _leaf_close(got: dict, ref: dict, rel: float, floor: float):
    assert set(got) == set(ref)
    scale = max(float(g.abs().max()) for g in ref.values())
    for name, r in ref.items():
        d = float((got[name] - r).abs().max())
        assert d <= rel * float(r.abs().max()) + floor * scale, (name, d)


def _model(sd):
    model = LeanNPE(port_config(JCFG).npe)
    model.load_state_dict(sd)
    return model


def test_mesh_loss_and_grads_match_world1_and_jax(world2):
    """The global loss and gradient of a batch whose two shards carry 8
    and 3 live slots, on two ranks, against one process and against JAX's
    value_and_grad of batch_nll under shard_batch on a 2-device mesh
    (make_train_step's loss, posteriflow_tpu/train/trainer.py:146-157);
    the mean of the shards' own means is off by more than the bar."""
    params, jb, p, outs = world2
    ref_loss, ref_grads = flagship_loss_grads(
        _model(p["state_dict"]), jtrainer_batch(p), None)
    for loss, grads in (o["loss_grads"] for o in outs):
        assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss), (loss,
                                                              ref_loss)
        _leaf_close(grads, ref_grads, 1e-5, 1e-7)
    halves = [flagship_loss_grads(_model(p["state_dict"]),
                                  jtrainer_batch(p, rows), None)[0]
              for rows in (slice(0, 4), slice(4, 8))]
    assert abs(np.mean(halves) - ref_loss) > 1e-3 * abs(ref_loss)

    mesh = jmake_mesh(2)
    model = JNPE(JCFG.npe)
    jl, jg = jax.jit(jax.value_and_grad(lambda q, b: jtrainer.batch_nll(
        model, q, jshard_batch(mesh, b))))(params, jb)
    jl, jg = float(jl), to_state_dict(jg)
    assert abs(outs[0]["loss_grads"][0] - jl) <= 1e-5 * abs(jl)
    _leaf_close(outs[0]["loss_grads"][1], jg, 1e-4, 1e-6)


def jtrainer_batch(p, rows=slice(None)):
    from posteriflow_torch.physics.simulator import EventBatch
    return EventBatch(**{k: v[rows] for k, v in p["batch"].items()})


def test_mesh_train_step_matches_world1(world2):
    """One train_step (warmup 0, so the update is not lr 0's) on two
    ranks: the global metrics and every parameter after the step against
    the unsharded step on the same batch, the same on both ranks."""
    _, _, p, outs = world2
    ref_m, ref_p = flagship_one_step(train_cfg_from_dict(p["step_cfg"]),
                                     p["state_dict"], jtrainer_batch(p),
                                     None)
    for m, params in (o["one_step"] for o in outs):
        assert set(m) == set(ref_m)
        for k, v in ref_m.items():
            assert abs(m[k] - v) <= 1e-5 * abs(v) + 1e-7, (k, m[k], v)
        moved = {n: params[n] - t.detach() for n, t in _model(
            p["state_dict"]).named_parameters()}
        assert max(float(d.abs().max()) for d in moved.values()) > 0
        _leaf_close(params, ref_p, 1e-5, 1e-7)
    assert outs[0]["one_step"][0] == outs[1]["one_step"][0]


def test_two_process_simulated_step(world2, monkeypatch):
    """The twin of tests/test_multihost.py:76: make_train_step(cfg,
    mesh=) of its config over two processes, each simulating its 8 rows
    of the 16 events the generator draws: the same finite NLL on both
    ranks, equal to one process's unsharded step on that generator, and
    the parameters after it likewise. JAX's make_train_step on a 2-device
    mesh, given the port's batch in place of its own simulation, reads
    the same NLL (1e-5 relative) and gradient norm (1e-4)."""
    _, _, p, outs = world2
    cfg = train_cfg_from_dict(p["sim_cfg"])
    ref_m, ref_p = flagship_sim_step(cfg, None, p["sim_seed"])
    (m0, p0), (m1, _) = (o["sim_step"] for o in outs)
    assert m0["nll"] == m1["nll"] and np.isfinite(m0["nll"])
    assert abs(m0["grad_norm"]) < 1e4
    for k, v in ref_m.items():
        assert abs(m0[k] - v) <= 1e-5 * abs(v) + 1e-6, (k, m0[k], v)
    _leaf_close(p0, ref_p, 1e-5, 1e-7)

    # JAX's step on the port's batch (its simulate_batch replaced) and the
    # same initial weights
    from posteriflow_torch.train.trainer import init_state
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = simulate_batch(cfg.batch_size, cfg.sim, device="cpu",
                           generator=torch.Generator().manual_seed(
                               p["sim_seed"]))
    from posteriflow_torch.train.checkpoints import state_dict_to_flax
    jstate = jax.jit(lambda k: jtrainer.init_state(k, MULTIHOST))(
        jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, state_dict_to_flax(state.model)))
    jbatch = jtrainer.EventBatch(**{k: jax.numpy.asarray(v.numpy())
                                    for k, v in batch._asdict().items()})
    monkeypatch.setattr(jtrainer, "simulate_batch",
                        lambda key, n, sim, bank=None: jbatch)
    _, jm = jtrainer.make_train_step(MULTIHOST, mesh=jmake_mesh(2))(
        jstate, jax.random.PRNGKey(1))
    assert abs(m0["nll"] - float(jm["nll"])) <= 1e-5 * abs(float(jm["nll"]))
    assert abs(m0["grad_norm"] - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])


def test_mesh_batched_decompose_matches_world1(world2):
    """make_batched_decompose(mesh=) on two ranks: each decomposes 2 of
    the 4 events with its rows of the stages' base draws, and both return
    the gathered result of one process's unsharded call."""
    _, _, p, outs = world2
    ref = flagship_decompose(train_cfg_from_dict(p["cfg"]), p["state_dict"],
                             p["strain"], p["bands"], None,
                             p["decompose_kw"])
    for got in (o["decompose"] for o in outs):
        assert got.keys() == ref.keys()
        for k in ("accepted", "n_extracted"):
            assert torch.equal(got[k], ref[k]), k
        for k in ("median", "alpha", "quality", "fit_snr",
                  "final_residual"):
            tol = 1e-3 * float(ref[k].abs().max()) + 1e-6
            assert float((got[k] - ref[k]).abs().max()) <= tol, k
    assert 0 < int(ref["accepted"].sum()) < 8


def test_mesh_fit_rank0_writes_and_resumes(world2):
    """fit(mesh=) over two ranks for an epoch of 2 steps, then resumed for
    one more: every rank returns the same history, rank 0 alone wrote one
    history.json and one checkpoint set, and the resumed run continues
    the epochs and the step count."""
    _, _, p, outs = world2
    (h0, h0b), (h1, h1b) = (o["fit"] for o in outs)
    strip = (lambda hist: [{k: v for k, v in r.items()
                            if k != "epoch_seconds"} for r in hist])
    assert strip(h0) == strip(h1) and strip(h0b) == strip(h1b)
    out = Path(p["fit_dir"])
    saved = json.loads((out / "history.json").read_text())
    assert [r["epoch"] for r in saved] == [1, 2]
    assert [r["lr_step"] for r in saved] == [2, 4]
    assert saved[-1]["resume_from"] == str(out / "ckpt" / "last")
    assert sorted(x.name for x in (out / "ckpt").iterdir()) == ["best",
                                                                 "last"]
    assert not list(out.glob("**/*.tmp"))


@pytest.fixture
def world1_group(tmp_path):
    """A one-rank gloo group in this process, taken down after the test."""
    assert pmesh.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                                  device="cpu") == 1
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_group_is_bit_equal_to_no_group(world1_group):
    """At world 1 the mesh's paths are bit for bit the unsharded ones:
    the loss and gradients, the step's metrics and parameters, the
    simulated step and the batched decompose."""
    mesh = world1_group
    p = _inputs_world1()
    group = mesh.get_group("data")
    a = flagship_loss_grads(_model(p["sd"]), p["batch"], group)
    b = flagship_loss_grads(_model(p["sd"]), p["batch"], None)
    assert a[0] == b[0]
    assert all(torch.equal(a[1][n], b[1][n]) for n in b[1])
    cfg = train_cfg_from_dict(_cfg(JCFG, warmup_steps=0))
    a = flagship_one_step(cfg, p["sd"], p["batch"], group)
    b = flagship_one_step(cfg, p["sd"], p["batch"], None)
    assert a[0] == b[0]
    assert all(torch.equal(a[1][n], b[1][n]) for n in b[1])
    a = flagship_sim_step(port_config(JCFG), mesh, 4)
    b = flagship_sim_step(port_config(JCFG), None, 4)
    assert a[0] == b[0]
    assert all(torch.equal(a[1][n], b[1][n]) for n in b[1])
    args = (port_config(JCFG), p["sd"], p["strain"], p["bands"])
    a = flagship_decompose(*args, mesh, DECOMPOSE_KW)
    b = flagship_decompose(*args, None, DECOMPOSE_KW)
    assert all(torch.equal(a[k], b[k]) for k in b)


def _inputs_world1():
    (_, tb), = batches(JCFG, 1, 4, seed=5)
    ev = simulate_batch(2, port_config(JCFG).sim, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    return {"sd": to_state_dict(jax_params(JCFG)), "batch": tb,
            "strain": ev.strain, "bands": ev.asd_bands}


def test_mesh_checks(world1_group):
    """make_mesh's checks (JAX's :104-111), shard_batch on a tree with a
    0-d leaf, an unequal shard raising, init_distributed with nothing
    configured, and run_ranks in a process that is a rank already."""
    mesh = world1_group
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="must use all 1 ranks"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        pmesh.make_mesh(model_parallel=2)
    tree = {"a": torch.arange(6).reshape(3, 2), "s": torch.tensor(2.0),
            "n": None}
    got = pmesh.shard_batch(mesh, tree)
    assert torch.equal(got["a"], tree["a"]) and got["s"] is tree["s"]
    assert pmesh.init_distributed() == 1
    assert pmesh.run_ranks(print, 2, "cpu") is False


def test_init_distributed_without_a_group(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed() == 1
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        pmesh.make_mesh()


def test_dryrun_multichip_on_cpu_ranks(tmp_path):
    """tools/dryrun_multichip.py at n = 2 gloo ranks: JAX's line with a
    finite NLL, equal to the one-rank run's; on "cuda" more ranks than
    cards raise, naming the count."""
    dryrun_multichip.dryrun_multichip(2, "cpu", out=tmp_path / "m2.json")
    m2 = json.loads((tmp_path / "m2.json").read_text())
    assert np.isfinite(m2["nll"])
    with pytest.raises(ValueError, match="9 ranks need 9 cards"):
        dryrun_multichip.dryrun_multichip(9, "cuda")
    cfg = dryrun_multichip.tiny_config()
    ref, _ = flagship_sim_step(cfg, None, 1)
    assert abs(m2["nll"] - ref["nll"]) <= 1e-5 * abs(ref["nll"])
