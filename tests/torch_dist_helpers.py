"""Rank functions of the distributed tests (tests/test_torch_dist_*.py).

`run_ranks(tmp, world, fn, payload)` spawns `world` gloo processes on the
CPU (posteriflow_torch.parallel.mesh.run_ranks, the rendezvous file under
`tmp`, so that tests running side by side share no port or file), each
with one torch thread; rank r calls fn(rank, payload) and its return is
saved to tmp/out<r>.pt, which run_ranks reads back. This module imports
only torch and the port: a spawned process imports it by name.
"""

from __future__ import annotations

from pathlib import Path

import torch

from posteriflow_torch.parallel import mesh as pmesh
from posteriflow_torch.parallel.mesh import (all_reduce_grads,
                                             all_reduce_sum, make_mesh,
                                             shard_batch)


def run_ranks(tmp, world: int, fn, payload) -> list:
    """[fn(rank, payload) for each rank], each run in its own process."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "payload.pt")
    assert pmesh.run_ranks(_rank, world, "cpu", (fn.__name__, str(tmp)),
                           tmpdir=tmp), "this process is a rank already"
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _rank(rank: int, name: str, tmp: str):
    torch.set_num_threads(1)
    payload = torch.load(Path(tmp) / "payload.pt", weights_only=False)
    out = globals()[name](rank, payload)
    torch.save(out, Path(tmp) / f"out{rank}.pt")


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# ── the flagship's data-parallel paths ──────────────────────────────────


def flagship_loss_grads(model, batch, group):
    """The global loss and the summed gradients of this rank's rows (no
    group: the whole batch on one process)."""
    from posteriflow_torch.train.trainer import backward, batch_nll
    model.zero_grad()
    loss = batch_nll(model, batch, group)
    backward(loss)
    if group is not None:
        all_reduce_grads(list(model.parameters()), group)
        loss = all_reduce_sum(loss.detach(), group)
    return float(loss.detach()), _grads(model)


def flagship_one_step(cfg, state_dict, batch, group):
    """One train_step from the given weights -> (metrics, parameters)."""
    from posteriflow_torch.models.npe import LeanNPE
    from posteriflow_torch.train.trainer import (TrainState,
                                                 make_optimizer, train_step)
    model = LeanNPE(cfg.npe)
    model.load_state_dict(state_dict)
    state = TrainState(model, make_optimizer(cfg, model), cfg)
    m = train_step(state, batch, group)
    return {k: float(v) for k, v in m.items()}, _params(model)


def flagship_sim_step(cfg, mesh, seed: int):
    """make_train_step(cfg, mesh=mesh) once from a fresh state of seed 0,
    the batch drawn from a generator seeded `seed` -> (metrics,
    parameters)."""
    from posteriflow_torch.train.trainer import init_state, make_train_step
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    m = make_train_step(cfg, mesh=mesh)(
        state, torch.Generator().manual_seed(seed))
    return {k: float(v) for k, v in m.items()}, _params(state.model)


def flagship_decompose(cfg, state_dict, strain, bands, mesh, kw):
    """make_batched_decompose(cfg, mesh=mesh, **kw) on the events, base
    draws from a generator seeded 5."""
    from posteriflow_torch.core.pod import make_batched_decompose
    from posteriflow_torch.models.npe import LeanNPE
    model = LeanNPE(cfg.npe)
    model.load_state_dict(state_dict)
    out = make_batched_decompose(cfg, mesh=mesh, **kw)(
        model, strain, bands, generator=torch.Generator().manual_seed(5))
    return {k: v.clone() for k, v in out.items()}


def flagship_suite(rank: int, p: dict) -> dict:
    """The flagship's sharded paths on a ('data' world, 'model' 1) mesh:
    loss and gradients of the given batch, one train_step on it, one
    simulated make_train_step (the JAX multihost test's config), the
    batched decompose, and fit for an epoch, then resumed for one more."""
    from posteriflow_torch.physics.simulator import EventBatch
    from posteriflow_torch.models.npe import LeanNPE
    from posteriflow_torch.train.checkpoints import train_cfg_from_dict
    from posteriflow_torch.train.loop import fit

    mesh = make_mesh()
    group = mesh.get_group("data")
    cfg = train_cfg_from_dict(p["cfg"])
    step_cfg = train_cfg_from_dict(p["step_cfg"])
    batch = shard_batch(mesh, EventBatch(**p["batch"]))
    model = LeanNPE(cfg.npe)
    model.load_state_dict(p["state_dict"])
    out = {"loss_grads": flagship_loss_grads(model, batch, group),
           "one_step": flagship_one_step(step_cfg, p["state_dict"], batch,
                                         group),
           "sim_step": flagship_sim_step(
               train_cfg_from_dict(p["sim_cfg"]), mesh, p["sim_seed"]),
           "decompose": flagship_decompose(cfg, p["state_dict"],
                                           p["strain"], p["bands"], mesh,
                                           p["decompose_kw"])}
    fit_cfg = train_cfg_from_dict(p["fit_cfg"])
    _, hist = fit(fit_cfg, p["fit_dir"], epochs=1, steps_per_epoch=2,
                  n_val_events=8, seed=3, device="cpu", mesh=mesh)
    _, hist2 = fit(fit_cfg, p["fit_dir"], epochs=1, steps_per_epoch=2,
                   n_val_events=8, seed=3, device="cpu", mesh=mesh,
                   resume_from=str(Path(p["fit_dir"]) / "ckpt" / "last"))
    out["fit"] = (hist, hist2)
    return out


# ── long-BNS sequence parallelism ───────────────────────────────────────


def long_bns_model(p):
    """The case's model with its weights; p["f32"] switches the flow's
    conditioners to float32 matmuls."""
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.models.flow import Conditioner
    cls = lb.LongBNSNPEv4 if p["v4"] else lb.LongBNSNPE
    model = cls(**p["kwargs"])
    model.load_state_dict(p["state_dict"])
    if p.get("f32"):
        for mod in model.modules():
            if isinstance(mod, Conditioner):
                mod.compute_dtype = torch.float32
    return model


def long_bns_suite(rank: int, p: dict) -> dict:
    """For each model_parallel m of p["meshes"] (a mesh of shape
    (world / m, m)) and each case of p["cases"]: the sharded encoder's
    context (make_sharded_encoder) and the sharded loss (make_sharded_nll
    / _v4) with its gradients summed over every rank (a case's "meshes"
    restricts it to those; "loss": False skips its loss); then
    p["train"], an argv of tools/train_long_bns.py, run as this rank."""
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.train.trainer import backward
    out = {}
    for m in p["meshes"]:
        mesh = make_mesh(model_parallel=m)
        for name, case in p["cases"].items():
            if m not in case.get("meshes", (m,)):
                continue
            model = long_bns_model(case)
            tokens = torch.from_numpy(case["tokens"])
            rest = [torch.from_numpy(a) for a in case["rest"]]
            _, apply_fn, _ = lb.make_sharded_encoder(
                mesh, tokens.shape[1], tokens.shape[2],
                case["kwargs"]["enc"])
            with torch.no_grad():
                ctx = apply_fn(model.encoder, tokens)
            res = {"ctx": ctx}
            if case.get("loss", True):
                make = (lb.make_sharded_nll_v4 if case["v4"]
                        else lb.make_sharded_nll)
                loss = make(mesh, tokens.shape[1], model)(model, tokens,
                                                          *rest)
                backward(loss)
                all_reduce_grads(list(model.parameters()), None)
                res.update(loss=float(loss.detach()), grads=_grads(model))
            out[(m, name)] = res
    if p.get("train"):
        from posteriflow_torch.tools import train_long_bns
        hist, cal, _ = train_long_bns.run_training(p["train"])
        out["train"] = (hist, cal)
    return out
