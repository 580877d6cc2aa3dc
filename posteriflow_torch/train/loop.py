"""The training loop (torch): epochs of simulate + train steps, per-epoch
diagnostics, calibration-gated checkpoint selection, history.json.

Port of posteriflow_tpu/train/loop.py:39-232:

  - a fixed validation batch (the same seed every epoch) so that metrics
    compare across epochs; with a noise bank, real-noise mixing in
    training and a second fixed batch all of real noise, whose NLL and
    diagnostics are logged as real_*, and the best checkpoint selected on
    the mean of the two validation NLLs;
  - per-epoch diagnostics (shuffle-ΔNLL, dist_corr, coverage) and the
    calibration gate (railing, base_conc, cov90[_highsnr], SBC), with base
    draws from one fixed seed;
  - checkpoints last, epoch_XXXX every `ckpt_every` epochs and the gated
    best, each state.pt + meta.json;
  - history.json rewritten every epoch with the JAX package's record keys;
  - with a mesh (`mesh=`, parallel/mesh.py) the steps are data-parallel
    (trainer.make_train_epoch), every rank validates on the same batch,
    so every rank selects the same best epoch, and rank 0 alone writes
    history.json and the checkpoints and calls the hook.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from posteriflow_torch.data.noise_bank import NoiseBank
from posteriflow_torch.parallel.mesh import barrier
from posteriflow_torch.physics.simulator import simulate_batch
from posteriflow_torch.train.checkpoints import CheckpointManager, load_release
from posteriflow_torch.train.diagnostics import make_diagnostics
from posteriflow_torch.train.gates import (CalibrationGate, evaluate_gate,
                                           make_calibration_metrics,
                                           select_best)
from posteriflow_torch.train.trainer import (TrainConfig, init_state,
                                             make_eval_nll, make_train_epoch,
                                             step_seed)

log = logging.getLogger("posteriflow.train")

# the seeds fixed across epochs are steps of epoch 0, which never trains
_INIT, _VAL, _DIAG, _VAL_REAL = 0, 1, 2, 3


def _merge_params(fresh: Dict[str, torch.Tensor],
                  loaded: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Shape-tolerant weight transfer: every loaded entry whose state_dict
    key AND shape match the fresh init, the fresh init elsewhere (e.g. the
    15-D flagship's encoder from an 11-D release, its flow from scratch).
    -> (merged, n_transferred, n_total)."""
    merged, kept = {}, 0
    for key, leaf in fresh.items():
        cand = loaded.get(key)
        if cand is not None and tuple(cand.shape) == tuple(leaf.shape):
            merged[key] = cand.to(dtype=leaf.dtype)
            kept += 1
        else:
            merged[key] = leaf
    return merged, kept, len(fresh)


def _generator(device: torch.device, seed: int, which: int):
    return torch.Generator(device=device).manual_seed(
        step_seed(seed, 0, which))


def fit(cfg: TrainConfig, outdir, epochs: int = 60,
        steps_per_epoch: int = 200, seed: int = 0,
        gate: CalibrationGate = CalibrationGate(), ckpt_every: int = 0,
        n_val_events: int = 256, init_from: Optional[str] = None,
        resume_from: Optional[str] = None, device="cuda",
        bank: Optional[NoiseBank] = None,
        val_batch_fn: Optional[Callable] = None,
        on_epoch_end: Optional[Callable[[dict], None]] = None, mesh=None):
    """Train LeanNPE on `device`; returns (state, history).

    val_batch_fn(generator) -> EventBatch replaces the default Gaussian
    validation batch; it is given the generator on `device` that the
    default batch is drawn from (JAX's k_val). on_epoch_end(rec) is called
    with each epoch's history record after history.json is written.

    bank: a NoiseBank on `device`; training events take its real noise
    with cfg.sim.real_noise_prob, a fixed batch of n_val_events all of real
    noise is validated every epoch (real_val_nll and real_<diagnostic>),
    and select_nll, which picks the best checkpoint, is the mean of
    val_nll and real_val_nll.

    init_from: a release directory (params.msgpack: weights merged by key
    and shape into a fresh init) or a training checkpoint directory
    (weights, fresh optimizer). resume_from: a training checkpoint
    directory whose whole state (weights, optimizer, step) continues, with
    the epochs and history of its run.

    mesh: a DeviceMesh over every rank (parallel/mesh.py); each step
    trains its rows along "data" of the global batch of cfg.batch_size
    events. Every rank calls fit with the same arguments; rank 0 alone
    writes, and fit returns on every rank after its last write."""
    dev = torch.device(device)
    outdir = Path(outdir)
    writer = mesh is None or dist.get_rank() == 0
    if writer:
        outdir.mkdir(parents=True, exist_ok=True)
        ckpts = CheckpointManager(outdir / "ckpt")

    state = init_state(cfg, generator=torch.Generator().manual_seed(
        step_seed(seed, 0, _INIT)), device=dev)
    epoch_offset = 0
    prior_history: list = []
    if resume_from:
        state, ck_cfg, meta = CheckpointManager(
            Path(resume_from).parent).restore(Path(resume_from).name,
                                              device=dev)
        if ck_cfg != cfg:
            log.warning("resume config differs from checkpoint config; "
                        "optimizer state assumed layout-compatible")
        # keep the resumed run's history up to its epoch, so that the gated
        # best selection still sees the pre-resume best
        epoch_offset = int(meta.get("epoch") or 0)
        prev_hist = Path(resume_from).parent.parent / "history.json"
        if prev_hist.exists():
            prior_history = [r for r in json.loads(prev_hist.read_text())
                             if r.get("epoch", 0) <= epoch_offset]
        elif meta:
            prior_history = [dict(meta)]
        log.info("resuming from %s (epoch %s, step %s, %d prior history "
                 "records)", resume_from, epoch_offset, state.step,
                 len(prior_history))
    elif init_from:
        if (Path(init_from) / "params.msgpack").exists():
            loaded, _r_cfg, meta = load_release(init_from)
            merged, n_kept, n_total = _merge_params(
                state.model.state_dict(), loaded)
            state.model.load_state_dict(merged, strict=True)
        else:
            state, meta = CheckpointManager(Path(init_from).parent) \
                .fine_tune_restore(Path(init_from).name, cfg, device=dev)
            n_kept = n_total = len(state.model.state_dict())
        log.info("fine-tuning from %s (epoch %s, %d/%d leaves transferred)",
                 init_from, meta.get("epoch"), n_kept, n_total)
    n_params = sum(p.numel() for p in state.model.parameters())
    log.info("LeanNPE parameters: %s", f"{n_params:,}")

    epoch_fn = make_train_epoch(cfg, steps_per_epoch, bank, mesh)
    eval_nll = make_eval_nll(cfg)
    diagnostics = make_diagnostics(cfg, n_events=n_val_events)
    cal_metrics_fn = make_calibration_metrics(cfg)

    if val_batch_fn is None:
        val_batch = simulate_batch(n_val_events, cfg.sim, device=dev,
                                   generator=_generator(dev, seed, _VAL))
    else:
        val_batch = val_batch_fn(_generator(dev, seed, _VAL))
    val_real = None
    if bank is not None:
        val_real = simulate_batch(
            n_val_events, dataclasses.replace(cfg.sim, real_noise_prob=1.0),
            device=dev, generator=_generator(dev, seed, _VAL_REAL),
            bank=bank)

    history = list(prior_history)
    best_epoch = -1
    for epoch in range(epoch_offset + 1, epoch_offset + epochs + 1):
        t0 = time.time()
        m = epoch_fn(state, seed, epoch)
        val = eval_nll(state.model, val_batch)
        diag = diagnostics(state.model, val_batch,
                           generator=_generator(dev, seed, _DIAG))
        cal = evaluate_gate(cfg, state.model, val_batch,
                            generator=_generator(dev, seed, _DIAG),
                            gate=gate, metrics_fn=cal_metrics_fn)
        real_metrics, select = {}, val
        if val_real is not None:
            real_nll = eval_nll(state.model, val_real)
            dr = diagnostics(state.model, val_real,
                             generator=_generator(dev, seed, _DIAG))
            real_metrics = {"real_val_nll": real_nll,
                            **{f"real_{k}": v for k, v in dr.items()
                               if not isinstance(v, np.ndarray)}}
            select = 0.5 * (val + real_nll)
        rec = {
            **({"init_from": str(init_from)} if init_from else {}),
            **({"resume_from": str(resume_from)} if resume_from else {}),
            "epoch": epoch, "train_nll": m["nll"], "select_nll": select,
            "val_nll": val, **real_metrics, "grad_norm": m["grad_norm"],
            **{k: v for k, v in m.items() if k.startswith("gn_")},
            "lr_step": state.step,
            "epoch_seconds": round(time.time() - t0, 1),
            **{k: v for k, v in diag.items() if not isinstance(v, np.ndarray)},
            "spurious_railing": cal["spurious_railing"],
            "base_conc": cal["base_conc"],
            "cov90_mean": cal["cov90_mean"],
            "cov90_highsnr_mean": cal["cov90_highsnr_mean"],
            "sbc_pass_frac": cal["sbc_pass_frac"],
            "gate_passed": cal["gate_passed"],
            "cov50_all": np.asarray(diag["cov50_all"]).round(3).tolist(),
            "cov90_all": np.asarray(diag["cov90_all"]).round(3).tolist(),
        }
        history.append(rec)
        log.info(
            "epoch %3d | train %.3f | val %.3f | shufΔ %+.3f | dcorr %+.3f"
            " | dcov50/90 %.2f/%.2f | rail %.3f | conc %.2f | gate %s | %ds",
            epoch, rec["train_nll"], val, rec["shuffle_delta_nll"],
            rec["dist_corr"], rec["dist_cov50"], rec["dist_cov90"],
            rec["spurious_railing"], rec["base_conc"],
            "PASS" if rec["gate_passed"] else "fail",
            int(rec["epoch_seconds"]))

        if select_best(history) == epoch:
            best_epoch = epoch
        if not writer:
            continue
        ckpts.save("last", state, cfg, rec, epoch)
        if ckpt_every and epoch % ckpt_every == 0:
            ckpts.save(f"epoch_{epoch:04d}", state, cfg, rec, epoch)
        if best_epoch == epoch:
            ckpts.save("best", state, cfg, rec, epoch)

        (outdir / "history.json").write_text(json.dumps(history, indent=2))
        if on_epoch_end:
            on_epoch_end(rec)

    barrier(mesh)
    log.info("done. best epoch %d -> %s", best_epoch,
             outdir / "ckpt" / "best")
    return state, history
