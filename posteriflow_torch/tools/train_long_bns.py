"""Train the long-BNS NPE with the port and write its calibration.

The port's twin of scripts/train_long_bns.py, with its flags and defaults:
batches are simulated on the device every step (models/long_bns.py; v1
multiband, v3 chirp-adapted or v4 trigger-conditioned tokens), the loss is
the model's mean NLL, and the optimizer is JAX's
(scripts/train_long_bns.py:175-180) built from train/trainer.py's pieces:
clip_by_global_norm(10), then AdamW with weight decay 1e-5 under
warmup_cosine_decay(0, lr, min(200, max(1, steps // 10)),
max(steps, warmup + 1), end 0.02·lr). Every --eval-every steps (and after
the first) it records train and validation NLL and the conditioning delta
(v4: signal ΔNLL; v1 and v3: θ-shuffle ΔNLL) in history.json and saves the
weights; at the end a coverage + SBC battery writes calibration.json with
JAX's keys. As in JAX's script, v1 and v3 train LongBNSNPE at its default
8 bins; --flow-bins sets v4's.

Outputs in --outdir: params.msgpack (the weights as flax writes them, so
JAX's scripts/validate_long_bns.py reads a port run) and state.pt (the
model's state_dict), history.json, calibration.json (written up front
with "pending": true) and, for v4, grid.npz: the trigger grid it trained
on, the stored grid of the config where there is one (models/grids/),
else the port's own build. --resume restores the weights from state.pt
and, as JAX's does, starts a fresh optimizer, so the schedule restarts at
count 0.

--mesh N trains through the sequence-parallel loss
(models/long_bns.make_sharded_nll[_v4]) on a ('data' 1, 'model' N) grid of
N ranks: under torchrun as it sets them, else spawned here, one card a
rank (N may not exceed the card count) or, with --device cpu, N gloo
processes. Every rank trains, evaluates and calibrates the same replicated
model; rank 0 writes. --prng takes only JAX's default (the port draws from
torch.Generators, seeded by step). --scan N runs the steps in epochs of N
and records at each epoch's end, as JAX's scanned path does.

    python -m posteriflow_torch.tools.train_long_bns --outdir model/lbns \\
        --steps 50000 --batch 64
    python -m posteriflow_torch.tools.train_long_bns --tokens v3 \\
        --outdir model/lbns_v3 --steps 4000
    python -m posteriflow_torch.tools.train_long_bns --device cpu \\
        --outdir /tmp/lbns --steps 2 --batch 2 --d-model 16 --n-layers 1 \\
        --cal-events 4 --cal-post 8 [--mesh 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """What trainer.Optimizer reads of a config, for JAX's long-BNS chain."""
    lr: float
    warmup_steps: int
    total_steps: int
    end_value: float
    grad_clip: float = 10.0
    grad_clip_mode: str = "global"
    weight_decay: float = 1e-5


def opt_config(lr: float, steps: int) -> OptConfig:
    """scripts/train_long_bns.py:175-180's schedule for `steps` steps."""
    warmup = min(200, max(1, steps // 10))
    return OptConfig(lr=lr, warmup_steps=warmup,
                     total_steps=max(steps, warmup + 1), end_value=0.02 * lr)


def make_optimizer(model, cfg: OptConfig):
    """trainer.Optimizer with the long-BNS schedule's 0.02·lr floor."""
    from posteriflow_torch.train.trainer import Optimizer, warmup_cosine

    class LongBNSOptimizer(Optimizer):
        def lr(self) -> float:
            return warmup_cosine(self.count, cfg.lr, cfg.warmup_steps,
                                 cfg.total_steps, cfg.end_value)

    return LongBNSOptimizer(model, cfg)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--outdir", default="model/long_bns_v1")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--duration", type=float, default=64.0)
    ap.add_argument("--tokens", default="v4", choices=["v1", "v3", "v4"])
    ap.add_argument("--sigma-mc-rel", type=float, default=5e-4)
    ap.add_argument("--sigma-t", type=float, default=5e-3)
    ap.add_argument("--flow-bins", type=int, default=12)
    ap.add_argument("--n-bands", type=int, default=64)
    ap.add_argument("--per-band", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--f-hi", type=float, default=512.0)
    ap.add_argument("--patch", type=int, default=4)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--cal-events", type=int, default=256)
    ap.add_argument("--cal-post", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--prng", default="threefry2x32",
                    choices=["rbg", "threefry2x32"])
    ap.add_argument("--scan", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    return ap


def setup(args, device):
    """The run's grid, model, optimizer and batch function ->
    SimpleNamespace(model, opt, grid, batch_fn, enc_cfg, tok_cfg, v4, args,
    device, mesh, loss_fn).
    batch_fn(generator, amp_scale=1.0) simulates one batch; for v4 its
    amp_scale 0 gives the noise-only tokens of the same draws. With
    --mesh, loss_fn is the sequence-parallel loss over the process group's
    ('data' 1, 'model' N) mesh, else None (the model's own loss)."""
    import torch

    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.physics.constants import N_DETECTORS
    from posteriflow_torch.train.trainer import init_params

    v4 = args.tokens == "v4"
    grid = None
    if v4:
        tok_cfg = lb.trigger_grid_config(
            duration=args.duration, f_hi=args.f_hi, alpha=args.alpha,
            sigma_mc_rel=args.sigma_mc_rel, sigma_t=args.sigma_t)
        try:
            grid = lb.load_stored_grid(tok_cfg)
        except FileNotFoundError:
            grid = lb.build_trigger_token_grid(
                **{k: v for k, v in tok_cfg.items() if k != "kind"})
        enc_cfg = dict(d_model=args.d_model, n_layers=args.n_layers,
                       n_heads=args.n_heads, patch=args.patch)
        model = lb.LongBNSNPEv4(enc=enc_cfg, flow_bins=args.flow_bins,
                                sigma_mc_rel=args.sigma_mc_rel,
                                sigma_t=args.sigma_t)
        seq_len = grid["L"]

        def batch_fn(gen, amp_scale=1.0, draws=None):
            if draws is None:
                draws = lb.draw_long_bns(args.batch, grid["cut"],
                                         grid["trunc"], gen, device)
            return lb.simulate_long_bns_v4_from_draws(draws, grid, amp_scale)
    elif args.tokens == "v3":
        grid = lb.build_chirp_token_grid(duration=args.duration,
                                         f_hi=args.f_hi, alpha=args.alpha)
        tok_cfg = grid["config"]
        enc_cfg = dict(d_model=args.d_model, n_layers=args.n_layers,
                       n_heads=args.n_heads, patch=args.patch)
        model = lb.LongBNSNPE(enc=enc_cfg, n_feat=3 * N_DETECTORS + 2)
        seq_len = grid["L"]

        def batch_fn(gen, amp_scale=1.0, draws=None):
            return lb.simulate_long_bns_batch_v3(args.batch, grid, gen,
                                                 device)
    else:
        tok_cfg = {"kind": "v1", "n_bands": args.n_bands,
                   "per_band": args.per_band}
        enc_cfg = dict(d_model=args.d_model, n_layers=args.n_layers)
        model = lb.LongBNSNPE(enc=enc_cfg)
        seq_len = args.n_bands * args.per_band

        def batch_fn(gen, amp_scale=1.0, draws=None):
            return lb.simulate_long_bns_batch(
                args.batch, duration=args.duration, n_bands=args.n_bands,
                per_band=args.per_band, generator=gen, device=device)
    init_params(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    opt = make_optimizer(model, opt_config(args.lr, args.steps))
    mesh = loss_fn = None
    if args.mesh:
        from posteriflow_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh, model_parallel=args.mesh)
        make = lb.make_sharded_nll_v4 if v4 else lb.make_sharded_nll
        loss_fn = make(mesh, seq_len, model)
    return SimpleNamespace(model=model, opt=opt, grid=grid,
                           batch_fn=batch_fn, enc_cfg=enc_cfg,
                           tok_cfg=tok_cfg, v4=v4, args=args, device=device,
                           mesh=mesh, loss_fn=loss_fn)


def train_step(run, gen) -> float:
    """One step: simulate, forward, backward (trainer.backward, TF32 off),
    with a mesh the gradients summed over every rank, then clip + AdamW.
    Returns the loss."""
    from posteriflow_torch.parallel.mesh import all_reduce_grads
    from posteriflow_torch.train.trainer import backward
    batch = run.batch_fn(gen)
    loss = (run.model(*batch) if run.loss_fn is None
            else run.loss_fn(run.model, *batch))
    run.opt.zero_grad()
    backward(loss)
    if run.mesh is not None:
        all_reduce_grads(run.opt.params, None)
    run.opt.step()
    return float(loss.detach())


def val_metrics(run, gen):
    """(val NLL, conditioning delta) on one fresh batch: v4 the NLL gap of
    the noise-only tokens of the same draws, v1 of θ rolled by one."""
    import torch

    from posteriflow_torch.models import long_bns as lb
    with torch.no_grad():
        if run.v4:
            draws = lb.draw_long_bns(run.args.batch, run.grid["cut"],
                                     run.grid["trunc"], gen, run.device)
            tv, thv, trv = run.batch_fn(None, 1.0, draws)
            vloss = float(run.model(tv, thv, trv))
            tv0, _, _ = run.batch_fn(None, 0.0, draws)
            return vloss, float(run.model(tv0, thv, trv)) - vloss
        tv, thv = run.batch_fn(gen)
        vloss = float(run.model(tv, thv))
        return vloss, float(run.model(tv, torch.roll(thv, 1, dims=0))) - vloss


def _generator(device, seed: int):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def _save_state(run, outdir: Path):
    """state.pt (atomically) and params.msgpack, as flax writes it."""
    import torch

    from posteriflow_torch.train.checkpoints import write_params
    path = outdir / "state.pt"
    tmp = path.with_suffix(".tmp")
    torch.save({"model": run.model.state_dict()}, tmp)
    tmp.replace(path)
    write_params(run.model, outdir / "params.msgpack")


def keep_finished_calibration(cal_path: Path):
    """Move a finished run's calibration.json (one that is not a "pending"
    record) to calibration.prev.json, so that a new run started in its
    directory, and killed before its end-of-run battery, does not destroy
    it."""
    if not cal_path.exists():
        return
    try:
        finished = not json.loads(cal_path.read_text()).get("pending", False)
    except (ValueError, AttributeError):
        finished = True
    if finished:
        cal_path.replace(cal_path.with_name("calibration.prev.json"))


def _mesh_rank(rank: int, argv):
    run_training(argv)


def run_training(argv=None):
    """main's body -> (history, calibration record, the run namespace)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.prng != "threefry2x32":
        ap.error("--prng: the port has no PRNG choice: torch has one "
                 "generator a device, so the flag has nothing to select "
                 "(ROADMAP §3 findings, from §1 item 3)")
    if args.cpu:
        args.device = "cpu"

    import torch

    if args.mesh:
        from posteriflow_torch.parallel.mesh import init_distributed, run_ranks
        if run_ranks(_mesh_rank, args.mesh, args.device, (argv,)):
            outdir = Path(args.outdir)
            return (json.loads((outdir / "history.json").read_text()),
                    json.loads((outdir / "calibration.json").read_text()),
                    None)
        init_distributed(device=args.device)
        if torch.device(args.device).type == "cuda":
            args.device = f"cuda:{torch.cuda.current_device()}"
    from scipy.stats import kstest

    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.train.trainer import step_seed
    from posteriflow_torch.utils.logging import setup_logging

    log = setup_logging()
    device = torch.device(args.device)
    outdir = Path(args.outdir)
    run = setup(args, device)
    writer = run.mesh is None or run.mesh.get_rank() == 0
    if writer:
        outdir.mkdir(parents=True, exist_ok=True)
    if run.v4 and writer:
        lb.save_grid(run.grid, outdir / "grid.npz")
    n_par = sum(p.numel() for p in run.model.parameters())
    log.info("LongBNSNPE%s: %s params, tokens L=%s", "v4" if run.v4 else "",
             f"{n_par:,}", run.grid["L"] if run.grid is not None else
             args.n_bands * args.per_band)

    config = {"duration": args.duration, "steps": args.steps,
              "batch": args.batch, "enc": run.enc_cfg,
              "tokens": run.tok_cfg,
              "flow": {"bins": args.flow_bins} if run.v4 else {},
              "n_params": n_par, "mesh": args.mesh,
              "n_bands": args.n_bands, "per_band": args.per_band,
              **{k: run.enc_cfg[k] for k in ("d_model", "n_layers")}}
    cal_path = outdir / "calibration.json"
    if writer and not (args.resume and cal_path.exists()):
        keep_finished_calibration(cal_path)
        cal_path.write_text(json.dumps({"pending": True, "config": config},
                                       indent=2))

    ckpt = outdir / "state.pt"
    history = []
    if args.resume and ckpt.exists():
        saved = torch.load(ckpt, map_location=device, weights_only=True)
        run.model.load_state_dict(saved["model"])
        history = json.loads((outdir / "history.json").read_text())
        log.info("resumed from %s (%d records)", ckpt, len(history))

    delta_key = "signal_delta" if run.v4 else "shuffle_delta"

    def eval_and_record(step_no, train_nll, t0):
        vloss, delta = val_metrics(
            run, _generator(device, (args.seed + 7) * 1_000_003 + step_no))
        rec = {"step": step_no, "train_nll": float(train_nll),
               "val_nll": vloss, delta_key: round(delta, 4),
               "seconds": round(time.time() - t0, 1)}
        history.append(rec)
        log.info("step %5d | train %.3f | val %.3f | %s %.3f | %.0fs",
                 step_no, rec["train_nll"], vloss, delta_key, delta,
                 rec["seconds"])
        if writer:
            _save_state(run, outdir)
            (outdir / "history.json").write_text(json.dumps(history,
                                                            indent=2))

    t0 = time.time()
    done = history[-1]["step"] if history else 0
    if args.scan:
        for e in range(done // args.scan, args.steps // args.scan):
            losses = [train_step(run, _generator(
                device, step_seed(args.seed, e, i))) for i in
                range(args.scan)]
            eval_and_record((e + 1) * args.scan, losses[-1], t0)
    else:
        for i in range(done, args.steps):
            loss = train_step(run, _generator(device,
                                              step_seed(args.seed, 0, i)))
            if (i + 1) % args.eval_every == 0 or i == 0:
                eval_and_record(i + 1, loss, t0)

    log.info("calibration battery: %d events x %d draws", args.cal_events,
             args.cal_post)
    in50s, in90s, ranks = [], [], []
    n_chunks = max(1, args.cal_events // args.batch)
    q = torch.tensor([0.25, 0.75, 0.05, 0.95], device=device)
    with torch.no_grad():
        for i in range(n_chunks):
            gen = _generator(device, (args.seed + 1234) * 1_000_003 + i)
            batch = run.batch_fn(gen)
            theta = batch[1]
            if run.v4:
                draws = run.model.sample(batch[0], batch[2], args.cal_post,
                                         gen)
            else:
                draws = run.model.sample(batch[0], args.cal_post, gen)
            lo50, hi50, lo90, hi90 = torch.quantile(draws, q, dim=1)
            in50s.append(((theta >= lo50) & (theta <= hi50)).float()
                         .cpu().numpy())
            in90s.append(((theta >= lo90) & (theta <= hi90)).float()
                         .cpu().numpy())
            ranks.append(torch.sum((draws < theta[:, None, :]).int(), dim=1)
                         .cpu().numpy())
    cov50 = np.concatenate(in50s).mean(0)
    cov90 = np.concatenate(in90s).mean(0)
    rk = np.concatenate(ranks)
    sbc_p = [float(kstest((rk[:, j] + 0.5) / (args.cal_post + 1),
                          "uniform").pvalue) for j in range(11)]
    cal = {
        "n_events": int(n_chunks * args.batch),
        "n_post": args.cal_post,
        "cov50": dict(zip(PARAM_NAMES, np.round(cov50, 3).tolist())),
        "cov90": dict(zip(PARAM_NAMES, np.round(cov90, 3).tolist())),
        "cov50_violations": int(np.sum(np.abs(cov50 - 0.5) > 0.07)),
        "cov90_violations": int(np.sum(np.abs(cov90 - 0.9) > 0.05)),
        "sbc_ks_p": dict(zip(PARAM_NAMES, sbc_p)),
        "sbc_pass_frac": float(np.mean(np.asarray(sbc_p) > 1e-3)),
        "final_val_nll": history[-1]["val_nll"] if history else None,
        "config": config,
    }
    if writer:
        cal_path.write_text(json.dumps(cal, indent=2))
    log.info("cov50 violations: %d; cov90 violations: %d; SBC pass %.2f",
             cal["cov50_violations"], cal["cov90_violations"],
             cal["sbc_pass_frac"])
    if writer:
        print(json.dumps({k: cal[k] for k in ("cov50_violations",
                                              "cov90_violations",
                                              "sbc_pass_frac",
                                              "final_val_nll")}))
    return history, cal, run


def main(argv=None):
    return run_training(argv)[:2]


if __name__ == "__main__":
    main()
