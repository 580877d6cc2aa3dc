"""PriorityNet trainer (torch): overlap scenarios from the on-device
simulator, candidate features, the ranking loss and Adam.

Port of posteriflow_tpu/train/train_priority.py. Every scenario batch is
one `simulate_batch` with overlap_fraction 1; a candidate is a true signal
with its parameters jittered by 5% (what an upstream posterior median
looks like) and the whitened strain segment around its jittered merger;
targets are the per-signal network SNRs over the event's loudest.

`make_priority_batch` splits its random draws from their use: the
simulation's inputs (prior parameters, signal counts and event draws) and
the jitter normals may be handed in, so a test can give it JAX's.
`fit_priority` writes `priority_params.msgpack` (flax's bytes, through
train/checkpoints.write_params) with `net.json` and `history.json` in the
JAX package's schema; `load_priority_net` reads that directory, a released
`priority_params.msgpack` (through utils/msgpack_lite.py) with its
`net.json` sidecar, or an earlier port run's `state.pt`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from posteriflow_torch.models.priority_net import (SEG_LEN, PriorityNet,
                                                   ranking_loss)
from posteriflow_torch.physics.constants import DURATION, SAMPLE_RATE
from posteriflow_torch.physics.simulator import (SimConfig, SimDraws,
                                                 design_asd, simulate_batch,
                                                 signal_snr_amp_only)
from posteriflow_torch.prior import PriorConfig
from posteriflow_torch.train.checkpoints import (flax_to_state_dict,
                                                 write_params)
from posteriflow_torch.train.trainer import (adam_update_, backward,
                                             init_params, warmup_cosine)
from posteriflow_torch.utils.msgpack_lite import unpackb

log = logging.getLogger("posteriflow.priority")


@dataclasses.dataclass(frozen=True)
class PriorityTrainConfig:
    batch_size: int = 32
    lr: float = 1e-3
    param_jitter: float = 0.05      # relative jitter on candidate params
    min_snr: float = 6.0
    max_signals: int = 4
    d_model: int = 64
    use_energy: bool = True         # excess-power features + aux SNR head
    use_snr_est: bool = True        # physics expected-SNR input feature
    close_boost: float = 0.0        # near-tie pair gradient boost
    use_dt: bool = False            # time-crowding features
    residual_snr: bool = False      # oracle-residual score head
    mine_pool: int = 1              # simulate mine_pool × batch events and
                                    # keep the batch with the tightest
                                    # target pairs (1 = off)

    @property
    def sim(self) -> SimConfig:
        return SimConfig(prior=PriorConfig(max_signals=self.max_signals,
                                           overlap_fraction=1.0,
                                           noise_fraction=0.0),
                         min_snr=self.min_snr)


def extract_segments_batched(strain: torch.Tensor,
                             t_offs: torch.Tensor) -> torch.Tensor:
    """[B, n_det, T] strain + [B, S] merger offsets -> [B, S, n_det,
    SEG_LEN] segments centred on each merger (the float32 centre truncated
    to an integer, the window clipped into the strain)."""
    t = strain.shape[-1]
    centers = ((t_offs + DURATION / 2) * SAMPLE_RATE).to(torch.int32)
    lo = torch.clamp(centers.long() - SEG_LEN // 2, 0, t - SEG_LEN)
    idx = lo[..., None] + torch.arange(SEG_LEN, device=strain.device)
    b, s = t_offs.shape
    src = strain[:, None].expand(b, s, strain.shape[1], t)
    return torch.gather(src, -1, idx[:, :, None, :].expand(
        b, s, strain.shape[1], SEG_LEN))


def hardest_events(n_sig: torch.Tensor, sig_snr: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Indices of the k events whose closest pair of live normalized
    targets is tightest (events with fewer than two live signals last; a
    stable sort, as jnp.argsort)."""
    s = sig_snr.shape[1]
    live = (torch.arange(s, device=n_sig.device)[None, :]
            < n_sig[:, None]).to(torch.float32)
    tg = sig_snr / torch.clamp_min(torch.amax(sig_snr, dim=1, keepdim=True),
                                   1e-6)
    eye = torch.eye(s, device=sig_snr.device)
    pair_live = (live[:, :, None] * live[:, None, :]) * (1.0 - eye[None])
    sep = torch.abs(tg[:, :, None] - tg[:, None, :])
    hardness = torch.amin(torch.where(pair_live > 0, sep,
                                      torch.full_like(sep, float("inf"))),
                          dim=(1, 2))
    return torch.argsort(hardness, stable=True)[:k]


def make_priority_batch(cfg: PriorityTrainConfig,
                        generator: Optional[torch.Generator] = None,
                        device="cuda", sim=None,
                        jitter: Optional[torch.Tensor] = None):
    """-> (segments [B, S, 3, L], candidate params [B, S, 11], mask [B, S],
    targets [B, S], raw network SNR [B, S], physics expected SNR of the
    candidate params [B, S]), B = cfg.batch_size.

    sim: (params [G, S, 11], n_sig [G], SimDraws of G events) for the
    G = batch_size · mine_pool simulated events, else drawn from
    `generator`; jitter: the N(0, 1) normals [B, S, 11] of the candidate
    jitter, else drawn from `generator` after the simulation."""
    device = torch.device(device)
    n_gen = cfg.batch_size * max(cfg.mine_pool, 1)
    if sim is None:
        ev = simulate_batch(n_gen, cfg.sim, device=device,
                            generator=generator)
    else:
        params, n_sig, draws = sim
        ev = simulate_batch(n_gen, cfg.sim, device=device,
                            params=params.to(device), n_sig=n_sig.to(device),
                            draws=SimDraws(*[d.to(device) for d in draws]))
    if cfg.mine_pool > 1:
        idx = hardest_events(ev.n_sig, ev.sig_snr, cfg.batch_size)
        ev = type(ev)(*[x[idx] for x in ev])
    s = ev.params.shape[1]
    mask = (torch.arange(s, device=device)[None, :]
            < ev.n_sig[:, None]).to(torch.float32)

    if jitter is None:
        jitter = torch.randn(ev.params.shape, generator=generator,
                             device=device)
    cand = ev.params * (1.0 + cfg.param_jitter * jitter.to(device))
    segs = extract_segments_batched(ev.strain, cand[..., 8])

    # the physics expected SNR of each candidate; dead slots hold zeros,
    # so masses, distance and spins are clamped into the waveform's range
    safe = torch.cat([torch.clamp_min(cand[..., :3], 1.0), cand[..., 3:9],
                      torch.clamp(cand[..., 9:], -0.99, 0.99)], dim=-1)
    snr_est = torch.nan_to_num(signal_snr_amp_only(
        safe.reshape(-1, safe.shape[-1]), design_asd(device))).reshape(
        cand.shape[:2])

    tmax = torch.amax(ev.sig_snr, dim=1, keepdim=True)
    targets = ev.sig_snr / torch.clamp_min(tmax, 1e-6)
    return segs, cand, mask, targets, ev.sig_snr, snr_est


def net_from_config(cfg: PriorityTrainConfig) -> PriorityNet:
    return PriorityNet(d_model=cfg.d_model, use_energy=cfg.use_energy,
                       use_snr_est=cfg.use_snr_est, use_dt=cfg.use_dt,
                       residual_snr=cfg.residual_snr)


def init_priority_net(net: PriorityNet,
                      generator: Optional[torch.Generator] = None
                      ) -> PriorityNet:
    """flax's default initializers (lecun-normal kernels, zero biases,
    LayerNorm 1/0) on the CPU; the priority head starts at 0 with the
    oracle-residual head, res_w and cal_gain at 1, cal_bias at 0."""
    init_params(net, generator)
    if net.residual_snr:
        with torch.no_grad():
            net.priority_head.weight.zero_()
    return net


def priority_loss(net: PriorityNet, batch, cfg: PriorityTrainConfig
                  ) -> torch.Tensor:
    """The training loss of one make_priority_batch batch."""
    segs, cand, mask, targets, snr, snr_est = batch
    scores, sigma, aux = net(segs, cand, mask, with_aux=True,
                             snr_est=snr_est)
    return ranking_loss(scores, targets, sigma, mask, aux=aux, snr=snr,
                        close_boost=cfg.close_boost)


class PriorityOptimizer:
    """optax.adam over optax.warmup_cosine_decay_schedule(0, lr,
    min(100, steps // 10), max(steps, 2), 0.05·lr), in place: no clipping
    and no weight decay. `count` is the number of updates made."""

    def __init__(self, net: PriorityNet, lr: float, steps: int):
        self.peak = lr
        self.warmup = min(100, steps // 10)
        self.decay_steps = max(steps, 2)
        self.params = list(net.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.lr()                          # the schedule's checks, up front

    def lr(self) -> float:
        return warmup_cosine(self.count, self.peak, self.warmup,
                             self.decay_steps, 0.05 * self.peak)

    def step(self):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        adam_update_(self.params, grads, self.mu, self.nu, self.count + 1,
                     self.lr())
        self.count += 1
        for p in self.params:
            p.grad = None


@torch.no_grad()
def top1_accuracy(net: PriorityNet, batch) -> float:
    """Top-1 accuracy over the events of a batch with >= 2 live
    candidates."""
    segs, cand, mask, targets, _snr, snr_est = batch
    scores, _ = net(segs, cand, mask, snr_est=snr_est)
    multi = torch.sum(mask, dim=1) >= 2
    neg = torch.full_like(scores, -float("inf"))
    top_pred = torch.argmax(torch.where(mask > 0, scores, neg), dim=1)
    top_true = torch.argmax(torch.where(mask > 0, targets, neg), dim=1)
    hits = torch.sum((top_pred == top_true) & multi)
    return float(hits / torch.clamp_min(multi.sum(), 1))


def _net_meta(cfg: PriorityTrainConfig) -> dict:
    return {"d_model": cfg.d_model, "use_energy": cfg.use_energy,
            "use_snr_est": cfg.use_snr_est, "use_dt": cfg.use_dt,
            "residual_snr": cfg.residual_snr,
            "train": {"close_boost": cfg.close_boost,
                      "mine_pool": cfg.mine_pool}}


def fit_priority(outdir, cfg: PriorityTrainConfig = PriorityTrainConfig(),
                 steps: int = 500, seed: int = 0, eval_every: int = 100,
                 device="cuda"):
    """Train a PriorityNet on `device`; returns (net, history). Writes
    priority_params.msgpack (flax's bytes, which the JAX package's
    load_priority_net reads), net.json and history.json under outdir, as
    posteriflow_tpu/train/train_priority.py:207-213 does. Batches come from a
    generator on `device` seeded with `seed`; the evaluation batch of step
    i from one seeded with seed + 999 and i; the initial weights from a
    CPU generator seeded with `seed`."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    device = torch.device(device)
    net = init_priority_net(net_from_config(cfg),
                            torch.Generator().manual_seed(seed)).to(device)
    opt = PriorityOptimizer(net, cfg.lr, steps)
    gen = torch.Generator(device=device).manual_seed(seed)

    history: List[Dict] = []
    t0 = time.time()
    for i in range(steps):
        batch = make_priority_batch(cfg, gen, device)
        loss = priority_loss(net, batch, cfg)
        backward(loss)
        opt.step()
        if (i + 1) % eval_every == 0 or i == 0:
            eval_gen = torch.Generator(device=device).manual_seed(
                (seed + 999) * 1_000_003 + i)
            acc = top1_accuracy(net, make_priority_batch(cfg, eval_gen,
                                                         device))
            rec = {"step": i + 1, "loss": loss.item(), "top1_acc": acc,
                   "seconds": round(time.time() - t0, 1)}
            history.append(rec)
            log.info("step %4d | loss %.4f | top-1 %.3f", i + 1,
                     rec["loss"], acc)

    write_params(net, outdir / "priority_params.msgpack")
    (outdir / "net.json").write_text(json.dumps(_net_meta(cfg)))
    (outdir / "history.json").write_text(json.dumps(history, indent=2))
    return net, history


# a PriorityNet tree needs nothing beyond the release's flax -> torch map
priority_flax_to_state_dict = flax_to_state_dict


def load_priority_net(path, d_model: int = 64, use_energy: bool = False,
                      use_snr_est: bool = False, device="cuda"
                      ) -> PriorityNet:
    """A PriorityNet in eval mode on `device` from a released flax
    `priority_params.msgpack` (or a directory holding one), or from a
    directory that `fit_priority` wrote (priority_params.msgpack; earlier
    port runs wrote state.pt, which is read too). A `net.json` beside
    the weights overrides the architecture arguments; use_dt and
    residual_snr default to False. Every leaf must match by name and
    shape: a missing or left-over leaf raises."""
    path = Path(path)
    root = path if path.is_dir() else path.parent
    use_dt = residual_snr = False
    meta = root / "net.json"
    if meta.exists():
        m = json.loads(meta.read_text())
        d_model = m.get("d_model", d_model)
        use_energy = m.get("use_energy", use_energy)
        use_snr_est = m.get("use_snr_est", use_snr_est)
        use_dt = m.get("use_dt", False)
        residual_snr = m.get("residual_snr", False)
    net = PriorityNet(d_model=d_model, use_energy=use_energy,
                      use_snr_est=use_snr_est, use_dt=use_dt,
                      residual_snr=residual_snr)
    if path.is_dir() and (path / "state.pt").exists():
        sd = torch.load(path / "state.pt", map_location="cpu",
                        weights_only=True)
    else:
        msgpack = path / "priority_params.msgpack" if path.is_dir() else path
        sd = priority_flax_to_state_dict(unpackb(msgpack.read_bytes()))
    net.load_state_dict(sd, strict=True)
    return net.to(torch.device(device)).eval()


if __name__ == "__main__":
    # python -m posteriflow_torch.train.train_priority --outdir model/pv7 \
    #     --steps 20000 --v7 --close-boost 2 --mine-pool 2
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outdir", default="model/priority_torch")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--close-boost", type=float, default=0.0)
    ap.add_argument("--mine-pool", type=int, default=1)
    ap.add_argument("--v7", action="store_true",
                    help="use_dt + residual_snr (the v7 architecture)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    fit_priority(a.outdir,
                 PriorityTrainConfig(close_boost=a.close_boost, lr=a.lr,
                                     mine_pool=a.mine_pool, use_dt=a.v7,
                                     residual_snr=a.v7),
                 steps=a.steps, seed=a.seed, device=a.device)
