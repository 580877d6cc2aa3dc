"""The NPE trainer (torch): simulate → encode → per-rank NLL → grads →
clip → AdamW.

Port of posteriflow_tpu/train/trainer.py:37-219. What changes in PyTorch:

  - the parameters start from flax's default initializers (`init_params`),
    not torch's, so that a fresh model has JAX's initial distribution;
  - the optimizer is written to optax's formulas, not torch's
    (`Optimizer`): a warmup-cosine schedule that gives lr 0 at count 0,
    global clipping that scales only when ‖g‖ ≥ max, optax's AdamW (eps
    outside the square root, every leaf decayed) and optax 0.2.6's
    adaptive clipping with per-unit norms over axis 0 of the flax layout;
  - the backward pass runs inside `fp32_exact()`, so the float32 products
    (convs and the flow's output projections) are differentiated without
    TF32, as JAX differentiates them;
  - an epoch is a Python loop over steps, and each step draws its batch
    from a torch.Generator seeded by (seed, epoch, step);
  - on the card the spline runs its CUDA kernels forward and backward
    (ops/rqs_cuda.py RqsForwardFn);
  - data parallelism (`mesh=`) is one process a device: each rank draws
    the whole step's events, simulates its rows, and sums its gradients
    with the other ranks' before the clip (GSPMD's all-reduce), with the
    model's parameters and names unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from posteriflow_torch.data.noise_bank import NoiseBank
from posteriflow_torch.models.encoder import (AttentionPool,
                                              LeanStrainEncoder)
from posteriflow_torch.models.flow import Conditioner
from posteriflow_torch.models.npe import LeanNPE, NPEConfig
from posteriflow_torch.parallel.mesh import (all_reduce_grads,
                                             all_reduce_sum, shard_batch)
from posteriflow_torch.physics.simulator import (EventBatch, SimConfig,
                                                 draw_events, draw_real,
                                                 mixes_real_noise,
                                                 simulate_batch)
from posteriflow_torch.prior import sample_batch
from posteriflow_torch.train.checkpoints import flax_view
from posteriflow_torch.utils.precision import fp32_exact

# optax.adamw's defaults, and adaptive_grad_clip's
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
AGC_EPS, AGC_DIV_EPS = 1e-3, 1e-6
# flax's truncated normal: the stddev of N(0, 1) cut at ±2
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    npe: NPEConfig = NPEConfig()
    sim: SimConfig = SimConfig()
    batch_size: int = 128
    lr: float = 3e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 20_000
    grad_clip: float = 5.0
    # "global": clip by the global norm at grad_clip; "agc": adaptive
    # clipping, per unit relative to the parameter's norm, with the factor
    # 0.01·grad_clip
    grad_clip_mode: str = "global"

    def __post_init__(self):
        if self.npe.n_params != self.sim.prior.n_params:
            raise ValueError(
                f"npe.param_names has {self.npe.n_params} params but "
                f"sim.prior samples {self.sim.prior.n_params} "
                f"(prior.precessing={self.sim.prior.precessing}); set "
                "npe.param_names to PARAM_NAMES_PRECESSING for a "
                "precessing prior")
        if self.grad_clip_mode not in ("global", "agc"):
            raise ValueError(f"grad_clip_mode must be 'global' or 'agc', "
                             f"got {self.grad_clip_mode!r}")


def init_params(model: LeanNPE,
                generator: Optional[torch.Generator] = None) -> LeanNPE:
    """Draw every parameter of `model` (on the CPU) from flax's default
    initializer for its flax leaf: lecun-normal kernels (a truncated normal
    on ±2σ, σ = sqrt(1/fan_in)/0.8796, fan_in over the flax kernel's input
    axes: `in` for Dense and DenseGeneral, k·in for Conv) and zero biases;
    LayerNorm scale 1 and bias 0; Embed N(0, 1/features); the attention
    pool's queries N(0, 1/d_model) and the detector embedding N(0, 0.02²);
    the conditioners' output projections stay 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0,
                                math.sqrt(1.0 / mod.weight.shape[1]),
                                generator=generator)
            if isinstance(mod, AttentionPool):
                nn.init.normal_(mod.queries, 0.0,
                                1.0 / math.sqrt(mod.queries.shape[1]),
                                generator=generator)
            elif isinstance(mod, LeanStrainEncoder):
                nn.init.normal_(mod.detector_embed, 0.0, 0.02,
                                generator=generator)
        for mod in model.modules():
            if isinstance(mod, Conditioner):
                nn.init.zeros_(mod.out.weight)
                nn.init.zeros_(mod.out.bias)
    return model


def warmup_cosine(count: int, peak: float, warmup: int, decay_steps: int,
                  end_value: float) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end_value) at `count`: linear from 0 over the warmup, then a cosine down
    to end_value over the remaining decay_steps - warmup counts."""
    decay = decay_steps - warmup
    if decay <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed the "
                         f"warmup ({warmup})")
    if count < warmup:
        frac = 1.0 - min(max(count, 0), warmup) / warmup
        return (0.0 - peak) * frac + peak
    alpha = 0.0 if peak == 0.0 else end_value / peak
    c = min(count - warmup, decay)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
    return peak * ((1.0 - alpha) * cosine + alpha)


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps,
    0.01·lr) at `count`: linear from 0 over the warmup, then cosine down to
    the 1% floor."""
    return warmup_cosine(count, cfg.lr, cfg.warmup_steps, cfg.total_steps,
                         0.01 * cfg.lr)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm over every entry of every tensor."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _unitwise_norm(a: torch.Tensor) -> torch.Tensor:
    """optax 0.2.6 unitwise_norm on a flax-layout leaf: one norm if it
    squeezes to rank <= 1, else over axis 0 for rank 2 and 3."""
    if a.squeeze().dim() <= 1:
        return torch.linalg.vector_norm(a).expand(a.shape)
    if a.dim() in (2, 3):
        return torch.linalg.vector_norm(a, dim=0, keepdim=True).expand(
            a.shape)
    raise ValueError(f"no unit-wise norm for a leaf of shape "
                     f"{tuple(a.shape)}")


@torch.no_grad()
def adam_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                 mu: List[torch.Tensor], nu: List[torch.Tensor], t: int,
                 lr: float, weight_decay: float = 0.0):
    """optax's Adam update number `t` (from 1) in place: the moments with
    bias correction, eps outside the square root, then (adamw) the
    decoupled decay weight_decay·param, and the step -lr·update."""
    b1, b2 = ADAM_B1, ADAM_B2
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(nu, 1.0 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    upd = torch._foreach_div(mu, 1.0 - b1 ** t)
    torch._foreach_div_(upd, denom)
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr)


class Optimizer:
    """optax.chain(clip, optax.adamw(schedule, weight_decay)) over the
    model's parameters, in place: `step()` reads each parameter's .grad
    (a missing one counts as zeros) and updates the parameter. `count` is
    the number of updates made (the TrainState's step)."""

    def __init__(self, model: LeanNPE, cfg: TrainConfig):
        learning_rate(cfg, 0)            # the schedule's checks, up front
        self.cfg = cfg
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr(self) -> float:
        """The learning rate of the next update."""
        return learning_rate(self.cfg, self.count)

    def grads(self) -> List[torch.Tensor]:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def clip_(self, grads: List[torch.Tensor]):
        """The clip of the chain, on the gradients in place."""
        cfg = self.cfg
        if cfg.grad_clip_mode == "global":
            # where ‖g‖ >= max, g·(max/‖g‖): optax's (g/‖g‖)·max within a
            # rounding
            g_norm = global_norm(grads)
            factor = torch.where(g_norm < cfg.grad_clip,
                                 torch.ones_like(g_norm),
                                 cfg.grad_clip / g_norm)
            torch._foreach_mul_(grads, factor)
            return
        clipping = 0.01 * cfg.grad_clip
        for name, p, g in zip(self.names, self.params, grads):
            gv = flax_view(self.model, name, g)
            g_norm = _unitwise_norm(gv)
            max_norm = clipping * torch.clamp(
                _unitwise_norm(flax_view(self.model, name, p.detach())),
                min=AGC_EPS)
            clipped = gv * (max_norm / torch.clamp(g_norm, min=AGC_DIV_EPS))
            gv.copy_(torch.where(g_norm < max_norm, gv, clipped))

    @torch.no_grad()
    def step(self):
        """One update: clip, Adam moments with bias correction, decoupled
        weight decay, the schedule's lr at the current count."""
        grads = self.grads()
        self.clip_(grads)
        adam_update_(self.params, grads, self.mu, self.nu, self.count + 1,
                     self.lr(), self.cfg.weight_decay)
        self.count += 1

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        for i, n in enumerate(self.names):
            self.mu[i].copy_(state["mu"][n])
            self.nu[i].copy_(state["nu"][n])


def make_optimizer(cfg: TrainConfig, model: LeanNPE) -> Optimizer:
    """The optimizer of cfg over the model's parameters: its clip
    (cfg.grad_clip_mode), AdamW with weight decay cfg.weight_decay and the
    warmup-cosine schedule (posteriflow_tpu/train/trainer.py:71-82, whose
    optax chain is bound to the parameters later; a torch optimizer holds
    them, so it takes the model)."""
    return Optimizer(model, cfg)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the config they were built from."""
    model: LeanNPE
    opt: Optimizer
    cfg: TrainConfig

    @property
    def step(self) -> int:
        return self.opt.count


def init_state(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> TrainState:
    """A fresh model with flax's initial distribution (drawn on the CPU
    from `generator`), moved to `device`, with a fresh optimizer."""
    model = init_params(LeanNPE(cfg.npe), generator).to(device)
    return TrainState(model=model, opt=make_optimizer(cfg, model), cfg=cfg)


def batch_nll(model: LeanNPE, batch: EventBatch,
              group=None) -> torch.Tensor:
    """Mean per-signal NLL over a batch of events: the encoder once per
    event, the flow once over the flattened [B·S] (event, rank) grid, dead
    slots masked out (posteriflow_tpu/train/trainer.py:101-121).

    With a process group the batch is this rank's rows of a global batch:
    the masked sum is divided by the live slots of the whole batch (summed
    over the group, no gradient), so that the group's results sum to the
    global mean, as GSPMD's is one mean over the global batch."""
    asd = batch.asd_bands if model.cfg.uses_asd_bands else None
    context = model.encode(batch.strain, asd)
    b, s, p = batch.params.shape
    ctx_rep = torch.repeat_interleave(context, s, dim=0)        # [B·S, C]
    theta = batch.params.reshape(b * s, p)
    slots = torch.arange(s, device=context.device)
    ranks = slots.repeat(b)
    nll_all = model.nll_from_context(ctx_rep, theta, ranks).reshape(b, s)
    mask = (slots[None, :] < batch.n_sig[:, None]).float()
    count = torch.sum(mask)
    if group is not None:
        count = all_reduce_sum(count, group)
    return torch.sum(nll_all * mask) / torch.clamp(count, min=1.0)


def backward(loss: torch.Tensor):
    """loss.backward() with TF32 off for the float32 convs and matmuls."""
    with fp32_exact():
        loss.backward()


def component_grad_norms(model: LeanNPE) -> Dict[str, torch.Tensor]:
    """Gradient norms of the encoder, the flow and the rank embedding."""
    out = {}
    for name, prefix in (("gn_encoder", "encoder."), ("gn_flow", "flow."),
                         ("gn_rank", "rank_embed.")):
        grads = [p.grad for n, p in model.named_parameters()
                 if n.startswith(prefix) and p.grad is not None]
        if grads:
            out[name] = global_norm(grads)
    return out


def train_step(state: TrainState, batch: EventBatch,
               group=None) -> Dict[str, torch.Tensor]:
    """One update on `batch`: NLL, backward, clip, AdamW. The metrics stay
    on the device (no synchronisation).

    With a process group, `batch` is this rank's rows of the global batch:
    the gradients are summed over the group after the backward, so that
    the clip, the norms and the update see the global batch's gradient
    identically on every rank, and the metrics are the global batch's."""
    state.opt.zero_grad()
    loss = batch_nll(state.model, batch, group)
    backward(loss)
    if group is not None:
        all_reduce_grads(state.opt.params, group)
    grads = state.opt.grads()
    loss = loss.detach()
    mean_nsig = batch.n_sig.float().mean()
    mean_snr = batch.net_snr.mean()
    if group is not None:
        stats = all_reduce_sum(torch.stack([loss, mean_nsig, mean_snr]),
                               group)
        loss = stats[0]
        mean_nsig, mean_snr = stats[1:] / dist.get_world_size(group)
    metrics = {"nll": loss, "grad_norm": global_norm(grads),
               "mean_nsig": mean_nsig, "mean_snr": mean_snr}
    metrics.update(component_grad_norms(state.model))
    state.opt.step()
    return metrics


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one step's batch, from (seed, epoch, step)."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)[0] >> 1)


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def simulate_shard(cfg: TrainConfig, mesh, device,
                   generator: torch.Generator,
                   bank: Optional[NoiseBank] = None) -> EventBatch:
    """This rank's rows along "data" of the batch that simulate_batch
    draws from `generator`: every rank draws the whole batch's prior
    parameters and event draws (and the real-noise draws with a bank), in
    simulate_batch's order, keeps its rows and simulates only those. So a
    global batch is the same on any mesh."""
    b = cfg.batch_size
    params, n_sig = sample_batch(b, cfg.sim.prior, generator, device)
    draws = draw_events((b,), generator, device)
    real = None
    if mixes_real_noise(cfg.sim, bank):
        real = draw_real((b,), generator, device, bank)
    params, n_sig, draws, real = shard_batch(mesh, (params, n_sig, draws,
                                                    real))
    return simulate_batch(params.shape[0], cfg.sim, device=device,
                          params=params, n_sig=n_sig, draws=draws,
                          bank=bank, real_draws=real)


def make_train_step(cfg: TrainConfig, bank: Optional[NoiseBank] = None,
                    mesh=None):
    """step(state, generator) -> metrics: simulate a batch of
    cfg.batch_size events from `generator` on the model's device (mixing in
    `bank`'s real noise with cfg.sim.real_noise_prob), then train_step.

    With a DeviceMesh (parallel/mesh.py), each rank simulates and trains
    its rows along "data" of the same global batch (`simulate_shard`;
    every rank passes a generator in the same state) and the gradients are
    summed over "data": the update and the metrics are those of the
    unsharded step on the global batch, identical on every rank."""
    group = None if mesh is None else mesh.get_group("data")

    def step(state: TrainState, generator: torch.Generator):
        dev = _device(state)
        if mesh is None:
            batch = simulate_batch(cfg.batch_size, cfg.sim, device=dev,
                                   generator=generator, bank=bank)
        else:
            batch = simulate_shard(cfg, mesh, dev, generator, bank)
        return train_step(state, batch, group)
    return step


def make_train_epoch(cfg: TrainConfig, n_steps: int,
                     bank: Optional[NoiseBank] = None, mesh=None):
    """epoch(state, seed, epoch) -> mean metrics of n_steps steps (nll,
    grad_norm, the component norms as means, last_nll); step i draws from a
    generator seeded by step_seed(seed, epoch, i), with `bank` and `mesh`
    as in make_train_step."""
    step_fn = make_train_step(cfg, bank, mesh)

    def epoch_fn(state: TrainState, seed: int, epoch: int) -> dict:
        dev = _device(state)
        hist = []
        for i in range(n_steps):
            gen = torch.Generator(device=dev).manual_seed(
                step_seed(seed, epoch, i))
            hist.append(step_fn(state, gen))
        stacked = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
        out = {"nll": float(stacked["nll"].mean()),
               "grad_norm": float(stacked["grad_norm"].mean()),
               "last_nll": float(stacked["nll"][-1])}
        out.update({k: float(v.mean()) for k, v in stacked.items()
                    if k.startswith("gn_")})
        return out

    return epoch_fn


def make_eval_nll(cfg: TrainConfig):
    """eval_nll(model, batch) -> the batch NLL as a float, under no_grad."""
    def eval_nll(model: LeanNPE, batch: EventBatch) -> float:
        with torch.no_grad():
            return float(batch_nll(model, batch))
    return eval_nll
