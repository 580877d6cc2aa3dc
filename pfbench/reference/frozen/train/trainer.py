"""The NPE trainer (torch): simulate → encode → per-rank NLL → grads →
clip → AdamW.

Port of posteriflow_tpu/train/trainer.py:37-219. What changes in PyTorch:

  - the optimizer is written to optax's formulas, not torch's
    (`Optimizer`): a warmup-cosine schedule that gives lr 0 at count 0,
    global clipping that scales only when ‖g‖ ≥ max, optax's AdamW (eps
    outside the square root, every leaf decayed) and optax 0.2.6's
    adaptive clipping with per-unit norms over axis 0 of the flax layout;
  - the backward pass runs inside `fp32_exact()`, so the float32 products
    (convs and the flow's output projections) are differentiated without
    TF32, as JAX differentiates them;
  - the spline is the plain one of ops/rqs.py, differentiated by
    autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from pfbench.reference.frozen.models.npe import LeanNPE, NPEConfig
from pfbench.reference.frozen.physics.simulator import EventBatch, SimConfig
from pfbench.reference.frozen.train.checkpoints import flax_view
from pfbench.reference.frozen.utils.precision import fp32_exact

# optax.adamw's defaults, and adaptive_grad_clip's
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
AGC_EPS, AGC_DIV_EPS = 1e-3, 1e-6

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


@torch.no_grad()
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

def batch_nll(model: LeanNPE, batch: EventBatch) -> torch.Tensor:
    """Mean per-signal NLL over a batch of events: the encoder once per
    event, the flow once over the flattened [B·S] (event, rank) grid, dead
    slots masked out (posteriflow_tpu/train/trainer.py:101-121)."""
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
    return torch.sum(nll_all * mask) / torch.clamp(count, min=1.0)


def backward(loss: torch.Tensor):
    """loss.backward() with TF32 off for the float32 convs and matmuls."""
    with fp32_exact():
        loss.backward()


def train_step(state: TrainState, batch: EventBatch) -> Dict[str, torch.Tensor]:
    """One update on `batch`: NLL, backward, clip, AdamW -> {"nll"}, on
    the device (no synchronisation)."""
    state.opt.zero_grad()
    loss = batch_nll(state.model, batch)
    backward(loss)
    state.opt.step()
    return {"nll": loss.detach()}
