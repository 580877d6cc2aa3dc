"""DINGO's posterior model (Dax et al., PRL 127, 241103 (2021);
github.com/dingo-gw/dingo), served by InferenceEngine beside LeanNPE.

    strain [B, D, 3, n_f]  whitened FD strain a detector: real part,
                           imaginary part, 1 / (ASD·10²³)
      -> LinearProjectionRB  one Linear(3·n_f -> 2·n_rb) a detector
                             (dingo starts it from an SVD basis)
      -> DenseResidualNet    Linear into the first width, residual blocks
                             (batch norm, ELU), a Linear where the width
                             changes, a last Linear -> context c [B, C]
      -> DingoFlow           models/dingo_flow.py: draws of the
                             standardised parameters (θ − μ) / σ
      -> θ = μ + σ·y

The model has one signal: no rank embedding, the context is c alone. Its
products run in float32 without TF32 (utils/precision.fp32_exact), as
dingo runs. There is no release: `seeded_state_dict` builds weights from a
seed at the scales of SEEDED_INIT, and `train/checkpoints.load_dingo`
reads a configuration and builds its weights so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.models.dingo_flow import (DingoFlow, LULinear,
                                                 ResidualBlock, ResidualNet)
from posteriflow_torch.utils.logging import span
from posteriflow_torch.utils.precision import fp32_exact


@dataclasses.dataclass(frozen=True)
class DingoConfig:
    """The `dingo` part of a configuration (dingo's `model` block as
    pfbench/configs/dingo_nsf30.json maps it). param_mean and param_std
    standardise the parameters."""
    param_mean: tuple
    param_std: tuple
    param_names: tuple = PARAM_NAMES_PRECESSING
    detectors: tuple = ("H1", "L1", "V1")
    f_min: float = 20.0
    f_max: float = 1024.0
    delta_f: float = 0.125
    n_rb: int = 200
    resnet_widths: tuple = (1024,) * 8 + (512,) * 8 + (256,) * 8 + (128,) * 8
    context_dim: int = 128
    flow_steps: int = 30
    flow_hidden: int = 512
    flow_blocks: int = 5
    flow_bins: int = 8
    tail_bound: float = 1.0
    bn_eps: float = 1e-3

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    @property
    def n_freq(self) -> int:
        return int(round((self.f_max - self.f_min) / self.delta_f)) + 1

    # the serving interface LeanNPE's config gives InferenceEngine
    uses_asd_bands = False       # the ASD is a channel of the strain
    max_signals = 1              # one signal: rank 0 only


def dingo_config_from_dict(d: dict) -> DingoConfig:
    """A configuration's `config` ({"dingo": {...}}) -> DingoConfig; lists
    become tuples, a key DingoConfig lacks raises."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d["dingo"].items()}
    return DingoConfig(**kw)


class Standardizer:
    """θ <-> y = (θ − μ) / σ, with the methods of ParamScaler that
    InferenceEngine uses; no parameter rails."""

    def __init__(self, cfg: DingoConfig):
        self.param_names = tuple(cfg.param_names)
        self.mean = torch.tensor(cfg.param_mean, dtype=torch.float32)
        self.std = torch.tensor(cfg.param_std, dtype=torch.float32)
        self._on_device = {}

    def _consts(self, device):
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (self.mean.to(device), self.std.to(device))
        return self._on_device[key]

    def normalize(self, theta: torch.Tensor) -> torch.Tensor:
        mean, std = self._consts(theta.device)
        return (theta - mean) / std

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        mean, std = self._consts(y.device)
        return y * std + mean

    def railing_mask(self, y: torch.Tensor) -> torch.Tensor:
        return torch.zeros(y.shape[:-1], dtype=torch.bool, device=y.device)

    def log_abs_det_jacobian(self, theta: torch.Tensor) -> torch.Tensor:
        """log|dy/dθ| = −Σ log σ, broadcast to θ's rows."""
        _, std = self._consts(theta.device)
        return (-torch.sum(torch.log(std))).expand(theta.shape[:-1])


class LinearProjectionRB(nn.Module):
    """dingo's LinearProjectionRB: detector d's [3, n_f] flattened through
    its own Linear(3·n_f -> 2·n_rb); the outputs concatenated."""

    def __init__(self, n_det: int, n_freq: int, n_rb: int):
        super().__init__()
        self.shape = (n_det, 3, n_freq)
        self.layers = nn.ModuleList(nn.Linear(3 * n_freq, 2 * n_rb)
                                    for _ in range(n_det))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:]) != self.shape:
            raise ValueError(f"strain must be [B, *{list(self.shape)}], "
                             f"got {list(x.shape)}")
        b = x.shape[0]
        return torch.cat([layer(x[:, d].reshape(b, -1))
                          for d, layer in enumerate(self.layers)], dim=1)


class DenseResidualNet(nn.Module):
    """dingo's DenseResidualNet without context: Linear(in -> widths[0]),
    a residual block a width, a Linear after each block where the next
    width differs, and Linear(widths[-1] -> out) after the last."""

    def __init__(self, in_features: int, out_features: int, widths: tuple,
                 eps: float):
        super().__init__()
        self.initial = nn.Linear(in_features, widths[0])
        self.blocks = nn.ModuleList(ResidualBlock(w, 0, eps) for w in widths)
        self.resize = nn.ModuleList(
            nn.Linear(a, b) if a != b else nn.Identity()
            for a, b in zip(widths, widths[1:]))
        self.final = nn.Linear(widths[-1], out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.initial(x)
        for blk, resize in zip(self.blocks, [*self.resize, self.final]):
            h = resize(blk(h))
        return h


class DingoEmbedding(nn.Module):
    def __init__(self, cfg: DingoConfig):
        super().__init__()
        n_det = len(cfg.detectors)
        self.projection = LinearProjectionRB(n_det, cfg.n_freq, cfg.n_rb)
        self.resnet = DenseResidualNet(2 * cfg.n_rb * n_det, cfg.context_dim,
                                       tuple(cfg.resnet_widths), cfg.bn_eps)

    def forward(self, strain: torch.Tensor) -> torch.Tensor:
        with span("pf.dingo.embed"):
            with span("pf.dingo.embed.projection"):
                x = self.projection(strain)
            with span("pf.dingo.embed.resnet"):
                return self.resnet(x)


class DingoNPE(nn.Module):
    """Embedding and flow, with LeanNPE's serving interface (`encode`,
    `sample_from_context`, `nll_from_context`, `scaler`)."""

    def __init__(self, cfg: DingoConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = DingoEmbedding(cfg)
        self.flow = DingoFlow(cfg.n_params, cfg.context_dim, cfg.flow_steps,
                              cfg.flow_hidden, cfg.flow_blocks,
                              cfg.flow_bins, cfg.tail_bound, cfg.bn_eps)
        self.scaler = Standardizer(cfg)

    def encode(self, strain: torch.Tensor,
               asd_bands: Optional[torch.Tensor] = None) -> torch.Tensor:
        """strain [B, D, 3, n_f] -> context [B, C]. There are no bands:
        the ASD is the strain's third channel."""
        if asd_bands is not None:
            raise ValueError("DINGO takes the ASD as a strain channel, not "
                             "as bands")
        with fp32_exact():
            return self.embedding(strain)

    def sample_from_context(self, context: torch.Tensor, rank: torch.Tensor,
                            n_samples: int,
                            generator: Optional[torch.Generator] = None,
                            z: Optional[torch.Tensor] = None):
        """context [B, C] -> (physical draws [B, n, P], standardised draws
        [B, n, P], log q of the standardised draws [B, n]). `rank` is every
        row's 0 (one signal; InferenceEngine checks it on the host). Base
        draws z [B, n, P] come from `generator`, or are given."""
        if z is None:
            z = torch.randn((context.shape[0], n_samples, self.cfg.n_params),
                            generator=generator, device=context.device)
        with fp32_exact():
            y, log_q = self.flow.sample_with_log_prob(z, context[:, None, :])
        return self.scaler.denormalize(y), y, log_q

    def nll_from_context(self, context: torch.Tensor,
                         theta_phys: torch.Tensor,
                         rank: torch.Tensor) -> torch.Tensor:
        """context [..., C], θ [..., P] physical -> −log q of the
        standardised θ [...] (rank as in sample_from_context)."""
        with fp32_exact():
            return -self.flow.log_prob(self.scaler.normalize(theta_phys),
                                       context)


# The scales of seeded weights. nflows starts each residual block's last
# layer near zero and each LULinear at the identity, which would leave the
# blocks and the linear transforms almost idle; these give every part a
# measurable effect and keep 30 steps of draws finite.
SEEDED_INIT = {
    "linear": 1.0,         # weight std · √fan_in of every Linear
    "residual_out": 0.3,   # the same for each residual block's last Linear
    "spline_wh": 0.4,      # std of the width and height rows of a
                           # conditioner's last Linear: the logits after
                           # nflows' 1/√hidden come out ~0.4·rms(h)
    "spline_d": 0.5,       # weight std · √fan_in of its derivative rows
    "bias": 0.05,          # std of every Linear's bias
    "bn_mean": 0.2,        # running mean ~ U(−0.2, 0.2)
    "bn_var": (0.5, 2.0),  # running variance ~ U(0.5, 2)
    "bn_weight": (0.8, 1.2),
    "bn_bias": 0.1,        # ~ U(−0.1, 0.1)
    "lu": 0.05,            # std of the L and U entries, of the diagonal's
                           # offset from softplus⁻¹(1 − 1e-3) and of the bias
}


def _init_linear(layer: nn.Linear, gain: float, g: torch.Generator):
    layer.weight.normal_(0.0, gain / math.sqrt(layer.in_features),
                         generator=g)
    layer.bias.normal_(0.0, SEEDED_INIT["bias"], generator=g)


def _init_block(blk: ResidualBlock, g: torch.Generator):
    s = SEEDED_INIT
    for bn in blk.bn:
        bn.running_mean.uniform_(-s["bn_mean"], s["bn_mean"], generator=g)
        bn.running_var.uniform_(*s["bn_var"], generator=g)
        bn.weight.uniform_(*s["bn_weight"], generator=g)
        bn.bias.uniform_(-s["bn_bias"], s["bn_bias"], generator=g)
    _init_linear(blk.linear[0], s["linear"], g)
    _init_linear(blk.linear[1], s["residual_out"], g)
    if blk.context is not None:
        _init_linear(blk.context, s["linear"], g)


def _init_lu(lin: LULinear, g: torch.Generator):
    s = SEEDED_INIT["lu"]
    lin.permutation.copy_(torch.randperm(lin.features, generator=g))
    lin.lower_entries.normal_(0.0, s, generator=g)
    lin.upper_entries.normal_(0.0, s, generator=g)
    lin.unconstrained_upper_diag.add_(
        torch.randn(lin.features, generator=g) * s)
    lin.bias.normal_(0.0, s, generator=g)


def _init_conditioner(net: ResidualNet, num_bins: int, g: torch.Generator):
    s = SEEDED_INIT
    _init_linear(net.initial, s["linear"], g)
    for blk in net.blocks:
        _init_block(blk, g)
    _init_linear(net.final, s["spline_d"], g)
    n_raw = 3 * num_bins - 1
    rows = net.final.weight.view(net.n_tr, n_raw, -1)[:, :2 * num_bins]
    rows.copy_(torch.randn(rows.shape, generator=g) * s["spline_wh"])


@torch.no_grad()
def seeded_state_dict(cfg: DingoConfig, seed: int) -> dict:
    """A state dict of DingoNPE(cfg) from `seed` at the scales of
    SEEDED_INIT, drawn on the CPU in module order, so that a seed gives
    the same weights on every machine."""
    g = torch.Generator().manual_seed(seed)
    model = DingoNPE(cfg)
    s = SEEDED_INIT
    for layer in model.embedding.projection.layers:
        _init_linear(layer, s["linear"], g)
    net = model.embedding.resnet
    _init_linear(net.initial, s["linear"], g)
    for blk in net.blocks:
        _init_block(blk, g)
    for layer in [*net.resize, net.final]:
        if isinstance(layer, nn.Linear):
            _init_linear(layer, s["linear"], g)
    for lin in model.flow.linears:
        _init_lu(lin, g)
    for cpl in model.flow.couplings:
        _init_conditioner(cpl.net, cfg.flow_bins, g)
    return model.state_dict()
