"""The plain reference of the DINGO cell, and the gaps that decide
`correct`.

DINGO's posterior network (Dax et al., PRL 127, 241103 (2021)) written
from the published code in plain PyTorch, float32, with TF32 off: dingo's
LinearProjectionRB and DenseResidualNet (dingo/core/nn/enets.py) and the
flow of dingo/core/nn/nsf.py create_transform on nflows'
RandomPermutation, LULinear, ResidualNet, ResidualBlock and
PiecewiseRationalQuadraticCouplingTransform with linear tails
(nflows/transforms/permutations.py, lu.py, coupling.py, splines/
rational_quadratic.py; nflows/nn/nets/resnet.py). It imports no kernel and
no module of the program, and loads the program's state dict.

Departures from the published code, none of which changes the function:
- attribute names follow the program's state dict (`bn`, `linear`,
  `context`, `initial`, `final`; nflows' `batch_norm_layers`,
  `linear_layers`, `context_layer`, `initial_layer`, `final_layer`);
- LULinear's triangular solves are torch.linalg.solve_triangular on the
  same triangles (nflows calls the deprecated torch.triangular_solve);
- the step's permutation is held by the LULinear that follows it;
- sampling takes given base draws, and runs `block` draws at a time.
Nothing of the program's own orders of operations is copied: the context
is repeated to every draw and concatenated to the conditioner's input,
the logits are divided after the last layer, and the gate is nflows' GLU.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pfbench.reference.npe import event_quantiles

MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3


def _to_tf32(x):
    """float32 x rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), as a tensor core takes its operands."""
    if x is None:
        return None
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32(allowed: bool):
    """float32 matrix products with TF32 allowed or not, the caller's
    settings restored on exit. Allowed, every F.linear also takes its
    operands rounded to TF32, so that a CPU, which has no TF32, computes
    at the same precision as the card's tensor cores."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, F.linear)
    torch.backends.cuda.matmul.allow_tf32 = allowed
    torch.backends.cudnn.allow_tf32 = allowed
    if allowed:
        linear = saved[2]
        F.linear = lambda x, w, b=None: linear(_to_tf32(x), _to_tf32(w), b)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, F.linear) = saved


# ── nflows' rational-quadratic spline ──────────────────────────────────


def _searchsorted(bin_locations, inputs, eps=1e-6):
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def rational_quadratic_spline(inputs, uw, uh, ud, inverse, left, right,
                              bottom, top):
    num_bins = uw.shape[-1]
    widths = F.softmax(uw, dim=-1)
    widths = MIN_BIN_WIDTH + (1 - MIN_BIN_WIDTH * num_bins) * widths
    cumwidths = F.pad(torch.cumsum(widths, dim=-1), pad=(1, 0), value=0.0)
    cumwidths = (right - left) * cumwidths + left
    cumwidths[..., 0] = left
    cumwidths[..., -1] = right
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    derivatives = MIN_DERIVATIVE + F.softplus(ud)
    heights = F.softmax(uh, dim=-1)
    heights = MIN_BIN_HEIGHT + (1 - MIN_BIN_HEIGHT * num_bins) * heights
    cumheights = F.pad(torch.cumsum(heights, dim=-1), pad=(1, 0), value=0.0)
    cumheights = (top - bottom) * cumheights + bottom
    cumheights[..., 0] = bottom
    cumheights[..., -1] = top
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    idx = _searchsorted(cumheights if inverse else cumwidths, inputs)[
        ..., None]
    in_cumwidths = cumwidths.gather(-1, idx)[..., 0]
    in_widths = widths.gather(-1, idx)[..., 0]
    in_cumheights = cumheights.gather(-1, idx)[..., 0]
    delta = heights / widths
    in_delta = delta.gather(-1, idx)[..., 0]
    in_d = derivatives.gather(-1, idx)[..., 0]
    in_d1 = derivatives[..., 1:].gather(-1, idx)[..., 0]
    in_heights = heights.gather(-1, idx)[..., 0]

    if inverse:
        dy = inputs - in_cumheights
        s = in_d + in_d1 - 2 * in_delta
        a = dy * s + in_heights * (in_delta - in_d)
        b = in_heights * in_d - dy * s
        c = -in_delta * dy
        root = (2 * c) / (-b - torch.sqrt(b.pow(2) - 4 * a * c))
        outputs = root * in_widths + in_cumwidths
        tt = root * (1 - root)
        denominator = in_delta + s * tt
        numerator = in_delta.pow(2) * (in_d1 * root.pow(2)
                                       + 2 * in_delta * tt
                                       + in_d * (1 - root).pow(2))
        return outputs, -(torch.log(numerator)
                          - 2 * torch.log(denominator))
    theta = (inputs - in_cumwidths) / in_widths
    tt = theta * (1 - theta)
    numerator = in_heights * (in_delta * theta.pow(2) + in_d * tt)
    denominator = in_delta + (in_d + in_d1 - 2 * in_delta) * tt
    outputs = in_cumheights + numerator / denominator
    d_num = in_delta.pow(2) * (in_d1 * theta.pow(2) + 2 * in_delta * tt
                               + in_d * (1 - theta).pow(2))
    return outputs, torch.log(d_num) - 2 * torch.log(denominator)


def unconstrained_rqs(inputs, uw, uh, ud, inverse, tail_bound):
    """nflows' unconstrained_rational_quadratic_spline, tails="linear":
    the identity outside [-B, B], the end derivatives softplus of
    log(e^{1-1e-3} − 1) + 1e-3."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    outputs = torch.zeros_like(inputs)
    logabsdet = torch.zeros_like(inputs)
    ud = F.pad(ud, pad=(1, 1))
    constant = float(np.log(np.exp(1 - MIN_DERIVATIVE) - 1))
    ud[..., 0] = constant
    ud[..., -1] = constant
    outputs[~inside] = inputs[~inside]
    if torch.any(inside):
        outputs[inside], logabsdet[inside] = rational_quadratic_spline(
            inputs[inside], uw[inside, :], uh[inside, :], ud[inside, :],
            inverse, -tail_bound, tail_bound, -tail_bound, tail_bound)
    return outputs, logabsdet


# ── nflows' modules ────────────────────────────────────────────────────


class ResidualBlock(nn.Module):
    def __init__(self, features, context_features, eps):
        super().__init__()
        self.bn = nn.ModuleList(nn.BatchNorm1d(features, eps=eps)
                                for _ in range(2))
        self.linear = nn.ModuleList(nn.Linear(features, features)
                                    for _ in range(2))
        self.context = (nn.Linear(context_features, features)
                        if context_features else None)

    def forward(self, inputs, context=None):
        temps = F.elu(self.bn[0](inputs))
        temps = self.linear[0](temps)
        temps = F.elu(self.bn[1](temps))
        temps = self.linear[1](temps)
        if context is not None:
            temps = F.glu(torch.cat((temps, self.context(context)), dim=1),
                          dim=1)
        return inputs + temps


class ResidualNet(nn.Module):
    def __init__(self, in_features, out_features, hidden, context_features,
                 blocks, eps):
        super().__init__()
        self.hidden_features = hidden
        self.initial = nn.Linear(in_features + context_features, hidden)
        self.blocks = nn.ModuleList(ResidualBlock(hidden, context_features,
                                                  eps) for _ in range(blocks))
        self.final = nn.Linear(hidden, out_features)

    def forward(self, inputs, context):
        temps = self.initial(torch.cat((inputs, context), dim=1))
        for block in self.blocks:
            temps = block(temps, context=context)
        return self.final(temps)


class LULinear(nn.Module):
    """RandomPermutation, then nflows' LULinear (bias included)."""

    def __init__(self, features):
        super().__init__()
        self.features = features
        n = features * (features - 1) // 2
        self.lower_entries = nn.Parameter(torch.zeros(n))
        self.upper_entries = nn.Parameter(torch.zeros(n))
        self.unconstrained_upper_diag = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("permutation", torch.arange(features))
        self.lower_indices = np.tril_indices(features, k=-1)
        self.upper_indices = np.triu_indices(features, k=1)
        self.diag_indices = np.diag_indices(features)

    def _lower_upper(self):
        lower = self.lower_entries.new_zeros(self.features, self.features)
        lower[self.lower_indices[0], self.lower_indices[1]] = \
            self.lower_entries
        lower[self.diag_indices[0], self.diag_indices[1]] = 1.0
        upper = self.upper_entries.new_zeros(self.features, self.features)
        upper[self.upper_indices[0], self.upper_indices[1]] = \
            self.upper_entries
        upper[self.diag_indices[0], self.diag_indices[1]] = self.upper_diag()
        return lower, upper

    def upper_diag(self):
        return F.softplus(self.unconstrained_upper_diag) + 1e-3

    def logabsdet(self):
        return torch.sum(torch.log(self.upper_diag()))

    def forward(self, inputs):
        inputs = torch.index_select(inputs, 1, self.permutation)
        lower, upper = self._lower_upper()
        outputs = F.linear(F.linear(inputs, upper), lower, self.bias)
        return outputs, self.logabsdet() * inputs.new_ones(inputs.shape[0])

    def inverse(self, inputs):
        lower, upper = self._lower_upper()
        outputs = (inputs - self.bias).t()
        outputs = torch.linalg.solve_triangular(lower, outputs, upper=False,
                                                unitriangular=True)
        outputs = torch.linalg.solve_triangular(upper, outputs, upper=True)
        outputs = outputs.t()
        outputs = torch.index_select(outputs, 1,
                                     torch.argsort(self.permutation))
        return outputs, -self.logabsdet() * inputs.new_ones(inputs.shape[0])


class CouplingStep(nn.Module):
    """PiecewiseRationalQuadraticCouplingTransform, tails="linear", with
    dingo's alternating mask (even steps transform 0, 2, ...)."""

    def __init__(self, features, step, context_features, hidden, blocks,
                 num_bins, tail_bound, eps):
        super().__init__()
        mask = torch.zeros(features, dtype=torch.uint8)
        mask[step % 2::2] += 1
        self.transform_features = torch.nonzero(mask > 0)[:, 0]
        self.identity_features = torch.nonzero(mask <= 0)[:, 0]
        self.num_bins, self.tail_bound = num_bins, tail_bound
        n_tr = len(self.transform_features)
        self.net = ResidualNet(features - n_tr, n_tr * (3 * num_bins - 1),
                               hidden, context_features, blocks, eps)

    def _transform(self, inputs, context, inverse):
        dev = inputs.device
        idn = self.identity_features.to(dev)
        tr = self.transform_features.to(dev)
        identity_split, transform_split = inputs[:, idn], inputs[:, tr]
        params = self.net(identity_split, context)
        params = params.reshape(inputs.shape[0], len(tr), -1)
        k = self.num_bins
        uw = params[..., :k] / np.sqrt(self.net.hidden_features)
        uh = params[..., k:2 * k] / np.sqrt(self.net.hidden_features)
        ud = params[..., 2 * k:]
        out, logabsdet = unconstrained_rqs(transform_split, uw, uh, ud,
                                           inverse, self.tail_bound)
        outputs = torch.empty_like(inputs)
        outputs[:, idn] = identity_split
        outputs[:, tr] = out
        return outputs, torch.sum(logabsdet, dim=1)

    def forward(self, inputs, context):
        return self._transform(inputs, context, False)

    def inverse(self, inputs, context):
        return self._transform(inputs, context, True)


class Flow(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        p = len(cfg["param_names"])
        self.features = p
        self.linears = nn.ModuleList(LULinear(p)
                                     for _ in range(cfg["flow_steps"] + 1))
        self.couplings = nn.ModuleList(
            CouplingStep(p, s, cfg["context_dim"], cfg["flow_hidden"],
                         cfg["flow_blocks"], cfg["flow_bins"],
                         cfg["tail_bound"], cfg["bn_eps"])
            for s in range(cfg["flow_steps"]))

    def _transforms(self):
        out = []
        for lin, cpl in zip(self.linears, self.couplings):
            out += [lin, cpl]
        return out + [self.linears[-1]]

    def forward(self, inputs, context):
        total = inputs.new_zeros(inputs.shape[0])
        for t in self._transforms():
            inputs, ld = (t(inputs) if isinstance(t, LULinear)
                          else t(inputs, context))
            total = total + ld
        return inputs, total

    def inverse(self, inputs, context):
        total = inputs.new_zeros(inputs.shape[0])
        for t in reversed(self._transforms()):
            inputs, ld = (t.inverse(inputs) if isinstance(t, LULinear)
                          else t.inverse(inputs, context))
            total = total + ld
        return inputs, total

    def log_base(self, z):
        return (-0.5 * torch.sum(z ** 2, dim=1)
                - 0.5 * self.features * math.log(2 * math.pi))


# ── dingo's embedding ──────────────────────────────────────────────────


class LinearProjectionRB(nn.Module):
    def __init__(self, n_det, n_freq, n_rb):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(3 * n_freq, 2 * n_rb)
                                    for _ in range(n_det))

    def forward(self, x):
        return torch.cat([layer(x[:, i, :, :].flatten(start_dim=1))
                          for i, layer in enumerate(self.layers)], dim=1)


class DenseResidualNet(nn.Module):
    def __init__(self, input_dim, output_dim, hidden_dims, eps):
        super().__init__()
        self.initial = nn.Linear(input_dim, hidden_dims[0])
        self.blocks = nn.ModuleList(ResidualBlock(h, 0, eps)
                                    for h in hidden_dims)
        self.resize = nn.ModuleList(
            nn.Linear(hidden_dims[n - 1], hidden_dims[n])
            if hidden_dims[n - 1] != hidden_dims[n] else nn.Identity()
            for n in range(1, len(hidden_dims)))
        self.final = nn.Linear(hidden_dims[-1], output_dim)

    def forward(self, x):
        x = self.initial(x)
        for block, resize in zip(self.blocks,
                                 list(self.resize) + [self.final]):
            x = resize(block(x))
        return x


class Embedding(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        n_det = len(cfg["detectors"])
        n_freq = int(round((cfg["f_max"] - cfg["f_min"]) / cfg["delta_f"])) + 1
        self.projection = LinearProjectionRB(n_det, n_freq, cfg["n_rb"])
        self.resnet = DenseResidualNet(2 * cfg["n_rb"] * n_det,
                                       cfg["context_dim"],
                                       cfg["resnet_widths"], cfg["bn_eps"])

    def forward(self, x):
        return self.resnet(self.projection(x))


class Dingo(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        cfg = config["dingo"]
        self.embedding = Embedding(cfg)
        self.flow = Flow(cfg)
        self.register_buffer("mean", torch.tensor(cfg["param_mean"]),
                             persistent=False)
        self.register_buffer("std", torch.tensor(cfg["param_std"]),
                             persistent=False)


def build(config: dict, state_dict: dict, device) -> Dingo:
    """The reference of a configuration's `config`, holding state_dict."""
    model = Dingo(config)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


@torch.no_grad()
def sample(model: Dingo, strain, z: torch.Tensor, block: int = 50000,
           allow_tf32: bool = False):
    """Strain [B, D, 3, n_f] and base draws z [B, n, P] -> (physical draws
    [B, n, P], relabelled m1 >= m2 as InferenceEngine serves them, log q in
    physical units [B, n]), `block` draws of an event at a time."""
    dev = z.device
    with tf32(allow_tf32):
        x = torch.as_tensor(strain, dtype=torch.float32, device=dev)
        context = model.embedding(x)
        thetas, log_qs = [], []
        for e in range(z.shape[0]):
            t_e, q_e = [], []
            for s in range(0, z.shape[1], block):
                noise = z[e, s:s + block]
                ctx = context[e:e + 1].repeat(noise.shape[0], 1)
                y, logabsdet = model.flow.inverse(noise, ctx)
                t_e.append(y * model.std + model.mean)
                q_e.append(model.flow.log_base(noise) - logabsdet
                           - torch.sum(torch.log(model.std)))
            thetas.append(torch.cat(t_e))
            log_qs.append(torch.cat(q_e))
    theta, log_q = torch.stack(thetas), torch.stack(log_qs)
    m1 = torch.maximum(theta[..., 0], theta[..., 1])
    m2 = torch.minimum(theta[..., 0], theta[..., 1])
    return torch.cat([m1[..., None], m2[..., None], theta[..., 2:]],
                     dim=-1), log_q


@torch.no_grad()
def log_prob(model: Dingo, strain, theta: torch.Tensor) -> torch.Tensor:
    """log q of physical θ [B, P] given each row's strain [B, D, 3, n_f],
    in the standardised parameters (as DingoNPE.nll_from_context)."""
    with tf32(False):
        context = model.embedding(torch.as_tensor(strain,
                                                  dtype=torch.float32))
        y = (theta - model.mean) / model.std
        z, logabsdet = model.flow.forward(y, context)
        return model.flow.log_base(z) + logabsdet


def draw_gaps(std: torch.Tensor, theta_p, theta_r, logq_p,
              logq_r) -> Dict[str, float]:
    """The gaps between served draws and the reference's from the same
    inputs, read by event_quantiles: `draw_gap`, a draw's widest gap over
    its parameters in units of the parameter's σ, and `logq_gap`, |Δ log
    q| over the reference's |log q| or 1, whichever is larger."""
    dev = theta_r.device
    d = torch.abs(torch.as_tensor(theta_p, device=dev).float()
                  - theta_r.float()) / std.to(dev)
    lp = torch.as_tensor(logq_p, device=dev).float()
    dq = torch.abs(lp - logq_r) / torch.clamp(torch.abs(logq_r), min=1.0)
    return {**event_quantiles("draw_gap", torch.amax(d, dim=-1)),
            **event_quantiles("logq_gap", dq)}
