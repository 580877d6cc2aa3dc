"""DINGO's posterior flow (Dax et al., PRL 127, 241103 (2021)): nflows'
rational-quadratic coupling flow as dingo builds it
(dingo/core/nn/nsf.py create_transform), in float32.

Each of the `steps` steps is a fixed permutation, an `LULinear` and a
coupling transform; one more permutation and `LULinear` close the flow. A
coupling transforms the features its mask names, alternately the even
(0, 2, ...) and the odd (1, 3, ...) ones, by a rational-quadratic spline
with linear tails at `tail_bound`, whose parameters a `ResidualNet` (nflows'
residual conditioner with batch norm, ELU and context gates) computes from
the other features and the context. The spline runs through
ops/rqs_cuda.py: the CUDA kernel on CUDA tensors, the plain version on CPU
tensors.

The state dict follows nflows' parametrisation (LU entries, unconstrained
diagonal, batch-norm running statistics); pfbench/reference/dingo.py, the
plain reference, loads the same. Where the port departs from nflows' order
of operations it computes the same function:
- the conditioner's first layer on [x_id ∥ c] is split into its x and c
  columns, so that the context's part is computed once an event and
  broadcast over its draws;
- nflows divides the width and height logits by √hidden after the last
  layer; here that layer's width and height rows and biases are scaled
  before the product, so no pass over the [rows, n·(3K-1)] output is
  added;
- the context gate σ(Lin_c(c)) is computed once an event.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posteriflow_torch.ops import rqs_cuda
from posteriflow_torch.utils.logging import span

LU_EPS = 1e-3          # nflows LULinear: diag U = softplus(u) + eps


def batch_norm(bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
    """Eval-mode batch norm of h [..., C] with bn's running statistics."""
    c = h.shape[-1]
    out = F.batch_norm(h.reshape(-1, c), bn.running_mean, bn.running_var,
                       bn.weight, bn.bias, False, 0.0, bn.eps)
    return out.view(h.shape)


class ResidualBlock(nn.Module):
    """nflows' ResidualBlock with batch norm and ELU, dropout 0:
    h + t, t = Lin₁(ELU(BN₁(Lin₀(ELU(BN₀(h)))))), with the context gate
    t ⊙ σ(Lin_c(c)) where the block has a context."""

    def __init__(self, features: int, context_features: int = 0,
                 eps: float = 1e-3):
        super().__init__()
        self.bn = nn.ModuleList(nn.BatchNorm1d(features, eps=eps)
                                for _ in range(2))
        self.linear = nn.ModuleList(nn.Linear(features, features)
                                    for _ in range(2))
        self.context = (nn.Linear(context_features, features)
                        if context_features else None)

    def forward(self, h: torch.Tensor, gate: torch.Tensor = None):
        """h [..., C]; gate σ(Lin_c(c)) broadcast against h, or None."""
        t = F.elu(batch_norm(self.bn[0], h), inplace=True)
        t = F.linear(t, self.linear[0].weight, self.linear[0].bias)
        t = F.elu(batch_norm(self.bn[1], t), inplace=True)
        t = F.linear(t, self.linear[1].weight, self.linear[1].bias)
        if gate is None:
            return h + t
        return torch.addcmul(h, t, gate)

    def gate(self, context: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(F.linear(context, self.context.weight,
                                      self.context.bias))


class ResidualNet(nn.Module):
    """nflows' ResidualNet(x_id, c): Lin_init([x_id ∥ c]) into `hidden`,
    `blocks` context-gated residual blocks, Lin_out into n_tr·(3K-1) raw
    spline parameters [..., n_tr, 3K-1], the width and height logits
    divided by √hidden as nflows' coupling transform divides them."""

    def __init__(self, n_id: int, context_features: int, n_tr: int,
                 num_bins: int, hidden: int, blocks: int, eps: float):
        super().__init__()
        self.n_id, self.n_tr = n_id, n_tr
        self.initial = nn.Linear(n_id + context_features, hidden)
        self.blocks = nn.ModuleList(ResidualBlock(hidden, context_features,
                                                  eps) for _ in range(blocks))
        n_raw = 3 * num_bins - 1
        self.final = nn.Linear(hidden, n_tr * n_raw)
        scale = torch.ones(n_raw)
        scale[:2 * num_bins] = 1.0 / math.sqrt(hidden)
        self.register_buffer("row_scale", scale.repeat(n_tr),
                             persistent=False)

    def forward(self, x_id: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """x_id [..., n_id], context [..., C] broadcast against it (one
        row an event: [B, 1, C] against [B, n, n_id])."""
        w = self.initial.weight
        h = (F.linear(x_id, w[:, :self.n_id])
             + F.linear(context, w[:, self.n_id:], self.initial.bias))
        for blk in self.blocks:
            h = blk(h, blk.gate(context))
        s = self.row_scale
        raw = F.linear(h, self.final.weight * s[:, None],
                       self.final.bias * s)
        return raw.view(*raw.shape[:-1], self.n_tr, -1)


class LULinear(nn.Module):
    """nflows' LULinear: y = x (L·U)ᵀ + b with L unit lower-triangular and
    U upper-triangular, diag U = softplus(u) + 1e-3; log|det| = Σ log
    diag U. The inverse is two triangular solves. Preceded here by the
    step's fixed permutation (nflows' RandomPermutation), which moves no
    density."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        n_tri = features * (features - 1) // 2
        self.lower_entries = nn.Parameter(torch.zeros(n_tri))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri))
        self.unconstrained_upper_diag = nn.Parameter(torch.full(
            (features,), float(np.log(np.expm1(1.0 - LU_EPS)))))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("permutation", torch.arange(features))
        # np.tril_indices / np.triu_indices order, as nflows fills them
        self.register_buffer("lower_idx", torch.tril_indices(
            features, features, -1), persistent=False)
        self.register_buffer("upper_idx", torch.triu_indices(
            features, features, 1), persistent=False)

    def upper_diag(self) -> torch.Tensor:
        return F.softplus(self.unconstrained_upper_diag) + LU_EPS

    def factors(self):
        """(L, U) [D, D]."""
        d = self.features
        eye = torch.eye(d, dtype=self.bias.dtype, device=self.bias.device)
        lower = eye.index_put(tuple(self.lower_idx), self.lower_entries)
        upper = torch.diag(self.upper_diag()).index_put(
            tuple(self.upper_idx), self.upper_entries)
        return lower, upper

    def logabsdet(self) -> torch.Tensor:
        return torch.sum(torch.log(self.upper_diag()))

    def forward(self, x: torch.Tensor):
        """x [..., D] -> (permuted then x (LU)ᵀ + b, log|det| scalar)."""
        lower, upper = self.factors()
        x = x[..., self.permutation]
        return F.linear(F.linear(x, upper), lower, self.bias), \
            self.logabsdet()

    def inverse(self, y: torch.Tensor):
        """y [..., D] -> (the forward's preimage, −log|det| scalar)."""
        lower, upper = self.factors()
        rows = (y - self.bias).reshape(-1, self.features)
        v = torch.linalg.solve_triangular(lower.T, rows, upper=True,
                                          left=False, unitriangular=True)
        x = torch.linalg.solve_triangular(upper.T, v, upper=False,
                                          left=False)
        x = x.view(y.shape)[..., torch.argsort(self.permutation)]
        return x, -self.logabsdet()


def coupling_mask(features: int, step: int):
    """(transformed, identity) feature indices of a step: nflows'
    create_alternating_binary_mask(features, even=(step % 2 == 0)) marks
    0, 2, ... on even steps and 1, 3, ... on odd steps for the spline."""
    tr = np.arange(step % 2, features, 2)
    return tr, np.setdiff1d(np.arange(features), tr)


class CouplingStep(nn.Module):
    """One coupling transform: the spline on the mask's features with
    parameters from a ResidualNet of the other features and the context."""

    def __init__(self, features: int, step: int, context_features: int,
                 hidden: int, blocks: int, num_bins: int, tail_bound: float,
                 eps: float):
        super().__init__()
        tr, idn = coupling_mask(features, step)
        self.num_bins, self.tail_bound = num_bins, tail_bound
        self.register_buffer("tr_idx", torch.from_numpy(tr),
                             persistent=False)
        self.register_buffer("id_idx", torch.from_numpy(idn),
                             persistent=False)
        self.net = ResidualNet(len(idn), context_features, len(tr), num_bins,
                               hidden, blocks, eps)

    def _run(self, x: torch.Tensor, context: torch.Tensor, inverse: bool):
        with span("pf.flow.conditioner"):
            raw = self.net(x[..., self.id_idx], context)
        fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward
        out, ld = fn(x[..., self.tr_idx], raw, self.num_bins,
                     self.tail_bound)
        return x.index_copy(-1, self.tr_idx, out), ld

    def forward(self, x, context):
        return self._run(x, context, inverse=False)

    def inverse(self, y, context):
        return self._run(y, context, inverse=True)


class DingoFlow(nn.Module):
    """The flow over `features` standardised parameters: forward maps data
    y to the base z with log|det ∂z/∂y|, inverse maps z to y with
    log|det ∂y/∂z|; under the standard-normal base."""

    def __init__(self, features: int, context_features: int, steps: int,
                 hidden: int, blocks: int, num_bins: int, tail_bound: float,
                 eps: float):
        super().__init__()
        self.features = features
        self.linears = nn.ModuleList(LULinear(features)
                                     for _ in range(steps + 1))
        self.couplings = nn.ModuleList(
            CouplingStep(features, s, context_features, hidden, blocks,
                         num_bins, tail_bound, eps) for s in range(steps))

    def _linear(self, i: int, x: torch.Tensor, inverse: bool):
        with span("pf.flow.linear"):
            lin = self.linears[i]
            return lin.inverse(x) if inverse else lin(x)

    def forward(self, y: torch.Tensor, context: torch.Tensor):
        """y [..., D], context broadcast against y's rows -> (z, logdet
        [...])."""
        total = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
        for i, cpl in enumerate(self.couplings):
            y, ld = self._linear(i, y, inverse=False)
            total = total + ld
            y, ld = cpl(y, context)
            total = total + ld
        y, ld = self._linear(len(self.couplings), y, inverse=False)
        return y, total + ld

    def inverse(self, z: torch.Tensor, context: torch.Tensor):
        """z [..., D] -> (y, logdet [...]), the steps in reverse."""
        total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        z, ld = self._linear(len(self.couplings), z, inverse=True)
        total = total + ld
        for i in reversed(range(len(self.couplings))):
            z, ld = self.couplings[i].inverse(z, context)
            total = total + ld
            z, ld = self._linear(i, z, inverse=True)
            total = total + ld
        return z, total

    def log_base(self, z: torch.Tensor) -> torch.Tensor:
        return (-0.5 * torch.sum(z ** 2, dim=-1)
                - 0.5 * self.features * math.log(2.0 * math.pi))

    def log_prob(self, y: torch.Tensor, context: torch.Tensor):
        with span("pf.flow.log_prob"):
            z, ld = self.forward(y, context)
            return self.log_base(z) + ld

    def sample_with_log_prob(self, z: torch.Tensor, context: torch.Tensor):
        """Base draws z -> (y, log q(y)) = (f⁻¹(z), log N(z) − log|det
        ∂y/∂z|), as nflows' Flow.sample_and_log_prob."""
        with span("pf.flow.sample"):
            y, ld = self.inverse(z, context)
            return y, self.log_base(z) - ld
