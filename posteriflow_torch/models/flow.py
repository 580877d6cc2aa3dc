"""Conditional coupling-layer rational-quadratic-spline flow (torch).

Port of posteriflow_tpu/models/flow.py:33-172. Each layer: fixed
permutation -> split into identity and transform halves -> conditioner MLP
(identity half + context) emits raw spline parameters -> RQS bijection on
the transform half. The spline goes through ops/rqs_cuda.py, which runs the
CUDA kernel on CUDA tensors and the plain version on CPU tensors; the
conditioner's derivative bias is handed to it rather than added to the raw
parameters first, so that the kernel adds it as it reads them. Each hidden
layer's bias, context add and GELU go through ops/conditioner_cuda.py, one
kernel pass on the card where no gradient is needed, the eager ops
otherwise, with the same bits.

Module names follow the flax tree (`cond_{i}` with `in_x`, `in_ctx`,
`mid_{i}`, `out`) so that released weights load one to one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posteriflow_torch.ops import conditioner_cuda, rqs_cuda
from posteriflow_torch.ops.rqs import DEFAULT_MIN_DERIVATIVE
from posteriflow_torch.utils.logging import count, span
from posteriflow_torch.utils.precision import DTYPES, dense, fp32_exact

# derivative-channel init bias: min_derivative + softplus(b) = 1 exactly
_DERIV_BIAS = float(np.log(np.expm1(1.0 - DEFAULT_MIN_DERIVATIVE)))


def make_permutations(features: int, num_layers: int,
                      seed: int = 1234) -> np.ndarray:
    """[L, D] deterministic permutations, one per layer (the JAX package's
    numpy stream: np.random.default_rng(1234))."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(features)
                     for _ in range(num_layers)]).astype(np.int64)


class Conditioner(nn.Module):
    """MLP (identity half + context) -> raw RQS params [..., n_transform,
    3K-1]. Hidden matmuls run in `compute_dtype`; the output projection
    runs in its weights' dtype (float32: its output feeds the float32
    spline).

    The context has its own first-layer projection, broadcast-added to the
    x projection, so a context of shape [B, 1, C] against x [B, n, D] is
    projected once per event rather than once per draw."""

    def __init__(self, n_id: int, context_features: int, n_transform: int,
                 num_bins: int, hidden: int = 256, n_hidden_layers: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_transform = n_transform
        self.num_bins = num_bins
        self.compute_dtype = compute_dtype
        self.in_x = nn.Linear(n_id, hidden)
        self.in_ctx = nn.Linear(context_features, hidden)
        self.n_mid = n_hidden_layers - 1
        for i in range(self.n_mid):
            self.add_module(f"mid_{i}", nn.Linear(hidden, hidden))
        n_raw = 3 * num_bins - 1
        self.out = nn.Linear(hidden, n_transform * n_raw)
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)
        deriv_bias = torch.zeros(n_raw)
        deriv_bias[2 * num_bins:] = _DERIV_BIAS
        self.register_buffer("deriv_bias", deriv_bias, persistent=False)

    def project(self, x_id: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """The raw parameters before the derivative bias [..., n_transform,
        3K-1]; the spline kernel adds `deriv_bias` as it reads them. Each
        hidden layer is gelu(dense(...)) as `dense` and `gelu` round, its
        tail (bias, context, GELU, and the last layer's cast to the output
        projection's dtype) one `conditioner_cuda.bias_gelu` call; counts
        conditioner_fused or conditioner_eager by the way it takes."""
        dt = self.compute_dtype
        last = self.out.weight.dtype
        p = F.linear(x_id.to(dt), self.in_x.weight.to(dt))
        b = self.in_x.bias.to(dt)
        q = dense(self.in_ctx, context, dt)
        count("conditioner_fused" if conditioner_cuda.kernel_takes(p, b, q)
              else "conditioner_eager")
        h = conditioner_cuda.bias_gelu(p, b, q, last if not self.n_mid
                                       else dt)
        for i in range(self.n_mid):
            layer = getattr(self, f"mid_{i}")
            h = conditioner_cuda.bias_gelu(
                F.linear(h, layer.weight.to(dt)), layer.bias.to(dt),
                out_dtype=last if i == self.n_mid - 1 else dt)
        out = F.linear(h, self.out.weight, self.out.bias)
        return out.reshape(*out.shape[:-1], self.n_transform, -1)

    def forward(self, x_id: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        return self.project(x_id, context) + self.deriv_bias


class CouplingNSF(nn.Module):
    """Conditional normalizing flow: data y ∈ [-1, 1]^D <-> base z ~ N(0, I).

    forward : y -> (z, logdet dz/dy)   density evaluation / NLL
    inverse : z -> (y, logdet dy/dz)   sampling
    """

    def __init__(self, features: int = 11, context_features: int = 288,
                 num_layers: int = 10, hidden: int = 256, num_bins: int = 16,
                 tail_bound: float = 5.0, compute_dtype: str = "bfloat16"):
        super().__init__()
        self.features = features
        self.num_layers = num_layers
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.n_id = features // 2 + features % 2          # ⌈D/2⌉
        perms = make_permutations(features, num_layers)
        for i, p in enumerate(perms):
            self.register_buffer(f"perm_{i}", torch.from_numpy(p),
                                 persistent=False)
            self.register_buffer(f"inv_perm_{i}",
                                 torch.from_numpy(np.argsort(p)),
                                 persistent=False)
        for i in range(num_layers):
            self.add_module(f"cond_{i}", Conditioner(
                self.n_id, context_features, features - self.n_id, num_bins,
                hidden, compute_dtype=DTYPES[compute_dtype]))

    def _cond(self, i: int) -> Conditioner:
        return getattr(self, f"cond_{i}")

    def _layer_forward(self, i: int, y: torch.Tensor, context: torch.Tensor):
        y = y[..., getattr(self, f"perm_{i}")]
        y_id, y_tr = y[..., :self.n_id], y[..., self.n_id:]
        cond = self._cond(i)
        with span("pf.flow.conditioner"):
            raw = cond.project(y_id, context)
        z_tr, ld = rqs_cuda.rqs_forward(y_tr, raw, self.num_bins,
                                        self.tail_bound, bias=cond.deriv_bias)
        return torch.cat([y_id, z_tr], dim=-1), ld

    def _layer_inverse(self, i: int, z: torch.Tensor, context: torch.Tensor):
        z_id, z_tr = z[..., :self.n_id], z[..., self.n_id:]
        cond = self._cond(i)
        with span("pf.flow.conditioner"):
            raw = cond.project(z_id, context)
        y_tr, ld = rqs_cuda.rqs_inverse(z_tr, raw, self.num_bins,
                                        self.tail_bound, bias=cond.deriv_bias)
        y = torch.cat([z_id, y_tr], dim=-1)
        return y[..., getattr(self, f"inv_perm_{i}")], ld

    def forward(self, y: torch.Tensor, context: torch.Tensor):
        """y [..., D], context [..., C] -> (z, logdet [...])."""
        ld_total = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
        with fp32_exact():               # the float32 output projections
            for i in range(self.num_layers):
                y, ld = self._layer_forward(i, y, context)
                ld_total = ld_total + ld
        return y, ld_total

    def inverse(self, z: torch.Tensor, context: torch.Tensor):
        """z [..., D], context [..., C] -> (y, logdet [...])."""
        ld_total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        with fp32_exact():
            for i in reversed(range(self.num_layers)):
                z, ld = self._layer_inverse(i, z, context)
                ld_total = ld_total + ld
        return z, ld_total

    def _log_base(self, z: torch.Tensor) -> torch.Tensor:
        return (-0.5 * torch.sum(z ** 2, dim=-1)
                - 0.5 * self.features * math.log(2.0 * math.pi))

    def log_prob(self, y: torch.Tensor, context: torch.Tensor):
        """log q(y | context) under the standard-normal base."""
        with span("pf.flow.log_prob"):
            z, ld = self.forward(y, context)
            return self._log_base(z) + ld

    def sample_with_log_prob(self, z: torch.Tensor, context: torch.Tensor):
        """Push base draws z through the inverse -> (y, log q(y)); non-finite
        outputs are set to 0."""
        with span("pf.flow.sample"):
            y, ld = self.inverse(z, context)
            y = torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
            return y, self._log_base(z) - ld
