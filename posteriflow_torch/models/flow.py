"""Conditional coupling-layer rational-quadratic-spline flow (torch).

Port of posteriflow_tpu/models/flow.py:33-172. Each layer: fixed
permutation -> split into identity and transform halves -> conditioner MLP
(identity half + context) emits raw spline parameters -> RQS bijection on
the transform half. The spline goes through ops/rqs_cuda.py, which runs the
CUDA kernel on CUDA tensors and the plain version on CPU tensors; the
conditioner's derivative bias is handed to it rather than added to the raw
parameters first, so that the kernel adds it as it reads them.

Module names follow the flax tree (`cond_{i}` with `in_x`, `in_ctx`,
`mid_{i}`, `out`) so that released weights load one to one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posteriflow_torch.ops import rqs_cuda
from posteriflow_torch.ops.rqs import DEFAULT_MIN_DERIVATIVE
from posteriflow_torch.utils.precision import fp32_exact

# derivative-channel init bias: min_derivative + softplus(b) = 1 exactly
_DERIV_BIAS = float(np.log(np.expm1(1.0 - DEFAULT_MIN_DERIVATIVE)))

# float64 is a reference precision for checks (a model moved there with
# .double() runs on the CPU, where the spline is the plain version)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def make_permutations(features: int, num_layers: int,
                      seed: int = 1234) -> np.ndarray:
    """[L, D] deterministic permutations, one per layer (the JAX package's
    numpy stream: np.random.default_rng(1234))."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(features)
                     for _ in range(num_layers)]).astype(np.int64)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """flax Dense(dtype=...): input, kernel and bias cast to `dtype`, the
    product rounded to `dtype`, then the bias added in `dtype`."""
    return (F.linear(x.to(dtype), layer.weight.to(dtype))
            + layer.bias.to(dtype))


def in_dtype(c: float, dtype: torch.dtype) -> float:
    """The constant `c` rounded to `dtype`, as JAX casts a Python scalar to
    the array's dtype before an operation."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax nn.gelu, the tanh approximation, written out as jax.nn.gelu
    computes it: op by op in x's dtype, with constants rounded to that
    dtype. In bfloat16 this rounds where JAX rounds; F.gelu rounds once and
    differs from JAX in the last bit of about 40% of bf16 outputs."""
    c1 = in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    c2 = in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * x * x)))))


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
        3K-1]; the spline kernel adds `deriv_bias` as it reads them."""
        dt = self.compute_dtype
        h = gelu(dense(self.in_x, x_id, dt) + dense(self.in_ctx, context, dt))
        for i in range(self.n_mid):
            h = gelu(dense(getattr(self, f"mid_{i}"), h, dt))
        out = F.linear(h.to(self.out.weight.dtype), self.out.weight,
                       self.out.bias)
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
        z_tr, ld = rqs_cuda.rqs_forward(y_tr, cond.project(y_id, context),
                                        self.num_bins, self.tail_bound,
                                        bias=cond.deriv_bias)
        return torch.cat([y_id, z_tr], dim=-1), ld

    def _layer_inverse(self, i: int, z: torch.Tensor, context: torch.Tensor):
        z_id, z_tr = z[..., :self.n_id], z[..., self.n_id:]
        cond = self._cond(i)
        y_tr, ld = rqs_cuda.rqs_inverse(z_tr, cond.project(z_id, context),
                                        self.num_bins, self.tail_bound,
                                        bias=cond.deriv_bias)
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
        z, ld = self.forward(y, context)
        return self._log_base(z) + ld

    def sample_with_log_prob(self, z: torch.Tensor, context: torch.Tensor):
        """Push base draws z through the inverse -> (y, log q(y)); non-finite
        outputs are set to 0."""
        y, ld = self.inverse(z, context)
        y = torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
        return y, self._log_base(z) - ld
