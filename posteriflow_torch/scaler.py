"""Fixed, invertible map physical parameters <-> [-1, 1] (torch).

Port of posteriflow_tpu/scaler.py:24-134: log space for masses and
distance, linear for angles, time and spins, and an exact modular wrap for
the circular parameters, whose normalized range is one full period. The
bounds are constants; arithmetic is float32 on the input's device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from posteriflow_torch import PARAM_NAMES

# (lo, hi, log-space?) covering the generation priors with margin
RANGES = {
    "mass_1":              (1.0, 105.0, True),
    "mass_2":              (1.0, 105.0, True),
    "luminosity_distance": (40.0, 2200.0, True),
    "ra":                  (0.0, 2 * math.pi, False),
    "dec":                 (-math.pi / 2, math.pi / 2, False),
    "theta_jn":            (0.0, math.pi, False),
    "psi":                 (0.0, math.pi, False),
    "phase":               (0.0, 2 * math.pi, False),
    "geocent_time":        (-1.6, 1.6, False),
    "a1":                  (0.0, 1.0, False),
    "a2":                  (0.0, 1.0, False),
    "tilt_1":              (0.0, math.pi, False),
    "tilt_2":              (0.0, math.pi, False),
    "phi_12":              (0.0, 2 * math.pi, False),
    "phi_jl":              (0.0, 2 * math.pi, False),
}

# Parameters whose normalized range spans exactly one period: an
# out-of-range flow sample re-enters modulo the period instead of being
# clamped onto the boundary.
CIRCULAR = ("ra", "phase", "psi", "phi_12", "phi_jl")

# Pre-merger (early-warning) geocent_time range.
PREMERGER_TIME_RANGE = (-1.6, 5.2)


class ParamScaler:
    """Per-parameter bounds; every method works on [..., P] tensors.

    lo, hi     — [P] bounds in scaler space (log space for log params)
    log_mask   — True where the map is log-linear
    circ_mask  — True where the modular wrap applies
    """

    def __init__(self, param_names: Sequence[str] = PARAM_NAMES,
                 premerger: bool = False):
        self.param_names = tuple(param_names)
        self.premerger = bool(premerger)
        lo, hi, lg, ci = [], [], [], []
        for p in self.param_names:
            l, h, g = RANGES[p]
            if p == "geocent_time" and premerger:
                l, h = PREMERGER_TIME_RANGE
            lo.append(math.log(l) if g else l)
            hi.append(math.log(h) if g else h)
            lg.append(g)
            ci.append(p in CIRCULAR)
        self.lo = torch.tensor(lo, dtype=torch.float32)
        self.hi = torch.tensor(hi, dtype=torch.float32)
        self.log_mask = torch.tensor(lg, dtype=torch.bool)
        self.circ_mask = torch.tensor(ci, dtype=torch.bool)
        self._on_device = {}

    def _consts(self, device):
        """(lo, hi, log_mask, circ_mask) on `device`, copied once."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                t.to(device) for t in (self.lo, self.hi, self.log_mask,
                                       self.circ_mask))
        return self._on_device[key]

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """physical [..., P] -> [-1, 1]."""
        lo, hi, lg, _ = self._consts(x.device)
        xs = torch.where(lg, torch.log(torch.clamp(x, min=1e-6)), x)
        y = 2.0 * (xs - lo) / (hi - lo) - 1.0
        return torch.clamp(y, -1.0, 1.0)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        """[-1, 1] -> physical [..., P]."""
        lo, hi, lg, _ = self._consts(y.device)
        xs = (torch.clamp(y, -1.0, 1.0) + 1.0) / 2.0 * (hi - lo) + lo
        return torch.where(lg, torch.exp(xs), xs)

    def wrap(self, y: torch.Tensor) -> torch.Tensor:
        """Raw flow output -> [-1, 1]: exact modular wrap for circular
        parameters (floor-mod, as jnp.mod), clamp for bounded ones."""
        _, _, _, ci = self._consts(y.device)
        wrapped = torch.remainder(y + 1.0, 2.0) - 1.0
        return torch.where(ci, wrapped, torch.clamp(y, -1.0, 1.0))

    def log_abs_det_jacobian(self, x_phys: torch.Tensor) -> torch.Tensor:
        """log |d normalize(x) / dx| summed over params at physical x:
        linear -> 2/(hi-lo); log -> 2/((hi-lo)·x)."""
        lo, hi, lg, _ = self._consts(x_phys.device)
        base = math.log(2.0) - torch.log(hi - lo)
        extra = torch.where(lg, -torch.log(torch.clamp(x_phys, min=1e-6)),
                            torch.zeros((), device=x_phys.device))
        return torch.sum(base + extra, dim=-1)

    def railing_mask(self, y: torch.Tensor,
                     thresh: float = 0.999) -> torch.Tensor:
        """True where a non-circular dim sits at the normalized boundary
        (the spurious-railing indicator)."""
        _, _, _, ci = self._consts(y.device)
        railed = torch.abs(y) > thresh
        return torch.any(railed & ~ci, dim=-1)
