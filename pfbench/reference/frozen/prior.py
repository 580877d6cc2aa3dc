"""Astrophysical parameter priors: batched sampling from a torch.Generator.

Port of posteriflow_tpu/prior.py. The sampling half (:49-213, :323): the
event mix BBH / BNS / NSBH by `type_probs`, per-type mass boxes
(log-uniform BH masses, uniform NS masses), P(d) ∝ d² or uniform distance,
isotropic sky and inclination, uniform psi, phase and time offset, aligned
spin magnitudes per type, isotropic tilts and uniform azimuths for the
15-D set, the overlap count and the pre-merger conversion. All three type
candidates are computed and one is selected, as in the JAX package. The
JAX and torch random streams differ, so the two are held to each other by
distribution only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from pfbench.reference.frozen import PARAM_NAMES
from pfbench.reference.frozen.physics.constants import DURATION
from pfbench.reference.frozen.utils.constants import device_constant

BBH, BNS, NSBH = 0, 1, 2
EVENT_TYPES = ("BBH", "BNS", "NSBH")

# Per-type bounds, indexed by event-type code
_MASS_LO = (5.0, 1.0, 3.0)       # BBH lo, BNS lo, NSBH BH lo
_MASS_HI = (100.0, 2.5, 100.0)
_M2_LO = (5.0, 1.0, 1.0)         # secondary lower bound (NSBH NS: 1.0)
_M2_HI = (100.0, 2.5, 2.5)       # secondary upper bound  (NSBH NS: 2.5)
_DIST_LO = (50.0, 10.0, 20.0)
_DIST_HI = (2000.0, 300.0, 800.0)
_SPIN1_HI = (0.99, 0.05, 0.99)   # primary spin (NSBH primary = BH)
_SPIN2_HI = (0.99, 0.05, 0.05)   # secondary spin (NSBH secondary = NS)

_T_OFF_LO, _T_OFF_HI = -1.5, 1.5
_TABLE_NAMES = ("mass_lo", "mass_hi", "m2_lo", "m2_hi", "dist_lo",
                "dist_hi", "spin1_hi", "spin2_hi")
_TABLES = (_MASS_LO, _MASS_HI, _M2_LO, _M2_HI, _DIST_LO, _DIST_HI,
           _SPIN1_HI, _SPIN2_HI)

IDX = {name: i for i, name in enumerate(PARAM_NAMES)}


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Static prior configuration (the `sim.prior` part of a release's
    meta.json)."""
    type_probs: tuple = (0.55 / 0.95, 0.20 / 0.95, 0.20 / 0.95)
    distance_prior: str = "comoving_d2"        # or "uniform"
    max_signals: int = 5
    overlap_fraction: float = 0.45
    noise_fraction: float = 0.05
    # draw events ∝ Mc^alpha through a tilted log-m1 proposal (0 = off)
    mc_oversample: float = 0.0
    # probability that a single-signal event's merger is pushed past the
    # window end by time_to_merger ~ U(range), distance redrawn nearby
    premerger_fraction: float = 0.0
    premerger_ttm_range: tuple = (0.5, 3.0)
    premerger_distance_range: tuple = (50.0, 400.0)
    # the 15-D precessing set: isotropic tilts, uniform phi_12 and phi_jl
    precessing: bool = False

    @property
    def n_params(self) -> int:
        return 15 if self.precessing else 11


def _rand(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device)


def _uniform(lo, hi, shape, generator, device):
    return lo + _rand(shape, generator, device) * (hi - lo)


def sample_signal_params(shape, cfg: PriorConfig = PriorConfig(),
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> torch.Tensor:
    """Independent signals -> [*shape, n_params] float32 physical
    parameters (PARAM_NAMES order, then the precession block)."""
    shape = tuple(shape)

    def u01():
        return _rand(shape, generator, device)

    def cumulative():
        probs = torch.tensor(cfg.type_probs, dtype=torch.float32)
        return torch.cumsum(probs / probs.sum(), 0)[:-1]

    cum = device_constant(("type_cdf", cfg.type_probs), device, cumulative)
    et = (u01()[..., None] >= cum).sum(-1)                 # categorical
    tables = device_constant("type_tables", device, lambda: torch.tensor(
        _TABLES, dtype=torch.float32))[:, et]

    def pick(table):
        return tables[_TABLE_NAMES.index(table)]

    m_lo, m_hi = pick("mass_lo"), pick("mass_hi")
    m2_lo, m2_hi = pick("m2_lo"), pick("m2_hi")

    # primary: log-uniform for BBH/NSBH, uniform for BNS; mc_oversample
    # tilts the log-m1 proposal ∝ m1^alpha by inverse CDF
    u1 = u01()
    if cfg.mc_oversample > 0.0:
        a = cfg.mc_oversample
        span = torch.log(m_hi) - torch.log(m_lo)
        u1 = torch.log1p(u1 * torch.expm1(a * span)) / (a * span)
    m1_log = torch.exp(torch.log(m_lo) + u1 * (torch.log(m_hi)
                                               - torch.log(m_lo)))
    m1_lin = m_lo + u1 * (m_hi - m_lo)
    m1 = torch.where(et == BNS, m1_lin, m1_log)

    # secondary: BBH log-uniform on [lo, m1]; BNS uniform on [lo, m1]; NSBH
    # uniform on the NS box; then m1 >= m2
    u2 = u01()
    m2_bbh = torch.exp(torch.log(m_lo) + u2 * (torch.log(m1)
                                               - torch.log(m_lo)))
    m2_bns = m2_lo + u2 * (m1 - m2_lo)
    m2_nsbh = m2_lo + u2 * (m2_hi - m2_lo)
    m2 = torch.where(et == BBH, m2_bbh,
                     torch.where(et == BNS, m2_bns, m2_nsbh))
    m1, m2 = torch.maximum(m1, m2), torch.minimum(m1, m2)

    d_lo, d_hi = pick("dist_lo"), pick("dist_hi")
    u = u01()
    if cfg.distance_prior == "uniform":
        dist = d_lo + u * (d_hi - d_lo)
    else:
        dist = (d_lo ** 3 + u * (d_hi ** 3 - d_lo ** 3)) ** (1.0 / 3.0)

    def unif(lo, hi):
        return _uniform(lo, hi, shape, generator, device)

    ra = unif(0.0, 2 * math.pi)
    dec = torch.asin(unif(-1.0, 1.0))
    theta_jn = torch.acos(unif(-1.0, 1.0))
    psi = unif(0.0, math.pi)
    phase = unif(0.0, 2 * math.pi)
    t_off = unif(_T_OFF_LO, _T_OFF_HI)
    a1 = u01() * pick("spin1_hi")
    a2 = u01() * pick("spin2_hi")

    cols = [m1, m2, dist, ra, dec, theta_jn, psi, phase, t_off, a1, a2]
    if cfg.precessing:
        cols += [torch.acos(unif(-1.0, 1.0)),      # tilt_1
                 torch.acos(unif(-1.0, 1.0)),      # tilt_2
                 unif(0.0, 2 * math.pi),           # phi_12
                 unif(0.0, 2 * math.pi)]           # phi_jl
    return torch.stack(cols, dim=-1).to(torch.float32)


def sample_n_signals(batch: int, cfg: PriorConfig = PriorConfig(),
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> torch.Tensor:
    """[batch] int32 signal counts: 0 w.p. noise_fraction, 2..max_signals
    w.p. overlap_fraction, else 1."""
    u = _rand((batch,), generator, device)
    n_overlap = torch.randint(2, cfg.max_signals + 1, (batch,),
                              generator=generator, device=device)
    one = torch.ones_like(n_overlap)
    n = torch.where(u < cfg.noise_fraction, 0 * one,
                    torch.where(u < cfg.noise_fraction + cfg.overlap_fraction,
                                n_overlap, one))
    return n.to(torch.int32)


def sample_batch(batch: int, cfg: PriorConfig = PriorConfig(),
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
    """([batch, max_signals, n_params] params, [batch] n_sig). Every slot
    holds a valid draw; slots >= n_sig are masked downstream. With
    premerger_fraction > 0, a single-signal event's first slot may have its
    merger pushed past the window end and a nearby distance."""
    n_sig = sample_n_signals(batch, cfg, generator, device)
    params = sample_signal_params((batch, cfg.max_signals), cfg, generator,
                                  device)
    if cfg.premerger_fraction > 0.0:
        is_pm = ((_rand((batch,), generator, device)
                  < cfg.premerger_fraction) & (n_sig == 1))
        ttm = _uniform(*cfg.premerger_ttm_range, (batch,), generator, device)
        d_pm = _uniform(*cfg.premerger_distance_range, (batch,), generator,
                        device)
        t_pm = DURATION / 2.0 + ttm
        params = params.clone()
        it, idist = IDX["geocent_time"], IDX["luminosity_distance"]
        params[:, 0, it] = torch.where(is_pm, t_pm, params[:, 0, it])
        params[:, 0, idist] = torch.where(is_pm, d_pm, params[:, 0, idist])
    return params, n_sig


def loudness(m1, m2, d):
    """Rank-ordering proxy: whitened amplitude ~ Mc^(5/6)/d_L."""
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    return mc ** (5.0 / 6.0) / torch.clamp_min(d, 1.0)


# ── Closed-form density and draw (importance sampling) ───────────────────────
