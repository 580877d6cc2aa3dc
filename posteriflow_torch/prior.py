"""Astrophysical parameter priors: batched sampling from a torch.Generator,
and the closed-form BBH training prior of importance sampling.

Port of posteriflow_tpu/prior.py. The sampling half (:49-213, :323): the
event mix BBH / BNS / NSBH by `type_probs`, per-type mass boxes
(log-uniform BH masses, uniform NS masses), P(d) ∝ d² or uniform distance,
isotropic sky and inclination, uniform psi, phase and time offset, aligned
spin magnitudes per type, isotropic tilts and uniform azimuths for the
15-D set, the overlap count and the pre-merger conversion. All three type
candidates are computed and one is selected, as in the JAX package. The
JAX and torch random streams differ, so the two are held to each other by
distribution only. The closed-form half (:220-320): `log_prior_bbh`, the
BBH prior's log density on tensors, and `sample_prior_bbh`, its exact
draw in numpy from a np.random.Generator (the same stream as JAX's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from posteriflow_torch import PARAM_NAMES
from posteriflow_torch.physics.constants import DURATION
from posteriflow_torch.utils.constants import device_constant

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


def sample_event(cfg: PriorConfig = PriorConfig(),
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
    """One event: ([max_signals, n_params] params, n_sig scalar)."""
    params, n_sig = sample_batch(1, cfg, generator, device)
    return params[0], n_sig[0]


def loudness(m1, m2, d):
    """Rank-ordering proxy: whitened amplitude ~ Mc^(5/6)/d_L."""
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    return mc ** (5.0 / 6.0) / torch.clamp_min(d, 1.0)


# ── Closed-form density and draw (importance sampling) ───────────────────────

def log_prior_bbh(theta: torch.Tensor,
                  cfg: PriorConfig = PriorConfig()) -> torch.Tensor:
    """log p(theta) of the BBH training prior, theta [..., 11] or [..., 15]
    (the precessing set adds isotropic tilts and uniform azimuths); -inf
    outside the support.

    Flat-in-log masses with m2 <= m1 (joint density 1/(m1·m2·lr·log(m1/lo))),
    P(d) ∝ d² or uniform, isotropic angles, uniform psi, phase, time and
    spin magnitudes. As in the JAX package, a2 is bounded by the BBH
    secondary's spin limit while the density uses the primary's (both
    0.99)."""
    m1, m2, d = theta[..., 0], theta[..., 1], theta[..., 2]
    ra, dec, theta_jn = theta[..., 3], theta[..., 4], theta[..., 5]
    psi, phase = theta[..., 6], theta[..., 7]
    t, a1, a2 = theta[..., 8], theta[..., 9], theta[..., 10]

    lo, hi = _MASS_LO[BBH], _MASS_HI[BBH]
    d_lo, d_hi = _DIST_LO[BBH], _DIST_HI[BBH]
    lr = math.log(hi) - math.log(lo)

    lp = -torch.log(m1) - math.log(lr)
    lp = lp + (-torch.log(m2) - torch.log(torch.log(m1 / lo)))
    if cfg.distance_prior == "uniform":
        lp = lp - math.log(d_hi - d_lo)
    else:
        lp = lp + torch.log(3.0 * d ** 2 / (d_hi ** 3 - d_lo ** 3))
    lp = lp - math.log(2 * math.pi)                 # ra
    lp = lp + torch.log(torch.cos(dec) / 2.0)       # dec
    lp = lp + torch.log(torch.sin(theta_jn) / 2.0)  # theta_jn
    lp = lp - math.log(math.pi)                     # psi
    lp = lp - math.log(2 * math.pi)                 # phase
    lp = lp - math.log(_T_OFF_HI - _T_OFF_LO)       # geocent_time
    lp = lp - 2.0 * math.log(_SPIN1_HI[BBH])        # a1, a2

    inside = ((m1 >= lo) & (m1 <= hi) & (m2 >= lo) & (m2 <= m1)
              & (d >= d_lo) & (d <= d_hi)
              & (ra >= 0) & (ra <= 2 * math.pi)
              & (dec >= -math.pi / 2) & (dec <= math.pi / 2)
              & (theta_jn >= 0) & (theta_jn <= math.pi)
              & (psi >= 0) & (psi <= math.pi)
              & (phase >= 0) & (phase <= 2 * math.pi)
              & (t >= _T_OFF_LO) & (t <= _T_OFF_HI)
              & (a1 >= 0) & (a1 <= _SPIN1_HI[BBH])
              & (a2 >= 0) & (a2 <= _SPIN2_HI[BBH]))

    if theta.shape[-1] >= 15:
        t1, t2 = theta[..., 11], theta[..., 12]
        p12, pjl = theta[..., 13], theta[..., 14]
        lp = lp + torch.log(torch.clamp_min(torch.sin(t1), 1e-30) / 2.0)
        lp = lp + torch.log(torch.clamp_min(torch.sin(t2), 1e-30) / 2.0)
        lp = lp - 2.0 * math.log(2 * math.pi)       # phi_12, phi_jl
        inside = inside & ((t1 >= 0) & (t1 <= math.pi) & (t2 >= 0)
                           & (t2 <= math.pi) & (p12 >= 0)
                           & (p12 <= 2 * math.pi) & (pjl >= 0)
                           & (pjl <= 2 * math.pi))

    neg_inf = torch.full_like(lp, -math.inf)
    lp = torch.where(torch.isfinite(lp), lp, neg_inf)
    return torch.where(inside, lp, neg_inf)


def sample_prior_bbh(rng: np.random.Generator, n: int,
                     cfg: PriorConfig = PriorConfig()) -> np.ndarray:
    """n draws [n, 11] (or [n, 15] with cfg.precessing) float64 from the
    density of log_prior_bbh, on the host; the same calls on `rng` as the
    JAX package makes, so the same generator gives the same draws."""
    lo, hi = _MASS_LO[BBH], _MASS_HI[BBH]
    d_lo, d_hi = _DIST_LO[BBH], _DIST_HI[BBH]
    lm1 = rng.uniform(np.log(lo), np.log(hi), n)
    m1 = np.exp(lm1)
    m2 = np.exp(rng.uniform(np.log(lo), lm1))
    if cfg.distance_prior == "uniform":
        d = rng.uniform(d_lo, d_hi, n)
    else:
        d = (d_lo ** 3 + rng.uniform(0, 1, n)
             * (d_hi ** 3 - d_lo ** 3)) ** (1.0 / 3.0)
    cols = [
        m1, m2, d,
        rng.uniform(0, 2 * np.pi, n),
        np.arcsin(rng.uniform(-1, 1, n)),
        np.arccos(rng.uniform(-1, 1, n)),
        rng.uniform(0, np.pi, n),
        rng.uniform(0, 2 * np.pi, n),
        rng.uniform(_T_OFF_LO, _T_OFF_HI, n),
        rng.uniform(0, _SPIN1_HI[BBH], n),
        rng.uniform(0, _SPIN2_HI[BBH], n)]
    if cfg.precessing:
        cols += [np.arccos(rng.uniform(-1, 1, n)),     # tilt_1
                 np.arccos(rng.uniform(-1, 1, n)),     # tilt_2
                 rng.uniform(0, 2 * np.pi, n),         # phi_12
                 rng.uniform(0, 2 * np.pi, n)]         # phi_jl
    return np.column_stack(cols).astype(np.float64)
