"""Importance-sampling correction of the amortized posterior, its tempered
SMC fallback, and the flow-independent SMC from the prior.

Port of posteriflow_tpu/inference/importance.py. The Whittle
log-likelihood ratio in whitened units is

    log L(θ) − log L(0) = Re⟨d_w, h_w(θ)⟩ − ½‖h_w(θ)‖²,

with h_w the simulator's own batched waveform (physics.simulator
.signal_white_fd), so one likelihood call is one [N, P] batch on the
device. The marginalized form integrates the coalescence phase (I₀) and
time (one inverse FFT over every circular shift, averaged over the shifts
inside the t_c prior window) analytically.

The host side (the tempered ladder, resampling, the slow-space helpers,
the KDE correction) is the JAX package's numpy code, copied so that the
same callables give the same numbers. The device side is one sweep of
n_mcmc random-walk Metropolis steps per SMC stage (`FusedMove`):
likelihood, prior, the anchor density g0 (the flow on both mass
orderings, every spline in the CUDA kernel on the card, or the prior) and
the Metropolis test, with one host synchronisation at the end. Its random
draws are made apart from their use (`mcmc_draws`, a torch.Generator on
the device seeded with the integer the ladder passes), so a test can hand
it the JAX package's draws instead.

Every density and likelihood runs under torch.no_grad() on the device the
caller named (the engine's for the flow); nothing moves to the CPU or to
the plain spline on its own.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from posteriflow_torch.physics.constants import N_SAMPLES, SAMPLE_RATE
from posteriflow_torch.physics.simulator import design_asd, signal_white_fd
from posteriflow_torch.prior import (_T_OFF_HI, _T_OFF_LO, PriorConfig,
                                     log_prior_bbh, sample_prior_bbh)
from posteriflow_torch.utils.precision import fp32_exact


def data_white_fd(strain_white_td: torch.Tensor) -> torch.Tensor:
    """Whitened TD strain [..., n_det, T] -> whitened FD in the simulator's
    normalization (inverse of whiten.fd_white_to_td)."""
    return torch.fft.rfft(strain_white_td, dim=-1) / math.sqrt(N_SAMPLES
                                                               / 2.0)


class Likelihood:
    """A batched log-likelihood ratio on one device.

    Called with θ [N, P] (numpy or a tensor) it returns numpy float32 [N],
    as the host ladder wants. `core(θ)` takes and returns tensors on
    `device` without leaving it (the SMC sweep's hook), and
    `is_marginalized` says whether phase and t_c are integrated out."""

    def __init__(self, core: Callable[[torch.Tensor], torch.Tensor],
                 device: torch.device, is_marginalized: bool):
        self.core = core
        self.device = device
        self.is_marginalized = is_marginalized

    @torch.no_grad()
    def __call__(self, theta) -> np.ndarray:
        if not isinstance(theta, torch.Tensor):
            theta = np.asarray(theta, np.float32)
        t = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        return self.core(t).cpu().numpy()


def _whitened_data(strain_white_td, residual_fd, device) -> torch.Tensor:
    """d_w [n_det, F] on `device`: the data's whitened FD minus the
    residual of signals already extracted (if any)."""
    strain = torch.as_tensor(np.asarray(strain_white_td, np.float32),
                             device=device)
    d_w = data_white_fd(strain)
    if residual_fd is not None:
        d_w = d_w - torch.as_tensor(residual_fd, dtype=torch.complex64,
                                    device=device)
    return d_w


def _asd_on(asd, device) -> torch.Tensor:
    if asd is None:
        return design_asd(device)
    return torch.as_tensor(asd, dtype=torch.float32, device=device)


def make_log_likelihood(strain_white_td, asd=None, residual_fd=None,
                        device="cuda") -> Likelihood:
    """Batched Whittle log-likelihood ratio log L(θ) − log L(0) on
    `device`. strain_white_td: [n_det, T] whitened data; residual_fd
    [n_det, F] subtracts already-extracted signals (the overlap
    subtract-and-reinfer loop); asd defaults to the design ASD."""
    device = torch.device(device)
    d_w = _whitened_data(strain_white_td, residual_fd, device)
    asd = _asd_on(asd, device)

    def core(theta: torch.Tensor) -> torch.Tensor:
        h_w = signal_white_fd(theta, asd)                  # [N, n_det, F]
        match = torch.sum(torch.real(d_w * torch.conj(h_w)), dim=(-2, -1))
        return match - 0.5 * torch.sum(torch.abs(h_w) ** 2, dim=(-2, -1))

    return Likelihood(core, device, is_marginalized=False)


def make_marginalized_log_likelihood(strain_white_td, asd=None,
                                     residual_fd=None,
                                     device="cuda") -> Likelihood:
    """Whittle log-likelihood ratio with the coalescence PHASE and TIME
    marginalized analytically: log L(θ) does not depend on θ[7] (phase)
    or θ[8] (geocent_time), which are set to 0 before the waveform.

    Phase: the (2,2)-dominant waveform gives ∫ dφ_c/2π e^{Re[z e^{-2iφ_c}]}
    = I₀(|z|). Time: the complex matched-filter series z(t) over every
    circular shift by one inverse FFT, averaged uniformly over the shifts
    inside the t_c prior window [_T_OFF_LO, _T_OFF_HI] (as log_prior_bbh
    has it), so no likelihood peak outside the prior's support leaks into
    the evidence."""
    device = torch.device(device)
    d_w = _whitened_data(strain_white_td, residual_fd, device)
    asd = _asd_on(asd, device)
    n_td = int(np.shape(strain_white_td)[-1])
    # shift j <-> t_off = j/fs (wrapping: j >= n/2 <-> (j − n)/fs)
    j = np.arange(n_td)
    t_of_j = np.where(j < n_td // 2, j, j - n_td) / float(SAMPLE_RATE)
    window = (t_of_j >= _T_OFF_LO) & (t_of_j <= _T_OFF_HI)
    in_window = torch.as_tensor(window, device=device)
    log_n_window = math.log(float(np.sum(window)))

    def core(theta: torch.Tensor) -> torch.Tensor:
        th0 = theta.clone()
        th0[:, 7] = 0.0
        th0[:, 8] = 0.0
        h_w = signal_white_fd(th0, asd)                    # [N, n_det, F]
        x = torch.sum(d_w * torch.conj(h_w), dim=-2)       # [N, F]
        z = torch.fft.ifft(x, n=n_td, dim=-1) * n_td       # every shift
        absz = torch.abs(z)
        log_i0 = torch.log(torch.special.i0e(absz)) + absz
        log_i0 = torch.where(in_window, log_i0, -math.inf)
        log_mean = torch.logsumexp(log_i0, dim=-1) - log_n_window
        return log_mean - 0.5 * torch.sum(torch.abs(h_w) ** 2, dim=(-2, -1))

    return Likelihood(core, device, is_marginalized=True)


def _swap_masses(theta: torch.Tensor) -> torch.Tensor:
    """θ with columns 0 and 1 exchanged (the other mass ordering)."""
    cols = [1, 0, *range(2, theta.shape[1])]
    return theta[:, cols]


@torch.no_grad()
def symmetrized_log_q(engine, context, rank: int, theta,
                      pad_block: int = 4096) -> torch.Tensor:
    """Mass-symmetrized proposal density in PHYSICAL units,
    log[q(m1, m2) + q(m2, m1)] [N], on the engine's device. The flow only
    ever sees m1 >= m2 but the likelihood is symmetric; pipeline folds
    samples into m1 >= m2, and the density of the folded variable is the
    SUM of both orderings. Each ordering is one flow call at a multiple of
    `pad_block` rows, in the flow's precision (float32 as released)."""
    dev = engine.device
    model, scaler = engine.model, engine.scaler
    dtype = next(model.flow.parameters()).dtype
    ctx = torch.as_tensor(context, dtype=dtype, device=dev).reshape(1, -1)

    def log_q_phys(t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0]
        r = torch.full((n,), rank, dtype=torch.long, device=dev)
        nll = model.nll_from_context(ctx.expand(n, -1), t, r)
        return -nll + scaler.log_abs_det_jacobian(t)

    lqp = _padded(log_q_phys, pad_block)
    theta = torch.as_tensor(theta, dtype=dtype, device=dev)
    lq = torch.stack([lqp(theta), lqp(_swap_masses(theta))])
    return torch.logsumexp(lq, dim=0)


@dataclasses.dataclass
class ISResult:
    samples: np.ndarray
    weights: np.ndarray          # normalized
    log_weights: np.ndarray
    ess: float
    efficiency: float
    log_evidence_ratio: float    # log Z/L(0) estimate
    n_stages: int = 1
    beta_ladder: Optional[list] = None
    converged: bool = True       # tempered ladder reached beta = 1
    mcmc_acceptance: Optional[list] = None   # per-stage SMC move acceptance
    # importance_correct's record: the direct pass's ESS and efficiency,
    # and host seconds of the entry log q, the entry likelihood batch and
    # the SMC sweeps (each ends in a copy to the host)
    diagnostics: dict = dataclasses.field(default_factory=dict)


def host_log_prior(cfg: PriorConfig = PriorConfig(), device="cuda"):
    """log_prior_bbh as a host callable: θ [N, P] (numpy) -> numpy float32
    [N], evaluated in float32 on `device`."""
    device = torch.device(device)

    @torch.no_grad()
    def log_prior_fn(theta) -> np.ndarray:
        t = torch.as_tensor(np.asarray(theta, np.float32), device=device)
        return log_prior_bbh(t, cfg).cpu().numpy()
    return log_prior_fn


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device ("cuda" is card 0, as the engine reads it)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def importance_correct(engine, context, rank: int, samples: np.ndarray,
                       log_q: np.ndarray, railed: np.ndarray,
                       log_l_fn: Callable, log_prior_fn: Callable = None,
                       min_ess_frac: float = 0.2,
                       ladder_target_frac: float = 0.5,
                       max_stages: int = 25, marginalized: bool = False,
                       pad_block: int = 4096, seed: int = 0) -> ISResult:
    """Exact correction of amortized samples against the true likelihood.

    Direct self-normalized IS first; if ESS/n < min_ess_frac, a tempered
    SMC sampler (_tempered_is) on the geometric path between the flow
    proposal g0 and the target L·π, π_β(θ) ∝ g0(θ)^(1−β)·[L(θ)·π(θ)]^β,
    with adaptive β steps, systematic resampling and batched random-walk
    Metropolis rejuvenation (Del Moral et al. 2006).

    marginalized=True declares log_l_fn phase/time-marginalized (the
    production make_marginalized_log_likelihood): the proposal density is
    collapsed to a proper 11-D density whose slow block is the flow's
    marginal (q_joint / KDE(t_c)) and whose fast dims carry their flat
    priors, and the SMC walk moves only the slow dims.

    log_l_fn is a Likelihood (its device sweep then runs the moves; it
    must live on the engine's device) or any host callable θ -> [N].
    log_prior_fn defaults to log_prior_bbh on the engine's device."""
    if log_prior_fn is None:
        log_prior_fn = host_log_prior(device=engine.device)
    ll_core = getattr(log_l_fn, "core", None)
    if ll_core is not None and not _same_device(log_l_fn.device,
                                                engine.device):
        raise ValueError(f"the likelihood lives on {log_l_fn.device}, the "
                         f"engine on {engine.device}")
    # fixed-shape evaluation, as in the JAX package: every call at a
    # multiple of pad_block rows, padded with the first row
    log_l_fn = _padded(log_l_fn, pad_block)
    log_prior_fn = _padded(log_prior_fn, pad_block)

    keep = ~np.asarray(railed)                 # exclude railed draws
    theta = np.asarray(samples[keep], dtype=np.float32)
    seconds = {"log_q": 0.0, "likelihood": 0.0, "moves": 0.0}
    t0 = time.perf_counter()
    lq = symmetrized_log_q(engine, context, rank, theta,
                           pad_block=pad_block).cpu().numpy()
    t1 = time.perf_counter()
    ll = np.asarray(log_l_fn(theta))
    seconds["log_q"], seconds["likelihood"] = t1 - t0, time.perf_counter() - t1
    lp = np.asarray(log_prior_fn(theta))

    if marginalized:
        from scipy.stats import gaussian_kde
        tc = np.asarray(theta[:, 8], np.float64)
        kde_tc = gaussian_kde(tc + 1e-9 * np.random.default_rng(seed)
                              .standard_normal(len(tc)))
        # the proper 11-D proposal density q_joint / (KDE(t_c)·Δt): slow
        # dims keep the flow's marginal, fast dims get the flat prior
        lg0_corr = (-np.log(np.maximum(kde_tc(tc), 1e-300))
                    - np.log(_T_OFF_HI - _T_OFF_LO))
        lq = lq + lg0_corr
    else:
        lg0_corr = np.zeros(len(theta))

    log_w = ll + lp - lq
    log_w = np.where(np.isfinite(log_w), log_w, -np.inf)
    res = _finalize(theta, log_w)
    res.diagnostics = {"direct_ess": res.ess,
                       "direct_efficiency": res.efficiency,
                       "seconds": seconds}
    if res.ess / len(theta) >= min_ess_frac:
        return res

    def log_g0_fn(th):
        out = np.asarray(symmetrized_log_q(
            engine, context, rank, np.asarray(th, np.float32),
            pad_block=pad_block).cpu().numpy(), np.float64)
        if marginalized:
            out = out - np.log(np.maximum(kde_tc(np.asarray(th[:, 8],
                                                            np.float64)),
                                          1e-300)) \
                - np.log(_T_OFF_HI - _T_OFF_LO)
        return out

    theta_np = np.asarray(theta, np.float64)
    lq64, ll64, lp64 = (lq.astype(np.float64), ll.astype(np.float64),
                        lp.astype(np.float64))
    lg0_corr = np.asarray(lg0_corr, np.float64)

    move_fn = None
    if ll_core is not None:
        # the device sweep runs one cloud size: bootstrap the equal-weight
        # entry cloud to exactly pad_block
        n0 = len(theta_np)
        if n0 != pad_block:
            rng0 = np.random.default_rng(seed + 1)
            if n0 > pad_block:
                idx0 = rng0.choice(n0, pad_block, replace=False)
            else:
                idx0 = np.concatenate([
                    np.arange(n0),
                    rng0.integers(0, n0, pad_block - n0)])
            theta_np, lq64, ll64, lp64, lg0_corr = (
                theta_np[idx0], lq64[idx0], ll64[idx0], lp64[idx0],
                lg0_corr[idx0])
        move = _make_fused_move(engine, context, rank, ll_core,
                                marg=marginalized)

        def move_fn(*args):
            t = time.perf_counter()
            out = move(*args)
            seconds["moves"] += time.perf_counter() - t
            return out

    final = _tempered_is(theta_np, lq64, ll64, lp64,
                         log_l_fn, log_prior_fn, log_g0_fn=log_g0_fn,
                         ladder_target_frac=ladder_target_frac,
                         max_stages=max_stages, marginalized=marginalized,
                         move_fn=move_fn, lg0_corr=lg0_corr,
                         seed=seed)
    final.diagnostics = res.diagnostics
    return final


def _tempered_is(theta: np.ndarray, lq: np.ndarray, ll: np.ndarray,
                 lp: np.ndarray, log_l_fn: Callable, log_prior_fn: Callable,
                 log_g0_fn: Callable = None,
                 ladder_target_frac: float = 0.5, max_stages: int = 25,
                 n_mcmc: int = 3, marginalized: bool = False,
                 move_fn: Callable = None, lg0_corr: np.ndarray = None,
                 seed: int = 0) -> ISResult:
    """Tempered SMC sampler on the fixed-anchor geometric path
    π_β(θ) ∝ g0(θ)^(1−β)·[L(θ)·π(θ)]^β, β: 0 → 1, in float64 numpy on the
    host, with the JAX package's numpy stream (default_rng(seed)).

    Per stage: the largest Δβ whose incremental weights
    w ∝ exp(Δβ·[log Lπ − log g0]) keep ESS >= target·n (bisection, no new
    evaluations); log Ẑ += logsumexp(log W + Δβ·δ); systematic
    resampling; then n_mcmc random-walk Metropolis steps targeting π_β in
    (log Mc, log q, log d, …) coordinates (the +log m1·m2·d Jacobian in the
    acceptance, the m1 >= m2 fold as a reflecting log q <= 0 boundary, the
    step 2.38/√d · chol(cov) of the live cloud, its scale adapted between
    stages toward 0.234 acceptance).

    log_g0_fn(θ) -> [N] is the anchor density at new points (defaults to
    log_prior_fn). move_fn, when given (_make_fused_move), replaces the
    host rejuvenation loop with one device sweep per stage; lg0_corr is
    the per-particle constant that keeps its densities in the host's
    convention."""
    from scipy.special import logsumexp as _lse
    rng = np.random.default_rng(seed)
    n = theta.shape[0]
    cur = theta.copy()
    cur_ll, cur_lp, cur_lg0 = ll.copy(), lp.copy(), lq.copy()
    cur_corr = (np.zeros(n) if lg0_corr is None
                else np.asarray(lg0_corr, np.float64))
    if log_g0_fn is None:
        log_g0_fn = log_prior_fn
    target = max(min(ladder_target_frac, 0.9), 0.05)

    beta = 0.0
    log_W = np.full(n, -np.log(n))             # normalized log-weights
    log_z = 0.0
    ladder = []
    converged = False
    acc_hist = []
    # between-stage Robbins-Monro scale: each stage multiplies the NEXT
    # stage's step by exp(acc − 0.234) (clipped), so every within-stage
    # kernel stays exactly π_β-invariant
    rw_scale = 1.0

    def _ess_frac(lw):
        w = _norm_w(lw)
        return float(1.0 / np.sum(w ** 2)) / n

    for _stage in range(max_stages):
        delta = cur_ll + cur_lp - cur_lg0      # log(L·π / g0), cached
        delta = np.where(np.isfinite(delta), delta, -np.inf)
        # largest Δβ keeping incremental ESS above target (the final hop
        # to β = 1 is accepted at a relaxed bar)
        rem = 1.0 - beta
        if _ess_frac(log_W + rem * delta) >= min(target, 0.1):
            dbeta = rem
        else:
            a, b = 0.0, rem
            for _ in range(40):
                mid = 0.5 * (a + b)
                if _ess_frac(log_W + mid * delta) >= target:
                    a = mid
                else:
                    b = mid
            dbeta = max(a, rem * 1e-4)
        # evidence increment: log Σ_i W_i exp(Δβ·δ_i)
        log_z += float(_lse(log_W + dbeta * delta))
        log_W = log_W + dbeta * delta
        log_W = log_W - float(_lse(log_W))
        beta += dbeta
        ladder.append(round(beta, 4))
        if beta >= 1.0 - 1e-9:
            converged = True
            break
        if _stage == max_stages - 1:
            # out of stages: exit with the WEIGHTED cloud at this β, so
            # samples and weights stay consistent and non-convergence shows
            break

        # resample + move (rejuvenate the cloud at π_β)
        idx = _systematic_resample(_norm_w(log_W), rng)
        cur, cur_ll, cur_lp, cur_lg0 = (cur[idx], cur_ll[idx], cur_lp[idx],
                                        cur_lg0[idx])
        cur_corr = cur_corr[idx]
        log_W = np.full(n, -np.log(n))
        x = _to_slow(cur, marg=marginalized)
        d_x = x.shape[1]
        # step covariance from the live cloud; scaled optimal RW factor
        cov = np.cov(x.T) + 1e-12 * np.eye(d_x)
        try:
            chol = np.linalg.cholesky((2.38 ** 2 / d_x) * cov)
        except np.linalg.LinAlgError:
            chol = np.diag(np.maximum(x.std(0), 1e-6)) * (2.38 / d_x ** 0.5)
        chol = rw_scale * chol
        if move_fn is not None:
            cur, cur_ll, cur_lp, cur_lg0, acc_frac = move_fn(
                cur, cur_ll, cur_lp, cur_lg0, cur_corr, beta, chol,
                int(rng.integers(2 ** 31 - 1)))
            acc_hist.append(round(acc_frac, 3))
            rw_scale = float(np.clip(rw_scale * np.exp(acc_frac - 0.234),
                                     0.05, 3.0))
            continue
        # x-space Jacobian of the current cloud (target_x = target_θ·m1m2d)
        jac = np.sum(np.log(np.maximum(cur[:, :3], 1e-10)), axis=1)
        log_tgt = (beta * (cur_ll + cur_lp) + (1.0 - beta) * cur_lg0 + jac)
        acc_frac = 0.0
        for _k in range(n_mcmc):
            xp = x + rng.standard_normal((n, d_x)) @ chol.T
            thp = _reassemble(xp, cur, marg=marginalized)
            llp = np.asarray(log_l_fn(thp), np.float64)
            lpp = np.asarray(log_prior_fn(thp), np.float64)
            lg0p = np.asarray(log_g0_fn(thp), np.float64)
            jacp = np.sum(np.log(np.maximum(thp[:, :3], 1e-10)), axis=1)
            log_tgt_p = beta * (llp + lpp) + (1.0 - beta) * lg0p + jacp
            # reflecting fold boundary: log q > 0 would unfold m1 < m2
            log_tgt_p = np.where(xp[:, 1] <= 0.0, log_tgt_p, -np.inf)
            log_tgt_p = np.where(np.isfinite(log_tgt_p), log_tgt_p, -np.inf)
            accept = np.log(rng.uniform(size=n)) < (log_tgt_p - log_tgt)
            acc_frac += float(np.mean(accept)) / n_mcmc
            cur = np.where(accept[:, None], thp, cur)
            x = np.where(accept[:, None], xp, x)
            cur_ll = np.where(accept, llp, cur_ll)
            cur_lp = np.where(accept, lpp, cur_lp)
            cur_lg0 = np.where(accept, lg0p, cur_lg0)
            log_tgt = np.where(accept, log_tgt_p, log_tgt)
        acc_hist.append(round(acc_frac, 3))
        rw_scale = float(np.clip(rw_scale * np.exp(acc_frac - 0.234),
                                 0.05, 3.0))

    final = _finalize(cur.astype(np.float32), log_W)
    final.n_stages = len(ladder)
    final.beta_ladder = ladder
    final.converged = converged
    # the telescoped SMC evidence; on a run that stops short of β = 1 it
    # is the partial normalizer log(Z_β/Z_0) (converged=False says so)
    final.log_evidence_ratio = float(log_z)
    final.mcmc_acceptance = acc_hist
    return final


def _padded(fn, block: int):
    """fn(θ [N, P]) -> [N] evaluated at a multiple of `block` rows (at
    least one block), padded with the first row, then sliced. θ is a
    tensor (handed on as it is) or numpy (handed on as float32 numpy)."""
    def wrapped(theta):
        if not isinstance(theta, torch.Tensor):
            theta = np.asarray(theta, dtype=np.float32)
        n = theta.shape[0]
        m = max(block, ((n + block - 1) // block) * block)
        if m != n:
            if isinstance(theta, torch.Tensor):
                theta = torch.cat([theta, theta[:1].expand(m - n, -1)])
            else:
                theta = np.concatenate([theta, np.broadcast_to(
                    theta[:1], (m - n, theta.shape[1]))])
        return fn(theta)[:n]
    return wrapped


# Slow-space walk coordinates for the SMC moves: (log Mc, log q, log d_L)
# on the mass/distance block, identity on the rest. In (log Mc, log q) the
# likelihood's razor-thin chirp-mass direction is an axis. The Jacobian
# det ∂(log Mc, log q)/∂(m1, m2) = 1/(m1·m2) exactly, so the θ-space
# density correction stays −[log m1 + log m2 + log d], computed from θ.
# marg=True drops the marginalized fast dims (phase 7, t_c 8): the walk is
# then P−2-D and each particle keeps its own φ/t_c.
def _slow_cols(p: int) -> np.ndarray:
    """Indices of the slow (non-marginalized) parameters of a P-dim set:
    all but phase (7) and geocent_time (8)."""
    return np.asarray([i for i in range(p) if i not in (7, 8)])


def _masses_to_x(m1: np.ndarray, m2: np.ndarray):
    """(m1, m2) -> (log Mc, log q), q = m2/m1 ∈ (0, 1] after folding."""
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    return np.log(mc), np.log(m2 / m1)


def _x_to_masses(lmc: np.ndarray, lq: np.ndarray):
    """(log Mc, log q) -> (m1, m2): M = Mc·q^{-3/5}(1+q)^{6/5}."""
    q = np.exp(lq)
    mc = np.exp(lmc)
    mtot = mc * q ** (-0.6) * (1.0 + q) ** 1.2
    m1 = mtot / (1.0 + q)
    return m1, q * m1


def _to_slow(theta: np.ndarray, marg: bool = False) -> np.ndarray:
    t = (theta[:, _slow_cols(theta.shape[1])] if marg
         else theta).astype(np.float64)
    x = t.copy()
    m1 = np.maximum(t[:, 0], 1e-10)
    m2 = np.maximum(t[:, 1], 1e-10)
    x[:, 0], x[:, 1] = _masses_to_x(m1, m2)
    x[:, 2] = np.log(np.maximum(t[:, 2], 1e-10))
    return x


def _from_slow(x: np.ndarray) -> np.ndarray:
    """Walk coordinates [N, P] -> θ (full-parameter walk); the m1 >= m2
    fold is the walk's reflecting log q <= 0 boundary, not done here."""
    xx = x.copy()
    m1, m2 = _x_to_masses(x[:, 0], x[:, 1])
    xx[:, 0], xx[:, 1] = m1, m2
    xx[:, 2] = np.exp(x[:, 2])
    return xx


def _reassemble(x: np.ndarray, cur: np.ndarray,
                marg: bool = False) -> np.ndarray:
    """Proposed walk coordinates -> full θ [N, P]. marg=True: x is the slow
    block and each particle KEEPS its own fast dims (φ_c, t_c) from
    `cur`."""
    if not marg:
        return _from_slow(x)
    th = cur.copy()
    m1, m2 = _x_to_masses(x[:, 0], x[:, 1])
    th[:, 0], th[:, 1] = m1, m2
    th[:, 2] = np.exp(x[:, 2])
    th[:, _slow_cols(cur.shape[1])[3:]] = x[:, 3:]
    return th


def _to_slow_t(theta: torch.Tensor, marg: bool) -> torch.Tensor:
    """torch twin of _to_slow (the device sweep)."""
    t = theta[:, _slow_cols(theta.shape[1])] if marg else theta
    m1 = torch.clamp_min(t[:, 0], 1e-10)
    m2 = torch.clamp_min(t[:, 1], 1e-10)
    lmc = 0.6 * torch.log(m1 * m2) - 0.2 * torch.log(m1 + m2)
    lq = torch.log(m2 / m1)
    ld = torch.log(torch.clamp_min(t[:, 2], 1e-10))
    return torch.cat([torch.stack([lmc, lq, ld], dim=1), t[:, 3:]], dim=1)


def _reassemble_t(x: torch.Tensor, cur: torch.Tensor,
                  marg: bool) -> torch.Tensor:
    """torch twin of _reassemble."""
    q = torch.exp(x[:, 1])
    mtot = torch.exp(x[:, 0]) * q ** (-0.6) * (1.0 + q) ** 1.2
    m1 = mtot / (1.0 + q)
    m2 = q * m1
    d = torch.exp(x[:, 2])
    if not marg:
        return torch.cat([torch.stack([m1, m2, d], dim=1), x[:, 3:]], dim=1)
    th = cur.clone()
    th[:, 0], th[:, 1], th[:, 2] = m1, m2, d
    th[:, _slow_cols(cur.shape[1])[3:]] = x[:, 3:]
    return th


def mcmc_draws(seed: int, n_mcmc: int, n: int, d_x: int, device):
    """The random draws of one sweep: normals [n_mcmc, n, d_x] and
    uniforms [n_mcmc, n] float32 from a torch.Generator on `device` seeded
    with `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normals = torch.randn((n_mcmc, n, d_x), generator=gen, device=device)
    uniforms = torch.rand((n_mcmc, n), generator=gen, device=device)
    return normals, uniforms


class FusedMove:
    """One SMC rejuvenation sweep on the device: n_mcmc random-walk
    Metropolis steps, each evaluating the likelihood core, the prior and
    the anchor density g0 of the proposals in float32 on `device`.

    g0="flow" (importance correction): the symmetrized flow density at
    (context, rank). g0="prior" (run_smc_prior): the anchor IS the
    training prior, so π_β ∝ π·L^β and no engine is needed. `corr` is the
    per-particle marginalized-proposal constant (−log KDE(t_c) − log Δt;
    zero in prior mode), added to the raw flow density: the walk never
    moves t_c, so it is constant along the sweep.

    Calling it with the host's float64 arrays and an integer seed draws
    with `mcmc_draws`, runs `sweep` and copies the cloud back in ONE
    transfer: one host synchronisation per stage."""

    def __init__(self, engine, context, rank: int, ll_core, marg: bool,
                 n_mcmc: int = 5, g0: str = "flow",
                 prior_cfg: Optional[PriorConfig] = None, device=None):
        if g0 not in ("flow", "prior"):
            raise ValueError(f"g0 must be 'flow' or 'prior', got {g0!r}")
        # the device densities walk the SAME prior as the host weights
        self.prior_cfg = PriorConfig() if prior_cfg is None else prior_cfg
        self.device = torch.device(device if device is not None
                                   else engine.device)
        self.ll_core, self.marg, self.n_mcmc, self.g0 = (ll_core, marg,
                                                         n_mcmc, g0)
        self.engine, self.context, self.rank = engine, context, rank

    def _lg0_raw(self, thp: torch.Tensor) -> torch.Tensor:
        if self.g0 == "prior":
            return log_prior_bbh(thp, self.prior_cfg)
        return symmetrized_log_q(self.engine, self.context, self.rank, thp,
                                 pad_block=thp.shape[0])

    @torch.no_grad()
    def sweep(self, cur, ll, lp, lg0, corr, beta, chol, normals, uniforms):
        """Tensors on the device, float32: cur [n, P], ll/lp/lg0/corr [n],
        beta 0-d, chol [d_x, d_x], normals [n_mcmc, n, d_x], uniforms
        [n_mcmc, n] -> (cur, ll, lp, lg0, mean acceptance 0-d)."""
        marg = self.marg
        x = _to_slow_t(cur, marg)
        jac = torch.sum(torch.log(torch.clamp_min(cur[:, :3], 1e-10)), dim=1)
        log_tgt = beta * (ll + lp) + (1.0 - beta) * lg0 + jac
        acc_sum = torch.zeros((), dtype=torch.float32, device=cur.device)
        for k in range(self.n_mcmc):
            with fp32_exact():
                xp = x + normals[k] @ chol.T
            thp = _reassemble_t(xp, cur, marg)
            llp = self.ll_core(thp)
            lpp = log_prior_bbh(thp, self.prior_cfg)
            lg0p = self._lg0_raw(thp) + corr
            jacp = torch.sum(torch.log(torch.clamp_min(thp[:, :3], 1e-10)),
                             dim=1)
            ltp = beta * (llp + lpp) + (1.0 - beta) * lg0p + jacp
            # reflecting m1 >= m2 fold: log q > 0 would unfold
            ltp = torch.where(xp[:, 1] <= 0.0, ltp, -math.inf)
            ltp = torch.where(torch.isfinite(ltp), ltp, -math.inf)
            acc = torch.log(uniforms[k]) < ltp - log_tgt
            a = acc[:, None]
            cur = torch.where(a, thp, cur)
            x = torch.where(a, xp, x)
            ll = torch.where(acc, llp, ll)
            lp = torch.where(acc, lpp, lp)
            lg0 = torch.where(acc, lg0p, lg0)
            log_tgt = torch.where(acc, ltp, log_tgt)
            acc_sum = acc_sum + acc.to(torch.float32).mean()
        return cur, ll, lp, lg0, acc_sum / self.n_mcmc

    def __call__(self, cur, ll, lp, lg0, corr, beta, chol, seed: int):
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        n, d_x = cur.shape[0], chol.shape[0]
        normals, uniforms = mcmc_draws(seed, self.n_mcmc, n, d_x, dev)
        beta_t = torch.tensor(beta, dtype=torch.float32, device=dev)
        cur, ll, lp, lg0, acc = self.sweep(t(cur), t(ll), t(lp), t(lg0),
                                           t(corr), beta_t, t(chol), normals,
                                           uniforms)
        packed = torch.cat([cur, ll[:, None], lp[:, None], lg0[:, None],
                            acc.expand(n)[:, None]], dim=1).cpu().numpy()
        packed = packed.astype(np.float64)
        p = cur.shape[1]
        return (packed[:, :p], packed[:, p], packed[:, p + 1],
                packed[:, p + 2], float(packed[0, p + 3]))


_make_fused_move = FusedMove           # the JAX package's name for it


def run_smc_prior(log_l_fn: Callable, n: int = 4096, seed: int = 0,
                  marginalized: bool = True, max_stages: int = 40,
                  ladder_target_frac: float = 0.5,
                  prior_cfg: Optional[PriorConfig] = None,
                  n_mcmc: int = 5) -> ISResult:
    """Flow-INDEPENDENT posterior sampler and evidence: tempered SMC from
    the training PRIOR, π_β ∝ π·L^β, β: 0 → 1 (the anchor comparisons'
    sampler baseline). It shares the exact Whittle likelihood with
    importance sampling but not the flow proposal; log_evidence_ratio
    converges to log E_π[L], the same noise-ratio convention as
    importance_correct.

    A Likelihood runs its moves as device sweeps on its own device, where
    the prior is evaluated too; a plain host callable runs the host loop
    with the prior evaluated on the host."""
    rng = np.random.default_rng(seed)
    if prior_cfg is None:
        prior_cfg = PriorConfig()
    theta = sample_prior_bbh(rng, n, prior_cfg)
    ll_core = getattr(log_l_fn, "core", None)
    device = log_l_fn.device if ll_core is not None else "cpu"
    log_prior_fn = host_log_prior(prior_cfg, device)
    lp = np.asarray(log_prior_fn(theta), np.float64)
    ll = np.asarray(log_l_fn(theta.astype(np.float32)), np.float64)

    move_fn = None
    if ll_core is not None:
        move_fn = _make_fused_move(None, None, 0, ll_core, marg=marginalized,
                                   g0="prior", n_mcmc=n_mcmc,
                                   prior_cfg=prior_cfg, device=device)
    return _tempered_is(theta, lp.copy(), ll, lp, log_l_fn, log_prior_fn,
                        ladder_target_frac=ladder_target_frac,
                        max_stages=max_stages, marginalized=marginalized,
                        move_fn=move_fn, n_mcmc=n_mcmc, seed=seed)


def _norm_w(log_w: np.ndarray) -> np.ndarray:
    m = np.max(log_w[np.isfinite(log_w)]) if np.isfinite(log_w).any() else 0.0
    w = np.exp(np.clip(log_w - m, -745, 0))
    s = w.sum()
    return w / s if s > 0 else np.full_like(w, 1.0 / len(w))


def _finalize(theta: np.ndarray, log_w: np.ndarray) -> ISResult:
    w = _norm_w(log_w)
    ess = float(1.0 / np.sum(w ** 2))
    finite = log_w[np.isfinite(log_w)]
    log_z = float(np.log(np.mean(np.exp(finite - finite.max())))
                  + finite.max()) if len(finite) else -np.inf
    return ISResult(samples=theta, weights=w, log_weights=log_w, ess=ess,
                    efficiency=ess / len(theta), log_evidence_ratio=log_z)


def _systematic_resample(w: np.ndarray, rng) -> np.ndarray:
    n = len(w)
    positions = (rng.uniform() + np.arange(n)) / n
    return np.searchsorted(np.cumsum(w), positions).clip(0, n - 1)
