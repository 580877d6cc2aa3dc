"""Nested-sampling and prior-SMC comparison bridge, conventions matched.

Port of posteriflow_tpu/inference/dynesty_bridge.py: training-matched
priors and their unit-cube transform, offset-time <-> absolute-GPS
conversion, dynesty when it is installed and otherwise the package's own
batched random-walk nested sampler (`_nested_fallback`), and
`run_comparison`, which holds the amortized posterior (and its importance
correction) against a flow-independent sampler on the same data and the
same Whittle likelihood.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np

from posteriflow_torch import PARAM_NAMES, PARAM_NAMES_PRECESSING
from posteriflow_torch.physics.constants import GPS_REF
from posteriflow_torch.prior import (_DIST_HI, _DIST_LO, _MASS_HI, _MASS_LO,
                                     BBH, PriorConfig)


def training_matched_priors() -> Dict[str, tuple]:
    """(lo, hi, shape) per parameter, as the training prior has them, the
    15-D precessing block included. Times are offsets from GPS_REF."""
    return {
        "mass_1": (_MASS_LO[BBH], _MASS_HI[BBH], "log"),
        "mass_2": (_MASS_LO[BBH], _MASS_HI[BBH], "log"),
        "luminosity_distance": (_DIST_LO[BBH], _DIST_HI[BBH], "d2"),
        "ra": (0.0, 2 * np.pi, "uniform"),
        "dec": (-np.pi / 2, np.pi / 2, "cos"),
        "theta_jn": (0.0, np.pi, "sin"),
        "psi": (0.0, np.pi, "uniform"),
        "phase": (0.0, 2 * np.pi, "uniform"),
        "geocent_time": (-1.5, 1.5, "uniform"),
        "a1": (0.0, 0.99, "uniform"),
        "a2": (0.0, 0.99, "uniform"),
        "tilt_1": (0.0, np.pi, "sin"),
        "tilt_2": (0.0, np.pi, "sin"),
        "phi_12": (0.0, 2 * np.pi, "uniform"),
        "phi_jl": (0.0, 2 * np.pi, "uniform"),
    }


def prior_transform(u: np.ndarray) -> np.ndarray:
    """Unit cube -> physical parameters under the training priors (the
    dynesty convention); 11 trailing dims = aligned, 15 = precessing. The
    masses are swapped into m1 >= m2."""
    names = PARAM_NAMES_PRECESSING if u.shape[-1] >= 15 else PARAM_NAMES
    pri = training_matched_priors()
    out = np.empty_like(u)
    for j, name in enumerate(names):
        lo, hi, shape = pri[name]
        x = u[..., j]
        if shape == "log":
            out[..., j] = np.exp(np.log(lo) + x * (np.log(hi) - np.log(lo)))
        elif shape == "d2":
            out[..., j] = (lo ** 3 + x * (hi ** 3 - lo ** 3)) ** (1 / 3)
        elif shape == "cos":                 # dec: uniform in sin(dec)
            out[..., j] = np.arcsin(2 * x - 1)
        elif shape == "sin":                 # theta_jn: uniform in cos
            out[..., j] = np.arccos(1 - 2 * x)
        else:
            out[..., j] = lo + x * (hi - lo)
    m1 = np.maximum(out[..., 0], out[..., 1])
    m2 = np.minimum(out[..., 0], out[..., 1])
    out[..., 0], out[..., 1] = m1, m2
    return out


def align_conventions(samples: np.ndarray,
                      to_absolute_gps: bool = True) -> np.ndarray:
    """Offset time <-> absolute GPS. RA is already geocentric: no sidereal
    rotation (rotating by GMST again would count the Earth's orientation
    twice)."""
    out = np.array(samples, copy=True)
    idx = list(PARAM_NAMES).index("geocent_time")
    out[..., idx] += GPS_REF if to_absolute_gps else -GPS_REF
    return out


def run_dynesty(log_likelihood: Callable, nlive: int = 500,
                dlogz: float = 0.5, seed: int = 0, maxiter: int = 20000,
                ndim: int = len(PARAM_NAMES), walks: int = 24):
    """dynesty when installed, else the built-in nested sampler.
    log_likelihood(theta [..., ndim]) -> [...]; ndim 11 = aligned set,
    15 = precessing set."""
    try:
        import dynesty  # noqa: F401
        return _run_real_dynesty(log_likelihood, nlive, dlogz, seed,
                                 maxiter, ndim)
    except ImportError:
        return _nested_fallback(log_likelihood, nlive, dlogz, seed, maxiter,
                                ndim=ndim, walks=walks)


def _run_real_dynesty(log_l, nlive, dlogz, seed, maxiter,
                      ndim=len(PARAM_NAMES)):  # pragma: no cover
    import dynesty
    sampler = dynesty.NestedSampler(
        lambda t: float(log_l(t[None])[0]), prior_transform,
        ndim=ndim, nlive=nlive,
        rstate=np.random.default_rng(seed))
    sampler.run_nested(dlogz=dlogz, maxiter=maxiter, print_progress=False)
    res = sampler.results
    w = np.exp(res.logwt - res.logwt.max())
    return {"samples": res.samples, "weights": w / w.sum(),
            "logz": float(res.logz[-1]), "sampler": "dynesty",
            "n_like_calls": int(res.ncall.sum())}


def _nested_fallback(log_l, nlive, dlogz, seed, maxiter,
                     walks: int = 24, batch: int = 24,
                     ndim: int = len(PARAM_NAMES)):
    """Nested sampler with batched constrained random walks (dynesty's
    'rwalk'): each iteration kills the `batch` lowest-likelihood live
    points and replaces them with the end states of `batch` Metropolis
    walks of `walks` steps from random survivors, live-set-covariance
    proposals accepted iff the likelihood clears the batch's constraint;
    one batched likelihood call per walk step. The volume shrinks point by
    point (vol -= 1/(nlive − i)), the step scale adapts toward 50%
    acceptance, and the terminal live points carry the remaining volume."""
    # batch << nlive keeps the shared constraint and the volume
    # bookkeeping honest
    batch = max(1, min(batch, nlive // 16))
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(nlive, ndim))
    theta = prior_transform(u)
    # a copy: the live-point update below assigns in place
    ll = np.array(log_l(theta.astype(np.float32)))
    dead_theta, dead_ll, logvol = [], [], []
    vol = 0.0
    n_calls = nlive
    n_stuck = 0
    scale = 0.5

    def _reflect(x):
        x = np.abs(x) % 2.0
        x = np.where(x > 1.0, 2.0 - x, x)
        return np.clip(x, 1e-9, 1 - 1e-9)

    for it in range(maxiter // batch):
        order = np.argsort(ll)
        kill = order[:batch]
        thresh = float(ll[kill[-1]])          # highest ll among the killed
        for i, k in enumerate(kill):
            dead_theta.append(theta[k].copy())
            dead_ll.append(float(ll[k]))
            vol -= 1.0 / (nlive - i)
            logvol.append(vol)

        survivors = order[batch:]
        cov = np.cov(u[survivors].T) + 1e-12 * np.eye(ndim)
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            chol = np.diag(np.sqrt(np.diag(cov)))

        # `batch` chains walk inside {ll > thresh}, one batched call a step
        start = survivors[rng.integers(survivors.size, size=batch)]
        u_cur = u[start].copy()
        t_cur = theta[start].copy()
        ll_cur = ll[start].copy()
        acc_count = 0
        moved = np.zeros(batch, bool)
        for _ in range(walks):
            step = rng.standard_normal((batch, ndim)) @ chol.T
            u_new = _reflect(u_cur + scale * step)
            t_new = prior_transform(u_new)
            ll_new = np.array(log_l(t_new.astype(np.float32)))
            n_calls += batch
            ok = ll_new > thresh
            u_cur[ok], t_cur[ok], ll_cur[ok] = u_new[ok], t_new[ok], \
                ll_new[ok]
            acc_count += int(ok.sum())
            moved |= ok
        u[kill], theta[kill], ll[kill] = u_cur, t_cur, ll_cur
        # a chain that never moved re-inserts a duplicate of a survivor
        n_stuck += int((~moved).sum())
        acc = acc_count / (walks * batch)
        scale = float(np.clip(scale * np.exp(0.5 * (acc - 0.5)),
                              1e-4, 10.0))
        # convergence: remaining live evidence below dlogz
        if (it + 1) * batch > nlive \
                and (ll.max() + vol) < (max(dead_ll) - dlogz):
            break
    # terminal live points: each carries volume e^{vol}/nlive
    dead_theta = np.concatenate([np.asarray(dead_theta), theta], axis=0)
    dead_ll = np.concatenate([np.asarray(dead_ll), ll])
    logvol = np.concatenate([np.asarray(logvol),
                             np.full(nlive, vol - np.log(nlive))])
    logwt = dead_ll + logvol
    w = np.exp(logwt - logwt.max())
    return {"samples": dead_theta, "weights": w / w.sum(),
            "logz": float(np.log(np.sum(w)) + logwt.max()),
            "sampler": "fallback-nested", "n_like_calls": n_calls,
            "walks": walks, "final_scale": scale, "batch": batch,
            "n_stuck_chains": n_stuck}


def run_comparison(engine, prepared, n_samples: int = 2000,
                   nlive: int = 300, seed: int = 0,
                   maxiter: int = 5000, importance: bool = False,
                   marginalized_sampler: bool = True,
                   sampler: str = "nested") -> Dict:
    """NPE against an independent sampler on the same data, with
    per-parameter comparison metrics and wall times; importance=True also
    holds the importance-corrected NPE posterior against the sampler.

    sampler="nested": dynesty if installed, else `_nested_fallback`.
    sampler="smc_prior": tempered SMC from the training prior over the
    engine's own parameter set (run_smc_prior), whose evidence is in the
    same noise-ratio convention as importance sampling's. Every
    likelihood runs on the engine's device."""
    from posteriflow_torch.evaluation.metrics import ComparisonMetrics
    from posteriflow_torch.inference.importance import (
        importance_correct, make_log_likelihood,
        make_marginalized_log_likelihood, run_smc_prior)
    from posteriflow_torch.inference.pipeline import infer

    dev = engine.device
    names = tuple(engine.cfg.param_names)
    t0 = time.perf_counter()
    npe = infer(engine, data=prepared, n_samples=n_samples, seed=seed)
    t_npe = time.perf_counter() - t0

    # the sampler runs on the SAME phase/time-marginalized likelihood IS
    # uses by default: the full likelihood's ms-scale t_c fringes are
    # unexplorable for a random-walk sampler at smoke nlive
    make = (make_marginalized_log_likelihood if marginalized_sampler
            else make_log_likelihood)
    log_l = make(prepared.strain, device=dev)
    t0 = time.perf_counter()
    if sampler == "smc_prior":
        smc = run_smc_prior(log_l, seed=seed,
                            marginalized=marginalized_sampler,
                            prior_cfg=PriorConfig(precessing=len(names)
                                                  >= 15))
        ns = {"samples": smc.samples,
              "weights": smc.weights / smc.weights.sum(),
              "logz": float(smc.log_evidence_ratio),
              "sampler": "smc_prior",
              "converged": bool(smc.converged),
              "n_stages": int(smc.n_stages),
              "ess": float(smc.ess),
              "n_like_calls": int(len(smc.samples)
                                  * (1 + 5 * max(smc.n_stages - 1, 0)))}
    else:
        ns = run_dynesty(log_l, nlive=nlive, seed=seed, maxiter=maxiter,
                         ndim=len(names))
    t_ns = time.perf_counter() - t0

    idx = np.random.default_rng(seed).choice(
        len(ns["samples"]), size=min(n_samples, len(ns["samples"])),
        p=ns["weights"])
    ns_samp = ns["samples"][idx]
    comp = ComparisonMetrics().compare_posteriors(npe.samples, ns_samp,
                                                  param_names=names)
    if marginalized_sampler:    # those dims are prior draws in ns_samp
        comp.pop("phase", None)
        comp.pop("geocent_time", None)
    out = {"npe": npe, "nested": ns, "comparison": comp,
           "t_npe_s": t_npe, "t_nested_s": t_ns,
           "speedup": t_ns / max(t_npe, 1e-9)}

    if importance:
        t0 = time.perf_counter()
        ctx = engine.encode(prepared.strain[None], prepared.asd_bands[None])
        # IS against the phase/time-MARGINALIZED likelihood (the
        # production configuration); its weights are exact for the slow
        # parameters, which are what the anchor scores
        log_l_m = make_marginalized_log_likelihood(prepared.strain,
                                                   device=dev)
        is_res = importance_correct(engine, ctx[0], 0, npe.samples,
                                    npe.log_prob, npe.railed, log_l_m,
                                    marginalized=True)
        t_is = time.perf_counter() - t0
        k = np.random.default_rng(seed + 1).choice(
            len(is_res.samples), size=min(n_samples, len(is_res.samples)),
            p=is_res.weights / is_res.weights.sum())
        out["is_comparison"] = ComparisonMetrics().compare_posteriors(
            is_res.samples[k], ns_samp, param_names=names)
        if marginalized_sampler:
            out["is_comparison"].pop("phase", None)
            out["is_comparison"].pop("geocent_time", None)
        out["is"] = {"ess": float(is_res.ess),
                     "efficiency": float(is_res.efficiency),
                     "n_stages": int(is_res.n_stages),
                     "logz": float(is_res.log_evidence_ratio),
                     "t_is_s": t_is}
        # both evidences are ratios to the noise likelihood L(0)
        out["logz_gap"] = out["is"]["logz"] - ns["logz"]
    return out
