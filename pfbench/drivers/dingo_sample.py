"""Posterior sampling of DINGO's network (configs/dingo_nsf30.json),
closed loop, one client: a dingo_pipe job's sampling call.

The weights come from the seed (`train/checkpoints.load_dingo`; there is
no release). A request takes the next event of a host pool of
`pool_events` events made from the seed, [D, 3, n_f] a detector's real
and imaginary whitened strain and 1 / (ASD·10²³), held in ordinary
(pageable) host memory as the other sampling cells hold their pools. It
runs the served path, `InferenceEngine.encode` then `sample_posterior` at
rank 0 with `draws_per_event` base draws, the benchmark's, from the seed
and the request's index, and brings the draws and their log densities to
the host, into page-locked buffers that the client reuses.

The pool is the port's own physics on dingo's grid (f_min to f_max at
delta_f): a precessing signal from the port's prior (PriorConfig with
precession), PhenomD with the precession twist
(physics/waveforms/precession.py, as precessing_signal_white_fd computes
it on the 4-s grid), projected on the detectors at the event's sidereal
time and shifted by its geocentric time and each detector's delay, over
the design ASD, whitened as the port whitens (√(4Δf)/ASD, so the noise's
real and imaginary parts are unit normal), plus that noise.

Correctness: `check_requests` requests that the window finished, drawn
from the seed, run again through the plain reference
(pfbench/reference/dingo.py) on the card from the same strain, base draws
and state dict; the gaps of the draws and of log q, as quantiles of each
event's draws (reference/npe.event_quantiles), are compared with the
cell's limits. One step of precision below the configuration's is the
reference with TF32 allowed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pfbench.counts import for_config
from pfbench.harness import registry, traffic
from pfbench.harness.window import Check


def event_pool(cfg: dict, n_events: int, seed: int, device) -> torch.Tensor:
    """n_events events [n, D, 3, n_f] float32 in pageable host memory."""
    from posteriflow_torch.physics.constants import STRAIN_SCALE
    from posteriflow_torch.physics.detectors import (OMEGA_EARTH,
                                                     network_response)
    from posteriflow_torch.physics.projection import GMST_REF
    from posteriflow_torch.physics.psd import psd_for
    from posteriflow_torch.physics.waveforms.precession import (
        phenomp_polarizations, spin_components)
    from posteriflow_torch.prior import PriorConfig, sample_signal_params
    gen = traffic.generator(device, seed, traffic.POOL)
    n_f = int(round((cfg["f_max"] - cfg["f_min"]) / cfg["delta_f"])) + 1
    f64 = cfg["f_min"] + cfg["delta_f"] * np.arange(n_f)
    freqs = torch.tensor(f64, dtype=torch.float32, device=device)
    asd = torch.tensor(np.sqrt(np.stack([psd_for(d, f64)
                                         for d in cfg["detectors"]]))
                       * STRAIN_SCALE, dtype=torch.float32, device=device)
    theta = sample_signal_params((n_events,), PriorConfig(precessing=True),
                                 gen, device)
    (m1, m2, dist, ra, dec, theta_jn, psi, phase, t_off, a1, a2, t1, t2,
     p12, pjl) = theta.unbind(-1)
    chi_1z, chi_2z, chi_p = spin_components(a1, a2, t1, t2, p12, m1, m2)
    col = [v[:, None] for v in (m1, m2, chi_1z, chi_2z, dist, theta_jn,
                                phase, chi_p, pjl)]
    hp, hc = phenomp_polarizations(freqs, *col[:7], chi_p=col[7],
                                   f_lower=cfg["f_min"], alpha0=col[8])
    f_plus, f_cross, dt = network_response(ra, dec, psi,
                                           GMST_REF + OMEGA_EARTH * t_off)
    tau = t_off[:, None] + dt                                    # [n, D]
    cycles = torch.remainder(freqs * tau[..., None], 1.0)
    shift = torch.polar(torch.ones_like(cycles), -2.0 * math.pi * cycles)
    h = ((f_plus[..., None] * hp[:, None] + f_cross[..., None] * hc[:, None])
         * shift / asd * math.sqrt(4.0 * cfg["delta_f"]))
    noise = torch.randn((2,) + tuple(h.shape), generator=gen, device=device)
    inv_asd = (1.0 / asd).expand(h.shape)
    strain = torch.stack([h.real + noise[0], h.imag + noise[1], inv_asd],
                         dim=2)
    return strain.float().cpu()


class Driver:
    closed_loop = True

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed = cell, seed
        self.device, self.spans = device, spans
        p = cell.params
        self.pool_n = int(p["pool_events"])
        self.draws = int(p["draws_per_event"])
        self.keep_n = int(p["check_requests"])
        self.trace_units = int(p["trace_units"])
        self.warmup = int(p["warmup_units"])
        self.limits = p["limits"]
        self.model_dir = registry.ROOT / cell.config["release"]
        self.n_params = len(cell.config["config"]["dingo"]["param_names"])
        self._flags = []
        self._kept = []              # (index, draws, log q) on the host
        self._seen = 0
        self._rng = np.random.default_rng(traffic.sub_seed(seed,
                                                           traffic.CHECK))

    # ── set-up ─────────────────────────────────────────────────────────
    def setup(self) -> int:
        from posteriflow_torch.inference.pipeline import InferenceEngine
        from posteriflow_torch.train.checkpoints import load_dingo
        self.state_dict, cfg, meta = load_dingo(
            self.model_dir, traffic.sub_seed(self.seed, traffic.INIT))
        if meta["config"] != self.cell.config["config"]:
            raise ValueError(f"{self.model_dir}'s meta.json is not the "
                             f"configuration {self.cell.config['name']}")
        self.engine = InferenceEngine(self.state_dict, cfg,
                                      device=self.device)
        pin = self.device.type == "cuda"
        self._theta_h = torch.empty((1, self.draws, self.n_params),
                                    pin_memory=pin)
        self._log_q_h = torch.empty((1, self.draws), pin_memory=pin)
        self.strain = event_pool(self.cell.config["config"]["dingo"],
                                 self.pool_n, self.seed, self.device)
        for i in range(self.warmup):
            self._request(-1 - i, keep=False)
        self._flags.clear()
        return 0

    def _rows(self, i: int) -> slice:
        start = i % self.pool_n
        return slice(start, start + 1)

    def _z(self, i: int) -> torch.Tensor:
        return traffic.base_draws(self.seed, i, (1, self.draws,
                                                 self.n_params), self.device)

    def _request(self, i: int, keep: bool = True) -> dict:
        z = self._z(i)
        with self.spans.span("encode"):
            ctx = self.engine.encode(self.strain[self._rows(i)], None)
        with self.spans.span("flow"):
            theta, log_q, _ = self.engine.sample_posterior(
                ctx, 0, self.draws, z=z)
        self._flags.append(torch.isfinite(log_q).all()
                           & torch.isfinite(theta).all())
        self._theta_h.copy_(theta)
        self._log_q_h.copy_(log_q)
        if keep:
            self._reservoir(i)
        return {"draws": self.draws}

    def _reservoir(self, i):
        """Keep request i's draws with the probability that leaves every
        finished request equally likely to be checked."""
        slot = len(self._kept)
        if slot >= self.keep_n:
            slot = int(self._rng.integers(0, self._seen + 1))
        self._seen += 1
        if slot < self.keep_n:
            kept = (i, self._theta_h.clone(), self._log_q_h.clone())
            if slot == len(self._kept):
                self._kept.append(kept)
            else:
                self._kept[slot] = kept

    # ── the window ─────────────────────────────────────────────────────
    def run_unit(self, i: int) -> dict:
        return self._request(i)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed(self) -> int:
        if not self._flags:
            return 0
        return int((~torch.stack(self._flags)).sum())

    def counts(self) -> dict:
        return for_config(self.cell.config["name"]).sample_request(
            self.cell.config, 1, self.draws)

    def release(self):
        self.engine = None
        self._flags = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ── correctness ────────────────────────────────────────────────────
    def readings(self, lower: bool = False, witness: bool = False) -> dict:
        """The gaps over the kept requests against the reference: the
        program's, or (lower) the reference's with TF32 allowed, one step
        of precision below the configuration's float32. There is no
        witness: the program is not bit-equal to the reference, so its
        own reading is the sound run with other rounding."""
        if witness:
            raise ValueError("the DINGO cell has no witness reading")
        from pfbench.reference import dingo as ref
        model = ref.build(self.cell.config["config"], self.state_dict,
                          self.device)
        worst = {}
        for i, theta_p, log_q_p in self._kept:
            z = self._z(i)
            strain = self.strain[self._rows(i)]
            theta_r, log_q_r = ref.sample(model, strain, z)
            if lower:
                theta_p, log_q_p = ref.sample(model, strain, z,
                                              allow_tf32=True)
            gaps = ref.draw_gaps(model.std, theta_p, theta_r, log_q_p,
                                 log_q_r)
            worst = {k: max(worst.get(k, 0.0), v) for k, v in gaps.items()}
        return worst

    def check(self) -> list:
        got = self.readings()
        return [Check(k, got[k], float(v)) for k, v in self.limits.items()]
