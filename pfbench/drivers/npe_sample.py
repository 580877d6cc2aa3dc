"""Posterior sampling of a released LeanNPE, closed loop, one client.

A request takes the next `events_per_request` events of a host pool of
`pool_events` whitened events made from the seed, and runs the served
path: `InferenceEngine.encode`, then `sample_posterior` at `rank` with
`draws_per_event` base draws an event, and brings the draws and their log
densities to the host, into page-locked buffers that the client reuses.
The base draws are the benchmark's, from the seed and the request's index,
so that the reference can be handed the same.

Correctness: a sample of `check_requests` requests that the window
finished, drawn from the seed (reservoir sampling), is run again through
the plain reference from the same strain and base draws; the gaps of the
draws and of log q, as quantiles of each event's draws
(reference/npe.event_quantiles), are compared with the cell's limits.
"""

from __future__ import annotations

import numpy as np
import torch

from pfbench.counts import for_config
from pfbench.harness import registry, traffic
from pfbench.harness.window import Check


class Driver:
    closed_loop = True

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed = cell, seed
        self.device, self.spans = device, spans
        p = cell.params
        self.pool_n = int(p["pool_events"])
        self.events = int(p["events_per_request"])
        self.draws = int(p["draws_per_event"])
        self.rank = int(p["rank"])
        self.keep_n = int(p["check_requests"])
        self.trace_units = int(p["trace_units"])
        self.warmup = int(p["warmup_units"])
        self.limits = p["limits"]
        self.release_dir = registry.ROOT / cell.config["release"]
        self.n_params = len(cell.config["config"]["npe"]["param_names"])
        self._flags = []
        self._kept = []              # (index, draws, log q) on the host
        self._seen = 0
        self._rng = np.random.default_rng(traffic.sub_seed(seed,
                                                           traffic.CHECK))

    # ── set-up ─────────────────────────────────────────────────────────
    def setup(self) -> int:
        from posteriflow_torch.inference.pipeline import InferenceEngine
        from posteriflow_torch.train.checkpoints import load_release
        state_dict, cfg, meta = load_release(self.release_dir)
        if meta["config"] != self.cell.config["config"]:
            raise ValueError(f"{self.release_dir}'s meta.json is not the "
                             f"configuration {self.cell.config['name']}")
        self.engine = InferenceEngine(state_dict, cfg, device=self.device)
        pin = self.device.type == "cuda"
        self._theta_h = torch.empty((self.events, self.draws, self.n_params),
                                    pin_memory=pin)
        self._log_q_h = torch.empty((self.events, self.draws),
                                    pin_memory=pin)
        self.strain, self.asd = traffic.npe_event_pool(
            self.cell.config["config"]["sim"], self.pool_n, self.seed,
            self.device)
        for i in range(self.warmup):
            self._request(-1 - i, keep=False)
        self._flags.clear()
        return 0

    def _rows(self, i: int) -> slice:
        start = (i * self.events) % self.pool_n
        return slice(start, start + self.events)

    def _z(self, i: int) -> torch.Tensor:
        return traffic.base_draws(self.seed, i, (self.events, self.draws,
                                                 self.n_params), self.device)

    def _request(self, i: int, keep: bool = True) -> dict:
        rows = self._rows(i)
        z = self._z(i)
        with self.spans.span("encode"):
            ctx = self.engine.encode(self.strain[rows], self.asd[rows])
        with self.spans.span("flow"):
            theta, log_q, _ = self.engine.sample_posterior(
                ctx, self.rank, self.draws, z=z)
        self._flags.append(torch.isfinite(log_q).all()
                           & torch.isfinite(theta).all())
        self._theta_h.copy_(theta)
        self._log_q_h.copy_(log_q)
        if keep:
            self._reservoir(i)
        return {"draws": self.events * self.draws}

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
            self.cell.config, self.events, self.draws)

    def release(self):
        self.engine = None
        self._flags = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ── correctness ────────────────────────────────────────────────────
    def readings(self, lower: bool = False, witness: bool = False) -> dict:
        """The gaps over the kept requests against the reference:
        the program's, or (lower) the reference's one step of precision
        below the configuration's, or (witness) the reference's in the
        configuration's precision on the CPU, a sound run with other
        rounding."""
        from pfbench.reference import npe as ref
        model = ref.load_release(self.release_dir, self.device)
        if witness:
            model_w = ref.load_release(self.release_dir, "cpu")
        worst = {}
        for i, theta_p, log_q_p in self._kept:
            rows, z = self._rows(i), self._z(i)
            args = (self.strain[rows], self.asd[rows])
            theta_r, log_q_r = ref.sample(model, *args, z, self.rank)
            if lower:
                with ref.lower_precision():
                    theta_p, log_q_p = ref.sample(model, *args, z, self.rank)
            elif witness:
                theta_p, log_q_p = ref.sample(model_w, *args, z.cpu(),
                                              self.rank)
            gaps = ref.draw_gaps(model.scaler, theta_p, theta_r, log_q_p,
                                 log_q_r)
            worst = {k: max(worst.get(k, 0.0), v) for k, v in gaps.items()}
        return worst

    def check(self) -> list:
        got = self.readings()
        return [Check(k, got[k], float(v)) for k, v in self.limits.items()]
