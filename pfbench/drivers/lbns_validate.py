"""Posterior draws of the long-BNS v4 model for batches of 64-s BNS
triggers, closed loop, one client that holds the triggers' strain in host
memory, as the LeanNPE sampling cell's client does.

A request takes the next `triggers_per_request` triggers of a host pool of
`pool_triggers` made from the seed (whitened FD strain of 64-s segments on
the three detectors and the trigger: M̂c and an arrival time a detector),
in ordinary pageable memory, hands them to the card, builds the heterodyned tokens
(`long_bns.trigger_tokens` on the release's stored grid) and runs
`LongBNSNPEv4.sample_raw` with `draws_per_trigger` base draws a trigger,
the benchmark's, from the seed and the request's index. The draws come
back to the host, into a page-locked buffer that the client reuses.
`encode` spans the copy, the tokens and the encoder (to the end of
LongBNSEncoder's forward), `flow` the rest of sample_raw.

Correctness: a sample of `check_requests` finished requests, drawn from
the seed, is run again through the plain reference from the same strain,
triggers and base draws; the draws' gaps, as quantiles of each trigger's
draws (reference/npe.event_quantiles), are compared with the cell's
limits.
"""

from __future__ import annotations

import numpy as np
import torch

from pfbench.counts import for_config
from pfbench.harness import registry, traffic
from pfbench.harness.window import Check

N_PARAMS = 11


class Driver:
    closed_loop = True

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed = cell, seed
        self.device, self.spans = device, spans
        p = cell.params
        self.pool_n = int(p["pool_triggers"])
        self.events = int(p["triggers_per_request"])
        self.draws = int(p["draws_per_trigger"])
        self.keep_n = int(p["check_requests"])
        self.trace_units = int(p["trace_units"])
        self.warmup = int(p["warmup_units"])
        self.limits = p["limits"]
        self.release_dir = registry.ROOT / cell.config["release"]
        self._flags = []
        self._kept = []
        self._seen = 0
        self._rng = np.random.default_rng(traffic.sub_seed(seed,
                                                           traffic.CHECK))
        self._encoded = None

    def setup(self) -> int:
        from posteriflow_torch.models import long_bns as lb
        from posteriflow_torch.train.checkpoints import load_long_bns
        self.model, cal_cfg, self.grid = load_long_bns(self.release_dir,
                                                       device=self.device)
        if cal_cfg != self.cell.config["config"]:
            raise ValueError(f"{self.release_dir}'s calibration.json is not "
                             f"the configuration {self.cell.config['name']}")
        self.tokens = lb.trigger_tokens
        self.model.encoder.register_forward_hook(self._encoder_done)
        from pfbench.reference.frozen.models import long_bns as frozen
        pool_grid = frozen.load_stored_grid(cal_cfg["tokens"])
        self.strain, self.trig = traffic.long_bns_pool(
            pool_grid, self.pool_n, self.seed, self.device)
        self._theta_h = torch.empty((self.events, self.draws, N_PARAMS),
                                    pin_memory=self.device.type == "cuda")
        for i in range(self.warmup):
            self._request(-1 - i, keep=False)
        self._flags.clear()
        return 0

    def _encoder_done(self, module, inputs, output):
        self._encoded = self.spans.mark()

    def _rows(self, i: int) -> slice:
        start = (i * self.events) % self.pool_n
        return slice(start, start + self.events)

    def _z(self, i: int) -> torch.Tensor:
        return traffic.base_draws(self.seed, i, (self.events, self.draws,
                                                 N_PARAMS), self.device)

    @torch.no_grad()
    def _request(self, i: int, keep: bool = True) -> dict:
        rows = self._rows(i)
        z = self._z(i)
        start = self.spans.mark()
        h = torch.as_tensor(self.strain[rows]).to(self.device)
        trig = torch.as_tensor(self.trig[rows]).to(self.device)
        tok = self.tokens(h, self.grid, trig[:, 0], trig[:, 1:])
        theta, _ = self.model.sample_raw(tok, trig, self.draws, z=z)
        end = self.spans.mark()
        self.spans.add("encode", start, self._encoded)
        self.spans.add("flow", self._encoded, end)
        self._flags.append(torch.isfinite(theta).all())
        self._theta_h.copy_(theta)
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
            kept = (i, self._theta_h.clone())
            if slot == len(self._kept):
                self._kept.append(kept)
            else:
                self._kept[slot] = kept

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
        self.model = None
        self._flags = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, lower: bool = False, witness: bool = False) -> dict:
        """The gaps over the kept requests against the reference's
        draws: the program's, or (lower) the reference's one step of
        precision below the configuration's, or (witness) the reference's
        in the configuration's precision on the CPU, a sound run with
        other rounding."""
        from pfbench.reference import long_bns as ref
        from pfbench.reference.npe import lower_precision
        model, grid = ref.load_release(self.release_dir, self.device)
        if witness:
            model_w, grid_w = ref.load_release(self.release_dir, "cpu")
        worst = {}
        for i, theta_p in self._kept:
            rows, z = self._rows(i), self._z(i)
            inputs = (self.strain[rows], self.trig[rows])
            theta_r = ref.sample(model, grid, *inputs, z)
            if lower:
                with lower_precision():
                    theta_p = ref.sample(model, grid, *inputs, z)
            elif witness:
                theta_p = ref.sample(model_w, grid_w, *inputs, z.cpu())
            gaps = ref.draw_gaps(model, theta_p, theta_r, self.trig[rows])
            worst = {k: max(worst.get(k, 0.0), v) for k, v in gaps.items()}
        return worst

    def check(self) -> list:
        got = self.readings()
        return [Check(k, got[k], float(v)) for k, v in self.limits.items()]
