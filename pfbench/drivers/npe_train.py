"""Training steps of LeanNPE from a release, one step a unit.

Set-up builds one TrainState (the port's `init_state`, the release's
weights loaded over it) and a synthetic real-noise bank from the
benchmark's draws (`synthetic_bank_from_draws`). A step is the program's
`simulate_batch` on the benchmark's draws of that step (the prior's
parameters, the event draws and the bank's crops, from the seed and the
step's index), followed by `train_step`: encode, per-rank NLL, backward,
clip, AdamW. The window's steps are asynchronous; it ends with a
synchronisation.

Correctness: set-up drives the same state through the first
`checked_steps` steps with the window's own call, and keeps each step's
loss, every leaf's norm of the first gradient as the optimizer got it
(Adam's first moment after one step over 1 − b1) and every leaf's norm of
the parameters' change over those steps. The window then goes on from
that state. After the window (`after_window`) the same state is put back
in place to the release's weights and the optimizer's first state, and
takes the same steps again through the warmed-up call, so that a path
that changes once warm (a captured graph, a cached table) is held too.
The plain reference (pfbench/reference) then takes those steps from the
same draws; `loss_gap`, `grad_gap` and `change_gap`, the worse of the two
passes, are compared with the cell's limits.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_map

from pfbench.counts import for_config
from pfbench.harness import registry, traffic
from pfbench.harness.window import Check

ADAM_B1 = 0.9


class Driver:
    closed_loop = False

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed = cell, seed
        self.device, self.spans = device, spans
        p = cell.params
        self.batch = int(p["batch"])
        self.bank_segments = int(p["bank_segments"])
        self.bank_len = int(p["bank_segment_len"])
        self.checked = int(p["checked_steps"])
        self.trace_units = int(p["trace_units"])
        self.limits = p["limits"]
        self.release_dir = registry.ROOT / cell.config["release"]
        self._losses = []

    # ── set-up ─────────────────────────────────────────────────────────
    def _frozen_sim(self):
        from pfbench.reference.frozen.data.noise_bank import \
            synthetic_bank_from_draws
        from pfbench.reference.frozen.physics.simulator import \
            sim_config_from_dict
        sim = sim_config_from_dict(self.cell.config["config"]["sim"])
        bank = synthetic_bank_from_draws(self.segs, self.knots,
                                         sim.psd_bands)
        return sim, bank

    def setup(self) -> int:
        from posteriflow_torch.data.noise_bank import (
            RealNoiseDraws, synthetic_bank_from_draws)
        from posteriflow_torch.physics.simulator import (RealDraws, SimDraws,
                                                         simulate_batch)
        from posteriflow_torch.train.checkpoints import (load_release,
                                                         train_cfg_from_dict)
        from posteriflow_torch.train.trainer import init_state, train_step
        self._p = dict(RealNoiseDraws=RealNoiseDraws, RealDraws=RealDraws,
                       SimDraws=SimDraws, simulate_batch=simulate_batch,
                       train_step=train_step)
        state_dict, _, meta = load_release(self.release_dir)
        if meta["config"] != self.cell.config["config"]:
            raise ValueError(f"{self.release_dir}'s meta.json is not the "
                             f"configuration {self.cell.config['name']}")
        self.cfg = dataclasses.replace(
            train_cfg_from_dict(self.cell.config["config"]),
            batch_size=self.batch)
        self.state = init_state(self.cfg, generator=torch.Generator()
                                .manual_seed(traffic.sub_seed(
                                    self.seed, traffic.INIT)),
                                device=self.device)
        self.state.model.load_state_dict(state_dict, strict=True)
        self._release_sd = state_dict
        self._opt0 = tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            self.state.opt.state_dict())
        self.segs, self.knots = traffic.bank_draws(
            self.seed, self.bank_segments, self.bank_len, self.device)
        self.bank = synthetic_bank_from_draws(self.segs, self.knots,
                                              self.cfg.sim.psd_bands)
        self.draw_sim, self.draw_bank = self._frozen_sim()

        self.passes = [self._checked_pass()]
        return self.checked

    def _checked_pass(self) -> dict:
        """The checked steps from the state as it stands -> each step's
        loss, the first gradient's and the change's norms a leaf."""
        names = [n for n, _ in self.state.model.named_parameters()]
        params = [p for _, p in self.state.model.named_parameters()]
        start = [p.detach().clone() for p in params]
        for i in range(self.checked):
            self.run_unit(i)
            if i == 0:
                grad_norms = {
                    n: float(torch.linalg.vector_norm(m) / (1.0 - ADAM_B1))
                    for n, m in zip(names, self.state.opt.mu)}
        losses = [float(x) for x in self._losses[-self.checked:]]
        del self._losses[-self.checked:]
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": {n: float(torch.linalg.vector_norm(
                    p.detach() - s)) for n, p, s in zip(names, params,
                                                       start)}}

    def after_window(self):
        """The window's state, put back in place to the release's weights
        and the optimizer's first state, takes the checked steps again."""
        self.sync()
        self.state.model.load_state_dict(self._release_sd, strict=True)
        self.state.opt.load_state_dict(self._opt0)
        self.passes.append(self._checked_pass())

    def _draws(self, i: int) -> traffic.TrainDraws:
        return traffic.train_draws(self.draw_sim, self.draw_bank, self.seed,
                                   i, self.batch, self.device)

    # ── the window ─────────────────────────────────────────────────────
    def run_unit(self, i: int) -> dict:
        p = self._p
        d = self._draws(i)
        with self.spans.span("simulate"):
            batch = p["simulate_batch"](
                self.batch, self.cfg.sim, device=self.device,
                params=d.params, n_sig=d.n_sig,
                draws=p["SimDraws"](*d.draws), bank=self.bank,
                real_draws=p["RealDraws"](d.use_u,
                                          p["RealNoiseDraws"](*d.crop)))
        with self.spans.span("train_step"):
            m = p["train_step"](self.state, batch)
        self._losses.append(m["nll"])
        return {"events": self.batch}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def failed(self) -> int:
        if not self._losses:
            return 0
        return int((~torch.isfinite(torch.stack(self._losses))).sum())

    def counts(self) -> dict:
        return for_config(self.cell.config["name"]).train_step(
            self.cell.config, self.batch)

    def release(self):
        self.state = None
        self._release_sd = self._opt0 = None
        self.bank = None
        self._losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ── correctness ────────────────────────────────────────────────────
    def reference_steps(self, lower: bool = False) -> dict:
        """The plain reference's losses, first-gradient norms and change
        norms over the checked steps, from the same draws (one step of
        precision below the configuration's with `lower`)."""
        from pfbench.reference import train as ref
        cfg = {**self.cell.config["config"], "batch_size": self.batch}
        return ref.steps(self.release_dir, cfg, self.draw_sim,
                         self.draw_bank, [self._draws(i)
                                          for i in range(self.checked)],
                         self.device, lower)

    def readings(self, lower: bool = False, witness: bool = False) -> dict:
        """The gaps of the program's checked steps against the reference,
        or (lower) of the reference one step of precision below the
        configuration's, in the program's place. The program's backward
        rounds apart from the reference's, so its own readings are the
        sound runs with other rounding: there is no `witness`."""
        if witness:
            raise ValueError("the training cell reads no CPU witness")
        from pfbench.reference.train import gaps
        ref = self.reference_steps(False)
        if lower:
            return gaps(self.reference_steps(True), ref)
        each = [gaps(got, ref) for got in self.passes]
        return {k: max(g[k] for g in each) for k in each[0]}

    def check(self) -> list:
        got = self.readings()
        return [Check(k, got[k], float(v)) for k, v in self.limits.items()]
