"""AHSDPipeline: the hierarchical subtract-and-reinfer decomposition of
overlapping signals (torch).

Port of posteriflow_tpu/core/pipeline.py. Each stage: rank-0 amortized
inference on the current residual (after a subtraction the next-loudest
signal is rank 0; the spline of every flow layer runs in the CUDA kernel
on a card), the posterior-mean template of its first 512 draws subtracted
with the least-squares amplitude, the quality gate, and from the second
stage on the optional bias correction of the stage's posterior. Everything
runs on the engine's device; the loop over stages is Python.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from posteriflow_torch.core.bias_corrector import BiasCorrector
from posteriflow_torch.core.subtractor import AdaptiveSubtractor
from posteriflow_torch.inference.pipeline import InferenceEngine, infer
from posteriflow_torch.inference.preprocessing import PreparedData
from posteriflow_torch.inference.result import PosteriorResult

TEMPLATE_DRAWS = 512


class AHSDPipeline:
    def __init__(self, engine: InferenceEngine,
                 subtractor: Optional[AdaptiveSubtractor] = None,
                 bias_corrector: Optional[BiasCorrector] = None,
                 max_signals: int = 5, quality_threshold: float = 0.3,
                 n_samples: int = 2048):
        self.engine = engine
        self.subtractor = subtractor or AdaptiveSubtractor(
            quality_threshold=quality_threshold, device=engine.device)
        self.bias_corrector = bias_corrector
        self.max_signals = max_signals
        self.n_samples = n_samples

    def decompose(self, prepared: PreparedData, seed: int = 0,
                  z: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        """Iteratively extract signals from a whitened event. Stage s draws
        its base samples from a generator seeded with seed + s + 7 (as
        `infer` with seed + s does), or takes z[s] [1, n_samples, P]."""
        strain = np.array(prepared.strain, copy=True)
        d0_power = float((strain ** 2).sum())
        stages: List[Dict] = []
        results: List[PosteriorResult] = []

        for stage in range(self.max_signals):
            data = dataclasses.replace(prepared, strain=strain, timings={},
                                       truth=None)
            res = infer(self.engine, data=data, rank=0,
                        n_samples=self.n_samples, seed=seed + stage,
                        z=None if z is None else z[stage])

            sub = self.subtractor.subtract(strain,
                                           res.samples[:TEMPLATE_DRAWS])
            residual_ratio = float((sub["residual"] ** 2).sum() / d0_power)

            if self.bias_corrector is not None and stage > 0:
                corrected = self.bias_corrector.correct(
                    res.samples, stage, sub["quality"], sub["alpha"],
                    residual_ratio)
                if corrected["applied"]:
                    res.samples = corrected["samples"]
                    res.diagnostics["bias_corrected"] = True

            stages.append({
                "stage": stage,
                "fit_snr": sub["fit_snr"],
                "template_snr": sub["template_snr"],
                "quality": sub["quality"],
                "alpha": sub["alpha"],
                "residual_power_ratio": residual_ratio,
                "accepted": sub["accepted"],
            })
            if not sub["accepted"]:
                break                      # quality gate: stop extracting
            results.append(res)
            strain = sub["residual"].astype(np.float32)

        return {
            "results": results,
            "n_extracted": len(results),
            "stages": stages,
            "final_residual_power_ratio":
                stages[-1]["residual_power_ratio"] if stages else 1.0,
        }
