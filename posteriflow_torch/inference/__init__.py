"""Inference: strain -> PosteriorResult (prepare_real, infer, OOD verdict,
refinement gate), and the importance-sampling correction against the
exact Whittle likelihood (tempered SMC, prior SMC); `fetch_gwosc` is gated
on gwpy."""

from posteriflow_torch.inference.importance import (
    ISResult, importance_correct, make_log_likelihood,
    make_marginalized_log_likelihood, run_smc_prior, symmetrized_log_q)
from posteriflow_torch.inference.preprocessing import fetch_gwosc

__all__ = [
    "ISResult", "importance_correct", "make_log_likelihood",
    "make_marginalized_log_likelihood", "run_smc_prior",
    "symmetrized_log_q", "fetch_gwosc",
]
