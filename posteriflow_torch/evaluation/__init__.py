"""Evaluation: bias, performance, recovery and comparison metrics, result
validation, noise characterization, and the overlap decomposition's
baselines (port of posteriflow_tpu/evaluation/)."""

from posteriflow_torch.evaluation.benchmarks import (
    JointParameterEstimation, SimpleIterativeSubtraction,
    StandardHierarchicalSubtraction)
from posteriflow_torch.evaluation.metrics import (BiasMetrics,
                                                  ComparisonMetrics,
                                                  PerformanceMetrics,
                                                  RecoveryMetrics)
from posteriflow_torch.evaluation.noise_analysis import NoiseAnalyzer
from posteriflow_torch.evaluation.validation import ResultValidator

__all__ = ["BiasMetrics", "PerformanceMetrics", "RecoveryMetrics",
           "ComparisonMetrics", "ResultValidator", "NoiseAnalyzer",
           "StandardHierarchicalSubtraction", "SimpleIterativeSubtraction",
           "JointParameterEstimation"]
