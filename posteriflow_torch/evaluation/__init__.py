"""Evaluation: the anchor comparison's metrics and the overlap
decomposition's baselines."""
