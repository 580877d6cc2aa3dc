"""Evaluation metrics (the part the anchor comparison needs so far)."""
