"""Inference: strain -> PosteriorResult (prepare_real, infer, OOD verdict,
refinement gate)."""
