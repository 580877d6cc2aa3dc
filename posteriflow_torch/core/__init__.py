"""The overlap layer: the hierarchical subtract-and-reinfer pipeline, its
batched form, adaptive subtraction, bias correction and output
calibration (PriorityNet lives in models.priority_net)."""
