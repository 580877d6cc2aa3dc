"""Encoder, coupling flow, LeanNPE and PriorityNet as torch nn.Modules,
named after the flax modules of posteriflow_tpu/models so that released
weights map one to one (train/checkpoints.py)."""
