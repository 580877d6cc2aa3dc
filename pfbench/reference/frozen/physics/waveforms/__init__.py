"""Frequency-domain waveforms: TaylorF2 inspiral, IMRPhenomD, matter
effects and the single-spin precession twist (ports of
posteriflow_tpu/physics/waveforms/), as far as the simulator and the
long-BNS front end use them; each is imported from its module.

Shapes: `freqs` is a float32 grid [F]; every per-signal parameter is a
tensor that broadcasts against it, as [N, 1] for N signals, and results
are [N, F]. Everything is float32, as in the JAX package.
"""
