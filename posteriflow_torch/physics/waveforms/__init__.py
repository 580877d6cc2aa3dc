"""Frequency-domain waveforms: TaylorF2 inspiral, IMRPhenomD, matter
effects and the single-spin precession twist (ports of
posteriflow_tpu/physics/waveforms/).

Shapes: `freqs` is a float32 grid [F]; every per-signal parameter is a
tensor that broadcasts against it, as [N, 1] for N signals, and results
are [N, F]. Everything is float32, as in the JAX package.

The registry maps an approximant's name to its polarizations, all with
the signature (freqs, m1, m2, chi1, chi2, d_L, theta_jn, phase) ->
(h₊, hₓ) complex64. `imr_polarizations` is the production approximant,
PhenomD with mass-keyed matter effects; "IMRPhenomP_Matter" at its
default chi_p = 0 is the aligned twist, and "IMRPhenomJ" the round-1
stitch kept as a regression baseline.
"""

from posteriflow_torch.physics.waveforms.imr import (final_state,
                                                     imr_stitch_polarizations,
                                                     qnm_frequency)
from posteriflow_torch.physics.waveforms.phenomd import (
    phenomd_amp_phase, phenomd_polarizations)
from posteriflow_torch.physics.waveforms.precession import (
    phenomp_polarizations, precession_angles, twist_factors)
from posteriflow_torch.physics.waveforms.taylorf2 import (
    isco_frequency, taylorf2_amp_phase, taylorf2_polarizations)
from posteriflow_torch.physics.waveforms.tidal import (
    lambda_from_mass, matter_effects, phenomd_matter_polarizations,
    tidal_phase)

imr_polarizations = phenomd_matter_polarizations

APPROXIMANTS = {
    "TaylorF2": taylorf2_polarizations,
    "IMRPhenomD": phenomd_polarizations,
    "IMRPhenomD_Matter": phenomd_matter_polarizations,   # production
    "IMRPhenomP_Matter": phenomp_polarizations,
    "IMRPhenomJ": imr_stitch_polarizations,
}

__all__ = ["APPROXIMANTS", "taylorf2_polarizations", "taylorf2_amp_phase",
           "isco_frequency", "imr_polarizations", "phenomd_polarizations",
           "phenomd_amp_phase", "phenomd_matter_polarizations",
           "matter_effects", "tidal_phase", "lambda_from_mass",
           "phenomp_polarizations", "precession_angles", "twist_factors",
           "imr_stitch_polarizations", "final_state", "qnm_frequency"]
