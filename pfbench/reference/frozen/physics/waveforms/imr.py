"""The ringdown fit that PhenomD uses. Port of
posteriflow_tpu/physics/waveforms/imr.py.
"""

from __future__ import annotations

import math

import torch

from pfbench.reference.frozen.physics.constants import MTSUN_SI

def qnm_frequency(final_mass_msun, final_spin):
    """(f_RD, f_damp) [Hz] of the l=m=2, n=0 quasinormal mode (Berti,
    Cardoso & Will 2006 fits)."""
    mf_sec = final_mass_msun * MTSUN_SI
    a = torch.abs(final_spin)
    omega = 1.5251 - 1.1568 * (1.0 - a) ** 0.1292
    quality = 0.7000 + 1.4187 * (1.0 - a) ** (-0.4990)
    f_rd = omega / (2.0 * math.pi * mf_sec)
    f_damp = f_rd / (2.0 * quality)
    return f_rd, f_damp
