"""Project source-frame polarizations onto the detector network.

Port of posteriflow_tpu/physics/projection.py: antenna-pattern weighting
and a frequency-domain time shift placing the merger at
τ_d = T/2 + t_off + Δt_d(ra, dec, t), circular in time.
"""

from __future__ import annotations

import math

import torch

from pfbench.reference.frozen.physics.constants import DURATION, GPS_REF
from pfbench.reference.frozen.physics.detectors import (OMEGA_EARTH, gmst_from_gps,
                                                 network_response)

# GMST at the canonical window center, host float64
GMST_REF = gmst_from_gps(GPS_REF)


def project_to_network(freqs: torch.Tensor, h_plus: torch.Tensor,
                       h_cross: torch.Tensor, ra, dec, psi, t_off,
                       gmst_ref: float = GMST_REF,
                       duration: float = DURATION) -> torch.Tensor:
    """FD polarizations [..., F] -> per-detector FD strain [..., n_det, F]
    complex64; the extrinsics have the batch shape [...]. The time shift
    e^{-2πifτ} is taken through mod-1 cycles, so that float32 keeps the
    phase error far below a radian at 2 kHz."""
    gmst = gmst_ref + OMEGA_EARTH * t_off
    f_plus, f_cross, dt = network_response(ra, dec, psi, gmst)  # [..., D]
    h = (f_plus[..., None] * h_plus[..., None, :]
         + f_cross[..., None] * h_cross[..., None, :])         # [..., D, F]
    tau = duration / 2.0 + t_off[..., None] + dt               # [..., D]
    cycles = torch.remainder(freqs * tau[..., None], 1.0)
    ang = (-2.0 * math.pi) * cycles
    shift = torch.complex(torch.cos(ang), torch.sin(ang))
    return (h * shift).to(torch.complex64)
