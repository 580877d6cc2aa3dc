"""Flat-ΛCDM cosmology helpers and the effective-spin conversions.

Port of posteriflow_tpu/physics/cosmology.py: redshift <-> luminosity
distance, comoving distance, chi_eff, chirp mass and mass ratio, with
Planck-2018-like parameters. The comoving integral is a fixed 32-node
Gauss-Legendre rule in float32 and the inverse a fixed 20-step bisection
on [0, 10], as in the JAX package. Inputs are numbers, numpy arrays or
tensors; results are float32 tensors on the input's device (the CPU for
numbers and arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from posteriflow_torch.physics.constants import C_SI
from posteriflow_torch.utils.constants import device_constant

H0_KM_S_MPC = 67.7
OMEGA_M = 0.31
_DH_MPC = C_SI / 1000.0 / H0_KM_S_MPC          # Hubble distance [Mpc]

# Gauss-Legendre nodes and weights on [0, 1], float32 (host-made)
_GL_X, _GL_W = np.polynomial.legendre.leggauss(32)
_GL_X = (0.5 * (_GL_X + 1.0)).astype(np.float32)
_GL_W = (0.5 * _GL_W).astype(np.float32)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _gl(device):
    return (device_constant("gl_x", device, lambda: torch.from_numpy(_GL_X)),
            device_constant("gl_w", device, lambda: torch.from_numpy(_GL_W)))


def _efunc(z):
    return torch.sqrt(OMEGA_M * (1.0 + z) ** 3 + (1.0 - OMEGA_M))


def comoving_distance(z):
    """[Mpc], flat ΛCDM: D_C = D_H ∫₀^z dz'/E(z')."""
    z = _f32(z)
    gl_x, gl_w = _gl(z.device)
    zz = z[..., None] * gl_x
    return _DH_MPC * z * torch.sum(gl_w / _efunc(zz), dim=-1)


def luminosity_distance(z):
    """[Mpc]: D_L = (1 + z) D_C."""
    z = _f32(z)
    return (1.0 + z) * comoving_distance(z)


def redshift_from_luminosity_distance(d_l, n_iter: int = 20):
    """Invert D_L(z) by bisection on [0, 10], a fixed n_iter steps."""
    d_l = _f32(d_l)
    lo = torch.zeros_like(d_l)
    hi = torch.full_like(d_l, 10.0)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_far = luminosity_distance(mid) > d_l
        hi = torch.where(too_far, mid, hi)
        lo = torch.where(too_far, lo, mid)
    return 0.5 * (lo + hi)


def source_frame_masses(m1_det, m2_det, d_l):
    """Detector frame -> source frame: m_src = m_det / (1 + z); returns
    (m1_src, m2_src, z)."""
    z = redshift_from_luminosity_distance(d_l)
    return _f32(m1_det) / (1.0 + z), _f32(m2_det) / (1.0 + z), z


def chi_eff(m1, m2, a1, a2):
    """Effective aligned spin (m1 χ1 + m2 χ2) / M."""
    m1, m2 = _f32(m1), _f32(m2)
    return (m1 * _f32(a1) + m2 * _f32(a2)) / (m1 + m2)


def chirp_mass(m1, m2):
    m1, m2 = _f32(m1), _f32(m2)
    return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2


def mass_ratio(m1, m2):
    m1, m2 = _f32(m1), _f32(m2)
    return torch.minimum(m1, m2) / torch.maximum(m1, m2)
