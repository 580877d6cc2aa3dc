"""Ground-based detector geometry: antenna patterns and geocentric delays.

Port of posteriflow_tpu/physics/detectors.py. The static geometry (response
tensors D = (x̂x̂ᵀ − ŷŷᵀ)/2 from the published site latitude, longitude and
arm bearings; vertex positions) is computed in numpy float64 and rounded to
float32 once per device. The functions take sky angles of any batch shape
[...] and return [..., n_det]; RA enters only through the hour angle
gha = gmst − ra.
"""

from __future__ import annotations

import numpy as np
import torch

from posteriflow_torch.physics.constants import C_SI, DETECTORS
from posteriflow_torch.utils.constants import device_constant

# latitude [rad], longitude [rad], x/y-arm bearings [rad, clockwise from
# North], vertex [m] (LIGO-T980044 / LALDetectors.h values)
_SITES = {
    "H1": dict(lat=0.81079526383, lon=-2.08405676917,
               az_x=5.65487724844, az_y=4.08408092164,
               vertex=(-2.16141492636e6, -3.83469517889e6, 4.60035022664e6)),
    "L1": dict(lat=0.53342313506, lon=-1.58430937078,
               az_x=4.40317772346, az_y=2.83238139666,
               vertex=(-7.42760447238e4, -5.49628371971e6, 3.22425701744e6)),
    "V1": dict(lat=0.76151183984, lon=0.18333805213,
               az_x=0.33916285222, az_y=5.05155183261,
               vertex=(4.54637409900e6, 8.42989697626e5, 4.37857696241e6)),
}


def _arm_direction(lat: float, lon: float, bearing: float) -> np.ndarray:
    """Unit vector of a horizontal arm with the given bearing at a site, in
    Earth-fixed Cartesian coordinates."""
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    north = np.array([-np.sin(lat) * np.cos(lon),
                      -np.sin(lat) * np.sin(lon),
                      np.cos(lat)])
    return np.sin(bearing) * east + np.cos(bearing) * north


def _response_tensor(site: dict) -> np.ndarray:
    x = _arm_direction(site["lat"], site["lon"], site["az_x"])
    y = _arm_direction(site["lat"], site["lon"], site["az_y"])
    return 0.5 * (np.outer(x, x) - np.outer(y, y))


RESPONSE_TENSORS = np.stack([_response_tensor(_SITES[d]) for d in DETECTORS])
VERTICES = np.stack([np.asarray(_SITES[d]["vertex"]) for d in DETECTORS])

def _geometry(device):
    """(response tensors [n_det, 3, 3], vertices [n_det, 3]) in float32 on
    `device`, built once per device."""
    return tuple(device_constant(name, device, lambda a=a: torch.tensor(
        a, dtype=torch.float32))
        for name, a in (("response_tensors", RESPONSE_TENSORS),
                        ("vertices", VERTICES)))


# ── Sidereal time ─────────────────────────────────────────────────────────────
_GPS_EPOCH_JD = 2444244.5          # 1980-01-06 00:00:00 UTC
_LEAP_GPS_MINUS_UTC = 18.0         # valid 2017+

# Earth sidereal rotation rate [rad/s]: device code adds OMEGA_EARTH × the
# in-window time offset to a host GMST, since absolute GPS seconds do not
# pass through float32.
OMEGA_EARTH = 2.0 * np.pi * 1.00273790935 / 86400.0


def gmst_from_gps(gps: float) -> float:
    """Greenwich mean sidereal time [rad] from GPS seconds (IAU-1982),
    host float64, UT1 ≈ UTC."""
    utc = np.float64(gps) - _LEAP_GPS_MINUS_UTC
    jd = _GPS_EPOCH_JD + utc / 86400.0
    tu = (jd - 2451545.0) / 36525.0
    gmst_s = (67310.54841
              + (876600.0 * 3600.0 + 8640184.812866) * tu
              + 0.093104 * tu ** 2
              - 6.2e-6 * tu ** 3)
    return float(np.mod(gmst_s, 86400.0) * (2.0 * np.pi / 86400.0))


def _wave_frame(ra, dec, psi, gmst):
    """The wave-frame axes x, y [..., 3] (LAL XLALComputeDetAMResponse)."""
    gha = gmst - ra
    cg, sg = torch.cos(gha), torch.sin(gha)
    cd, sd = torch.cos(dec), torch.sin(dec)
    cp, sp = torch.cos(psi), torch.sin(psi)
    x = torch.stack([-cp * sg - sp * cg * sd,
                     -cp * cg + sp * sg * sd,
                     sp * cd], dim=-1)
    y = torch.stack([sp * sg - cp * cg * sd,
                     sp * cg + cp * sg * sd,
                     cp * cd], dim=-1)
    return x, y


def _quad(a, resp, b):
    """aᵀ D b for every detector: a, b [..., 3], resp [n_det, 3, 3] ->
    [..., n_det]. Elementwise products and sums, no matmul (no TF32)."""
    return (a[..., None, :, None] * resp * b[..., None, None, :]).sum(
        dim=(-2, -1))


def antenna_pattern(det_idx: int, ra, dec, psi, gmst):
    """(F₊, F×) [...] for one detector."""
    f_plus, f_cross = _patterns(ra, dec, psi, gmst)
    return f_plus[..., det_idx], f_cross[..., det_idx]


def _patterns(ra, dec, psi, gmst):
    resp, _ = _geometry(ra.device)
    x, y = _wave_frame(ra, dec, psi, gmst)
    f_plus = _quad(x, resp, x) - _quad(y, resp, y)
    f_cross = _quad(x, resp, y) + _quad(y, resp, x)
    return f_plus, f_cross


def time_delay_from_geocenter(ra, dec, gmst) -> torch.Tensor:
    """Arrival-time delay detector − geocenter [s], [..., n_det]:
    −(r̂_src · x⃗_det)/c."""
    _, vert = _geometry(ra.device)
    gha = gmst - ra
    cd = torch.cos(dec)
    src = torch.stack([cd * torch.cos(gha), -cd * torch.sin(gha),
                       torch.sin(dec)], dim=-1)
    return -(src[..., None, :] * vert).sum(dim=-1) / C_SI


def network_response(ra, dec, psi, gmst):
    """All detectors at once: (F₊, F×, Δt), each [..., n_det]."""
    f_plus, f_cross = _patterns(ra, dec, psi, gmst)
    return f_plus, f_cross, time_delay_from_geocenter(ra, dec, gmst)
