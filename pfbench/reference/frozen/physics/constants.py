"""Physical constants and framework-wide data conventions (numpy only).

A copy of posteriflow_tpu/physics/constants.py: the port keeps its own so
that it never imports the JAX package.
"""

import numpy as np

# ── Fundamental constants (SI) ───────────────────────────────────────────────
C_SI = 299792458.0                  # speed of light [m/s]
G_SI = 6.67430e-11                  # gravitational constant [m^3 kg^-1 s^-2]
MSUN_SI = 1.988409870698051e30      # solar mass [kg]
MTSUN_SI = 4.925490947641267e-6     # G*Msun/c^3 [s]
MRSUN_SI = 1.476625038050125e3      # G*Msun/c^2 [m]
MPC_SI = 3.085677581491367e22       # megaparsec [m]

EULER_GAMMA = 0.5772156649015329

# Device-side strain-domain quantities carry this fixed scale so that their
# squares stay inside the float32 range; whitened data is a ratio and does
# not see it.
STRAIN_SCALE = 1e23

# ── Data conventions ─────────────────────────────────────────────────────────
SAMPLE_RATE = 4096                  # Hz
DURATION = 4.0                      # s
N_SAMPLES = int(SAMPLE_RATE * DURATION)        # 16384
N_RFFT = N_SAMPLES // 2 + 1                     # 8193
DELTA_F = 1.0 / DURATION                        # 0.25 Hz
DELTA_T = 1.0 / SAMPLE_RATE
F_LOWER = 20.0                      # analysis band lower edge [Hz]
F_UPPER = 1024.0                    # encoder band upper edge [Hz]
F_NYQUIST = SAMPLE_RATE / 2.0       # 2048 Hz
F_REF = 50.0                        # waveform reference frequency [Hz]

DETECTORS = ("H1", "L1", "V1")
N_DETECTORS = len(DETECTORS)

# O4-era reference GPS epoch; geocent_time labels are offsets from it.
GPS_REF = 1369224018.0

# rfft frequency grid for the canonical window (float64 for phase accuracy)
FREQS = np.fft.rfftfreq(N_SAMPLES, DELTA_T)     # [N_RFFT], 0 .. 2048 Hz
