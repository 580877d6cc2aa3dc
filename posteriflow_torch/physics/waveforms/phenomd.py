"""IMRPhenomD: NR-calibrated aligned-spin BBH amplitude and phase.

Port of posteriflow_tpu/physics/waveforms/phenomd.py, batched over signals:
the 19 coefficient polynomials λ(η, χ_PN) of Khan et al. 2016 (Table V),
the Husa et al. 2016 final spin and radiated energy, the Berti et al. QNM
fits, the quartic intermediate amplitude as a 5×5 collocation solve in the
scaled variable x = Mf/f_peak, and the TaylorF2 + σ inspiral phase joined
C¹ to the β and α ansätze.

The JAX package takes the slopes at the joins with jax.grad. Here they are
torch.autograd.grad of the sum over signals at a detached leaf, inside
torch.enable_grad(), so that they also work under the serving path's
torch.no_grad() (not under torch.inference_mode()).

Regions (geometric frequency Mf = f·M_sec):
  amplitude: inspiral Mf < 0.014 → quartic intermediate → merger-ringdown
             beyond the amplitude peak;
  phase:     TaylorF2+σ for Mf < 0.018 → β-ansatz → α-ansatz beyond
             Mf = 0.5·f_RD.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from posteriflow_torch.physics.constants import MTSUN_SI
from posteriflow_torch.physics.waveforms.imr import qnm_frequency
from posteriflow_torch.physics.waveforms.taylorf2 import (TaylorF2Coeffs,
                                                          cbrt,
                                                          polarizations,
                                                          taylorf2_coeffs,
                                                          taylorf2_eval)
from posteriflow_torch.utils.constants import device_constant

_AMP_F_JOIN_INS = 0.014     # amplitude inspiral/intermediate boundary [Mf]
_PHI_F_JOIN_INS = 0.018     # phase inspiral/intermediate boundary [Mf]


# ── Table V of Khan et al. 2016: λ = Λ(η, ξ), ξ = χ_PN − 1 ────────────────────
# Row layout: (c00, c10, c01, c11, c21, c02, c12, c22, c03, c13, c23) in
#   λ = c00 + c10·η + ξ(c01 + c11·η + c21·η²)
#       + ξ²(c02 + c12·η + c22·η²) + ξ³(c03 + c13·η + c23·η²)

_TABLE = {
    # merger-ringdown amplitude
    "gamma1": (0.006927402739328343, 0.03020474290328911,
               0.006308024337706171, -0.12074130661131138,
               0.26271598905781324, 0.0034151773647198794,
               -0.10779338611188374, 0.27098966966891747,
               0.0007374185938559283, -0.02749621038376281,
               0.0733150789135702),
    "gamma2": (1.010344404799477, 0.0008993122007234548,
               0.283949116804459, -4.049752962958005,
               13.207828172665366, 0.10396278486805426,
               -7.025059158961947, 24.784892370130475,
               0.03093202475605892, -2.6924023896851663,
               9.609374464684983),
    "gamma3": (1.3081615607036106, -0.005537729694807678,
               -0.06782917938621007, -0.6689834970767117,
               3.403147966134083, -0.05296577374411866,
               -0.9923793203111362, 4.820681208409587,
               -0.006134139870393713, -0.38429253308696365,
               1.7561754421985984),
    # intermediate amplitude collocation value at f2
    "v2": (0.8149838730507785, 2.5747553517454658,
           1.1610198035496786, -2.3627771785551537,
           6.771038707057573, 0.7570782938606834,
           -2.7256896890432474, 7.1140380397149965,
           0.1766934149293479, -0.7978690983168183,
           2.1162391502005153),
    # inspiral amplitude rho corrections (f^{7/3}, f^{8/3}, f^3)
    "rho1": (3931.8979897196696, -17395.758706812805,
             3132.375545898835, 343965.86092361377,
             -1.2162565819981997e6, -70698.00600428853,
             1.383907177859705e6, -3.9662761890979446e6,
             -60017.52423652596, 803515.1181825735,
             -2.091710365941658e6),
    "rho2": (-40105.47653771657, 112253.0169706701,
             23561.696065836168, -3.476180699403351e6,
             1.137593670849482e7, 754313.1127166454,
             -1.308476044625268e7, 3.6444584853928134e7,
             596226.612472288, -7.4277901143564405e6,
             1.8928977514040343e7),
    "rho3": (83208.35471266537, -191237.7264145924,
             -210916.2454782992, 8.71797508352568e6,
             -2.6914942420669552e7, -1.9889806527362722e6,
             3.0888029960154563e7, -8.390870279256162e7,
             -1.4535031953446497e6, 1.7063528990822166e7,
             -4.2748659731120914e7),
    # intermediate phase
    "beta1": (97.89747327985583, -42.659730877489224,
              153.48421037904913, -1417.0620760768954,
              2752.8614143665027, 138.7406469558649,
              -1433.6585075135881, 2857.7418952430758,
              41.025109467376126, -423.680737974639,
              850.3594335657173),
    "beta2": (-3.282701958759534, -9.051384468245866,
              -12.415449742258042, 55.4716447709787,
              -106.05109938966335, -11.953044553690658,
              76.80704618365418, -155.33172948098394,
              -3.4129261592393263, 25.572377569952536,
              -54.408036707740465),
    "beta3": (-0.000025156429818799565, 0.000019750256942201327,
              -0.000018370671469295915, 0.000021886317041311973,
              0.00008250240316860033, 7.157371250566708e-6,
              -0.000055780000112270685, 0.00019142082884072178,
              5.447166261464217e-6, -0.00003220610095021982,
              0.00007974016714984341),
    # merger-ringdown phase
    "alpha1": (43.31514709695348, 638.6332679188081,
               -32.85768747216059, 2415.8938269370315,
               -5766.875169379177, -61.85459307173841,
               2953.967762459948, -8986.29057591497,
               -21.571435779762044, 981.2158224673428,
               -3239.5664895930286),
    "alpha2": (-0.07020209449091723, -0.16269798450687084,
               -0.1872514685185499, 1.138313650449945,
               -2.8334196304430046, -0.17137955686840617,
               1.7197549338119527, -4.539717148261272,
               -0.049983437357548705, 0.6062072055948309,
               -1.682769616644546),
    "alpha3": (9.5988072383479, -397.05438595557433,
               16.202126189517813, -1574.8286986717037,
               3600.3410843831093, 27.092429659075467,
               -1786.482357315139, 5152.919378666511,
               11.175710130033895, -577.7999423177481,
               1808.730762932043),
    "alpha4": (-0.02989487384493607, 1.4022106448583738,
               -0.07356049468633846, 0.8337006542278661,
               0.2240008282397391, -0.055202870001177226,
               0.5667186343606578, 0.7186931973380503,
               -0.015507437354325743, 0.15750322779277187,
               0.21076815715176228),
    "alpha5": (0.9974408278363099, -0.007884449714907203,
               -0.059046901195591035, 1.3958712396764088,
               -4.516631601676276, -0.05585343136869692,
               1.7516580039343603, -5.990208965347804,
               -0.017945336522161195, 0.5965097794825992,
               -2.0608879367971804),
    # inspiral phase sigma corrections
    "sigma1": (2096.551999295543, 1463.7493168261553,
               1312.5493286098522, 18307.330017082117,
               -43534.1440746107, -833.2889543511114,
               32047.31997183187, -108609.45037520859,
               452.25136398112204, 8353.439546391714,
               -44531.3250037322),
    "sigma2": (-10114.056472621156, -44631.01109458185,
               -6541.308761668722, -266959.23419307504,
               686328.3229317984, 3405.6372187679685,
               -437507.7208209015, 1.6318171307344697e6,
               -7462.648563007646, -114585.25177153319,
               674402.4689098676),
    "sigma3": (22933.658273436497, 230960.00814979506,
               14961.083974183695, 1.1940181342318142e6,
               -3.1042239693052764e6, -3038.166617199259,
               1.8720322849093592e6, -7.309145012085539e6,
               42738.22871475411, 467502.018616601,
               -3.064853498512499e6),
    "sigma4": (-14621.71522218357, -377812.8579387104,
               -9608.682631509726, -1.7108925257214056e6,
               4.332924601416521e6, -22366.683262266528,
               -2.5019716386377467e6, 1.0274495902259542e7,
               -85360.30079034246, -570025.3441737515,
               4.396844346849777e6),
}


_LAM_NAMES = tuple(_TABLE)


def _lam_all(eta, xi) -> dict:
    """Every λ of Table V at once: the rows as [19] constants in eta's
    dtype against eta, xi [..., 1]; each entry takes the same float ops,
    in the same order, as a λ evaluated on its own."""
    key = ("phenomd_lambda_table", eta.dtype)
    c = device_constant(key, eta.device, lambda: torch.tensor(
        list(zip(*_TABLE.values())), dtype=eta.dtype)).unbind(0)
    eta, xi = eta[..., None], xi[..., None]
    eta2 = eta * eta
    lam = (c[0] + c[1] * eta
           + xi * (c[2] + c[3] * eta + c[4] * eta2)
           + xi * xi * (c[5] + c[6] * eta + c[7] * eta2)
           + xi * xi * xi * (c[8] + c[9] * eta + c[10] * eta2))
    return dict(zip(_LAM_NAMES, lam.unbind(-1)))


def _delta(eta):
    return torch.sqrt(torch.clamp_min(1.0 - 4.0 * eta, 0.0))


def chi_pn(eta, chi_1, chi_2):
    """PhenomD's reduced-spin parameter χ_PN (paper II eq. 3)."""
    delta = _delta(eta)
    chi_s = 0.5 * (chi_1 + chi_2)
    chi_a = 0.5 * (chi_1 - chi_2)
    return chi_s * (1.0 - eta * 76.0 / 113.0) + delta * chi_a


def final_spin_husa(eta, chi_1, chi_2):
    """FinalSpin0815 fit (Husa et al. 2016): remnant dimensionless spin."""
    delta = _delta(eta)
    m1 = 0.5 * (1.0 + delta)
    m2 = 0.5 * (1.0 - delta)
    s = m1 * m1 * chi_1 + m2 * m2 * chi_2
    eta2, s2 = eta * eta, s * s
    eta3, s3 = eta2 * eta, s2 * s
    af = (3.4641016151377544 * eta - 4.399247300629289 * eta2
          + 9.397292189321194 * eta3 - 13.180949901606242 * eta2 * eta2
          + s * (1.0 - 0.0850917821418767 * eta - 5.837029316602263 * eta2)
          + s2 * (0.1014665242971878 * eta - 2.0967746996832157 * eta2)
          + s3 * (-1.3546806617824356 * eta + 4.108962025369336 * eta2)
          + s2 * s2 * (-0.8676969352555539 * eta
                       + 2.064046835273906 * eta2))
    return torch.clamp(af, -0.9999, 0.9999)


def radiated_energy_husa(eta, chi_1, chi_2):
    """EradRational0815 fit (Husa et al. 2016): E_rad / M_total."""
    delta = _delta(eta)
    m1 = 0.5 * (1.0 + delta)
    m2 = 0.5 * (1.0 - delta)
    s = (m1 * m1 * chi_1 + m2 * m2 * chi_2) / (m1 * m1 + m2 * m2)
    eta2 = eta * eta
    num = (eta * (0.055974469826360077 + 0.5809510763115132 * eta
                  - 0.9606726679372312 * eta2
                  + 3.352411249771192 * eta2 * eta)
           * (1.0 + (-0.0030302335878845507 - 2.0066110851351073 * eta
                     + 7.7050567802399215 * eta2) * s))
    den = 1.0 + (-0.6714403054720589 - 1.4756929437702908 * eta
                 + 7.304676214885011 * eta2) * s
    return num / den


def _ring_damp_geo(eta, chi_1, chi_2):
    """(f_RD, f_damp) in geometric units of the TOTAL mass (Mf): the
    remnant-geometric QNM frequency over (1 − E_rad)."""
    af = final_spin_husa(eta, chi_1, chi_2)
    erad = radiated_energy_husa(eta, chi_1, chi_2)
    f_rd_rem, f_damp_rem = qnm_frequency(1.0 / MTSUN_SI, af)
    return f_rd_rem / (1.0 - erad), f_damp_rem / (1.0 - erad)


def _value_and_slope(fn, x: torch.Tensor):
    """(fn(x), dfn/dx) elementwise, fn mapping each entry of x on its own:
    the gradient of the sum at a detached leaf."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        y = fn(leaf)
        (g,) = torch.autograd.grad(y.sum(), leaf)
    return y.detach(), g


# ── amplitude ansatz (stripped: relative to A_Newt(f) = amp0·f^{-7/6}) ───────

def _amp_ins_coeffs(eta, chi_1, chi_2):
    """(p23, p1, p43, p53, p2): the inspiral PN amplitude series in powers
    of Mf^{1/3} (paper II B14-B20, LAL-normalized π-folded prefactors)."""
    delta = _delta(eta)
    eta2 = eta * eta
    eta3 = eta2 * eta
    chi12, chi22 = chi_1 * chi_1, chi_2 * chi_2
    pi = math.pi
    pi2 = pi * pi

    p23 = ((-969.0 + 1804.0 * eta) * pi ** (2.0 / 3.0)) / 672.0
    p1 = ((chi_1 * (81.0 * (1.0 + delta) - 44.0 * eta)
           + chi_2 * (81.0 - 81.0 * delta - 44.0 * eta)) * pi) / 48.0
    p43 = ((-27312085.0 - 10287648.0 * chi22
            - 10287648.0 * chi12 * (1.0 + delta)
            + 10287648.0 * chi22 * delta
            + 24.0 * (-1975055.0 + 857304.0 * chi12
                      - 994896.0 * chi_1 * chi_2 + 857304.0 * chi22) * eta
            + 35371056.0 * eta2) * pi ** (4.0 / 3.0)) / 8.128512e6
    p53 = (pi ** (5.0 / 3.0)
           * (chi_2 * (-285197.0 * (-1.0 + delta)
                       + 4.0 * (-91902.0 + 1579.0 * delta) * eta
                       - 35632.0 * eta2)
              + chi_1 * (285197.0 * (1.0 + delta)
                         - 4.0 * (91902.0 + 1579.0 * delta) * eta
                         - 35632.0 * eta2)
              + 42840.0 * (-1.0 + 4.0 * eta) * pi)) / 32256.0
    p2 = -(pi2
           * (-336.0 * (-3248849057.0 + 2943675504.0 * chi12
                        - 3339284256.0 * chi_1 * chi_2
                        + 2943675504.0 * chi22) * eta2
              - 324322727232.0 * eta3
              - 7.0 * (-177520268561.0 + 107414046432.0 * chi22
                       + 107414046432.0 * chi12 * (1.0 + delta)
                       - 107414046432.0 * chi22 * delta
                       + 11087290368.0 * (chi_1 + chi_2 + chi_1 * delta
                                          - chi_2 * delta) * pi)
              + 12.0 * eta * (-545384828789.0
                              - 176491177632.0 * chi_1 * chi_2
                              + 202603761360.0 * chi22
                              + 77616.0 * chi12 * (2610335.0
                                                   + 995766.0 * delta)
                              - 77287373856.0 * chi22 * delta
                              + 5841690624.0 * (chi_1 + chi_2) * pi
                              + 21384760320.0 * pi2))) / 6.0085960704e10
    return p23, p1, p43, p53, p2


def _amp_ins_stripped(mf, coeffs, rho1, rho2, rho3):
    """Inspiral amplitude series + the rho fit corrections."""
    p23, p1, p43, p53, p2 = coeffs
    mf13 = cbrt(mf)
    mf23 = mf13 * mf13
    mf43 = mf23 * mf23
    mf53 = mf43 * mf13
    mf2 = mf * mf
    mf73 = mf2 * mf13
    mf83 = mf73 * mf13
    return (1.0 + p23 * mf23 + p1 * mf + p43 * mf43 + p53 * mf53
            + p2 * mf2 + rho1 * mf73 + rho2 * mf83 + rho3 * mf2 * mf)


def _amp_mrd_stripped(mf, f_rd, f_damp, g1, g2, g3):
    fdg3 = f_damp * g3
    dv = mf - f_rd
    return (torch.exp(-dv * g2 / fdg3) * (fdg3 * g1)
            / (dv * dv + fdg3 * fdg3))


def _amp_peak(f_rd, f_damp, g2, g3):
    """Frequency of the merger-ringdown amplitude maximum (paper II eq. 20)."""
    safe = torch.clamp_max(g2, 1.0 - 1e-6)
    shift = f_damp * g3 * (torch.sqrt(1.0 - safe * safe) - 1.0) / safe
    shift_hi = -f_damp * g3 / torch.clamp_min(g2, 1.0)   # γ2 ≥ 1 branch
    return torch.abs(f_rd + torch.where(g2 < 1.0, shift, shift_hi))


# ── phase ansatz pieces (all already divided by η) ────────────────────────────

def _phi_int(mf, eta, b1, b2, b3):
    return (b1 * mf + b2 * torch.log(mf) - b3 / (3.0 * mf ** 3)) / eta


def _dphi_int(mf, eta, b1, b2, b3):
    return (b1 + b2 / mf + b3 * mf ** -4) / eta


def _phi_mrd(mf, eta, a1, a2, a3, a4, a5, f_rd, f_damp):
    mf14 = torch.sqrt(torch.sqrt(mf))          # mf^0.75 = mf/mf^0.25
    return (a1 * mf - a2 / mf + (4.0 / 3.0) * a3 * (mf / mf14)
            + a4 * torch.atan((mf - a5 * f_rd) / f_damp)) / eta


def _dphi_mrd(mf, eta, a1, a2, a3, a4, a5, f_rd, f_damp):
    mf14 = torch.sqrt(torch.sqrt(mf))
    return (a1 + a2 / (mf * mf) + 1.0 / mf14 * a3
            + a4 * f_damp / ((mf - a5 * f_rd) ** 2 + f_damp * f_damp)) / eta


def _sigma_phase(mf, eta, lam):
    """The σ corrections to the inspiral phase."""
    mf13 = cbrt(mf)
    mf43 = mf * mf13
    mf53 = mf43 * mf13
    return (lam["sigma1"] * mf + 0.75 * lam["sigma2"] * mf43
            + 0.6 * lam["sigma3"] * mf53
            + 0.5 * lam["sigma4"] * mf * mf) / eta


def _phase_joins(m_sec, eta, lam, f_rd, f_damp, tf2_coeffs):
    """(c1_int, c2_int, c1_mrd, c2_mrd): the integration constants that
    make Ψ C¹ at both joins, Mf = 0.018 and Mf = f_RD/2."""
    def psi_ins(f_hz):
        psi = taylorf2_eval(f_hz, tf2_coeffs)[1]
        return psi + _sigma_phase(f_hz * m_sec, eta, lam)

    f1 = _PHI_F_JOIN_INS / m_sec                     # Hz
    f2_geo = 0.5 * f_rd
    f2 = f2_geo / m_sec                              # Hz
    psi1, dpsi1 = _value_and_slope(psi_ins, f1)      # rad, rad/Hz
    b1, b2, b3 = lam["beta1"], lam["beta2"], lam["beta3"]
    # intermediate ansatz derivative in rad/Hz = (dφ/dMf)·m_sec
    c2_int = dpsi1 - _dphi_int(f1 * m_sec, eta, b1, b2, b3) * m_sec
    c1_int = psi1 - _phi_int(f1 * m_sec, eta, b1, b2, b3) - c2_int * f1

    a1, a2, a3 = lam["alpha1"], lam["alpha2"], lam["alpha3"]
    a4, a5 = lam["alpha4"], lam["alpha5"]
    psi2 = _phi_int(f2_geo, eta, b1, b2, b3) + c1_int + c2_int * f2
    dpsi2 = _dphi_int(f2_geo, eta, b1, b2, b3) * m_sec + c2_int
    c2_mrd = dpsi2 - _dphi_mrd(f2_geo, eta, a1, a2, a3, a4, a5,
                               f_rd, f_damp) * m_sec
    c1_mrd = psi2 - _phi_mrd(f2_geo, eta, a1, a2, a3, a4, a5,
                             f_rd, f_damp) - c2_mrd * f2
    return c1_int, c2_int, c1_mrd, c2_mrd


def _phase(freqs, mf, tf2_psi, c: "PhenomDCoeffs"):
    """Ψ [..., F]: TaylorF2+σ, then the β ansatz, then the α ansatz, each
    bin in its own region."""
    lam = c.lam
    b1, b2, b3 = lam["beta1"], lam["beta2"], lam["beta3"]
    a1, a2, a3 = lam["alpha1"], lam["alpha2"], lam["alpha3"]
    a4, a5 = lam["alpha4"], lam["alpha5"]
    f = torch.clamp_min(freqs, 1.0)
    psi_ins_v = tf2_psi + _sigma_phase(mf, c.eta, lam)
    psi_int = _phi_int(mf, c.eta, b1, b2, b3) + c.c1_int + c.c2_int * f
    psi_mrd = (_phi_mrd(mf, c.eta, a1, a2, a3, a4, a5, c.f_rd, c.f_damp)
               + c.c1_mrd + c.c2_mrd * f)
    return torch.where(mf < _PHI_F_JOIN_INS, psi_ins_v,
                       torch.where(mf < 0.5 * c.f_rd, psi_int, psi_mrd))


def _row_v(x):
    return torch.stack([torch.ones_like(x), x, x * x, x ** 3, x ** 4], -1)


def _row_d(x):
    return torch.stack([torch.zeros_like(x), torch.ones_like(x), 2.0 * x,
                        3.0 * x * x, 4.0 * x ** 3], -1)


class PhenomDCoeffs(NamedTuple):
    """The per-signal constants of PhenomD, each of the parameters'
    broadcast shape: what phenomd_eval needs beside the frequencies. The
    phase joins are None when built without the phase."""
    tf2: TaylorF2Coeffs
    m_sec: torch.Tensor
    eta: torch.Tensor
    lam: dict                 # Table V's λ by name
    f_rd: torch.Tensor        # ringdown and damping frequencies [Mf]
    f_damp: torch.Tensor
    amp_ins: tuple            # (p23, p1, p43, p53, p2) of the inspiral
    fa3: torch.Tensor         # the amplitude peak [Mf]
    deltas: tuple             # the intermediate quartic's 5 coefficients
    c1_int: Optional[torch.Tensor]
    c2_int: Optional[torch.Tensor]
    c1_mrd: Optional[torch.Tensor]
    c2_mrd: Optional[torch.Tensor]


def phenomd_coeffs(mass_1, mass_2, chi_1, chi_2, luminosity_distance,
                   phase_c, phase: bool = True) -> PhenomDCoeffs:
    """The per-signal part of phenomd_amp_phase: the λ fits, the remnant's
    frequencies, the amplitude's collocation solve and, with `phase`, the
    phase joins."""
    m_sec = (mass_1 + mass_2) * MTSUN_SI
    eta = mass_1 * mass_2 / (mass_1 + mass_2) ** 2
    eta = torch.clamp_max(eta, 0.25)
    xi = chi_pn(eta, chi_1, chi_2) - 1.0

    lam = _lam_all(eta, xi)
    f_rd, f_damp = _ring_damp_geo(eta, chi_1, chi_2)
    # one TaylorF2 evaluation gives the inspiral phase and the Newtonian
    # amplitude prefactor
    tf2 = taylorf2_coeffs(mass_1, mass_2, chi_1, chi_2, luminosity_distance,
                          phase_c, phase=phase)
    joins = ((_phase_joins(m_sec, eta, lam, f_rd, f_damp, tf2)) if phase
             else (None,) * 4)

    coeffs = _amp_ins_coeffs(eta, chi_1, chi_2)
    rho1, rho2, rho3 = lam["rho1"], lam["rho2"], lam["rho3"]
    g1, g2, g3 = lam["gamma1"], lam["gamma2"], lam["gamma3"]
    f_peak = _amp_peak(f_rd, f_damp, g2, g3)
    fa1 = _AMP_F_JOIN_INS
    fa3 = f_peak
    fa2 = 0.5 * (fa1 + fa3)

    v1, d1 = _value_and_slope(
        lambda f: _amp_ins_stripped(f, coeffs, rho1, rho2, rho3),
        torch.full_like(eta, fa1))
    v3, d3 = _value_and_slope(
        lambda f: _amp_mrd_stripped(f, f_rd, f_damp, g1, g2, g3), fa3)
    v2 = lam["v2"]

    # quartic Δ(x) through (x1,v1,d1), (x2,v2), (1,v3,d3) in x = Mf/fa3, a
    # batched 5×5 collocation solve (the raw-Mf Vandermonde spans 8 decades
    # and is singular in float32)
    x1, x2 = fa1 / fa3, fa2 / fa3
    one = torch.ones_like(x1)
    mat = torch.stack([_row_v(x1), _row_v(x2), _row_v(one),
                       _row_d(x1), _row_d(one)], dim=-2)      # [..., 5, 5]
    rhs = torch.stack([v1, v2, v3, d1 * fa3, d3 * fa3], dim=-1)
    # solve_ex: no check of the pivots, which would wait on the device
    deltas = tuple(torch.linalg.solve_ex(mat, rhs)[0].unbind(-1))
    return PhenomDCoeffs(tf2, m_sec, eta, lam, f_rd, f_damp, coeffs, fa3,
                         deltas, *joins)


def phenomd_eval(freqs, c: PhenomDCoeffs, f_lower: float = 20.0,
                 phase: bool = True):
    """(amp, psi) [..., F] of PhenomD from its per-signal constants: each
    bin takes the amplitude and phase of the region it lies in."""
    mf = torch.clamp_min(freqs, 1.0) * c.m_sec
    tf2_amp, tf2_psi = taylorf2_eval(torch.clamp_min(freqs, 1.0), c.tf2,
                                     f_lower, phase=phase)
    psi = _phase(freqs, mf, tf2_psi, c) if phase else None

    amp_newt = torch.where(freqs >= f_lower, tf2_amp, 0.0)
    lam = c.lam
    g1, g2, g3 = lam["gamma1"], lam["gamma2"], lam["gamma3"]
    amp_ins = _amp_ins_stripped(mf, c.amp_ins, lam["rho1"], lam["rho2"],
                                lam["rho3"])
    d = c.deltas
    xs = mf / c.fa3
    amp_int = (d[0] + d[1] * xs + d[2] * xs * xs + d[3] * xs ** 3
               + d[4] * xs ** 4)
    amp_mrd = _amp_mrd_stripped(mf, c.f_rd, c.f_damp, g1, g2, g3)
    stripped = torch.where(mf < _AMP_F_JOIN_INS, amp_ins,
                           torch.where(mf < c.fa3, amp_int, amp_mrd))
    amp = amp_newt * torch.clamp_min(stripped, 0.0)
    amp = torch.where(freqs >= f_lower, amp, 0.0)
    return amp, psi


def phenomd_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                      luminosity_distance, phase_c, f_lower: float = 20.0,
                      phase: bool = True):
    """(amp, psi) [..., F] in scaled strain/Hz and rad, h̃ = A e^{-iΨ},
    coalescence at t = 0. With phase=False psi is None and the phase chain
    (its joins included) is not computed."""
    c = phenomd_coeffs(mass_1, mass_2, chi_1, chi_2, luminosity_distance,
                       phase_c, phase=phase)
    return phenomd_eval(freqs, c, f_lower, phase=phase)


def phenomd_polarizations(freqs, mass_1, mass_2, chi_1, chi_2,
                          luminosity_distance, theta_jn, phase_c,
                          f_lower: float = 20.0):
    """(h̃₊, h̃ₓ) [..., F] complex64 PhenomD waveform, coalescence at t = 0
    (posteriflow_tpu/physics/waveforms/phenomd.py:459)."""
    amp, psi = phenomd_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                                 luminosity_distance, phase_c, f_lower)
    return polarizations(amp, psi, theta_jn)
