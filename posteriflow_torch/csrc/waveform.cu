// The training simulator's per-bin waveform work, for Hopper (sm_90a): the
// gate's amplitude-only SNR of every slot and the kept slots' whitened
// per-detector sum, evaluated bin by bin from a per-signal table. Plain C
// interface, built with nvcc and loaded with ctypes by
// posteriflow_torch/ops/waveform_cuda.py.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the jnp passes of
// physics/simulator.py. PyTorch runs them op by op: every branch of
// PhenomD at every bin, then a torch.where, ~3,200 operators a training
// batch over [N, F] and [N, 3, F] tensors (N = 5,120 slots, F = 8,193),
// dead slots included. Here a bin evaluates the one amplitude and phase
// region it lies in, from the signal's row of the table that
// posteriflow_torch/physics/signal_table.py builds once a batch (the
// enum below lists its columns, in COLUMNS' order), and nothing per bin
// reaches device memory but the output. The table and the precessing
// twist's coarse grid stay PyTorch's (signal_table.waveform_table,
// coarse_twist), ~1,500 small operators over [N] and [N, K] a batch: their
// float32 rounding is part of the waveform the training cell holds the
// port to (the phase joins' slopes come by autograd and cancel to ~1e-3
// of their terms), which an evaluation of its own here would not keep.
//
// Numbers: float32 throughout, the operations of signal_table.py's plain
// evaluation in its order, each rounded as PyTorch's card ops round it:
// x^(1/3) through a double pow as cbrt() takes it, IEEE division and
// square root, the accurate logf, expf, atanf, hypotf and sincosf (the
// phase reaches ~1e4 rad), the mod-1 cycles of the time shift by fmodf as
// torch.remainder, a division by a Python scalar as a product with its
// reciprocal (kInvRolloff), a product of a column and a scalar taken per
// bin. Built with -fmad=false, so no product is contracted into a sum that
// PyTorch rounds apart; the one fused form is PyTorch's own complex64
// product (cmul_torch). wf_sum adds the slots in torch.sum's order and so
// gives the plain pass's bits, which the training cell's check of its
// first gradient needs: sums off by 1e-8 to 2e-7 of their peak moved that
// gradient by 4-19 %. wf_snr sums its bins in an order of its own (within
// ~2e-7 of the plain SNR); only the gate reads it. The reductions run in
// a fixed order with no atomics: a launch is deterministic.
//
// Bound: special functions. wf_sum at the training shape evaluates ~42 M
// (slot, bin) points, ~17 M of them kept, each ~30 special-function
// operations (two double cube roots, logs, exps, an atan, three sincos)
// against the H100's ~4 T a second: ~0.2-0.5 ms; it writes sig_fd [B, 3,
// F] complex64, 201 MB at B = 1024, 60 us at 3.35 TB/s. wf_snr is the
// amplitude alone on every 2nd (precessing) or 4th (aligned) bin.
//
// Design:
// - wf_snr<PREC>: a block a slot. Its row goes to shared memory; each
//   thread sums its bins (a stride of the block) in order, then the block
//   sums the threads' partial sums by a fixed tree: warp shuffles, then
//   the warps' sums in warp order.
// - wf_sum<PREC>: a block an (event, chunk of kThreads bins), a bin a
//   thread. The block reads the event's keep mask and copies the kept
//   slots' rows to shared memory; each thread sums, in slot order, the
//   kept slots' three detector terms in registers and writes its bin of
//   the three detectors once.
// - PREC (the 15-parameter precessing set) interpolates the twist (SP, SM)
//   from its coarse grid as physics/waveforms/precession.py:twist_up does
//   (the chord, its modulus restored) and projects F₊, F× onto it; the
//   aligned set folds each detector's response into one magnitude and
//   phase, w_d and φ_d, read from the table.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kMaxSlots = 16;
constexpr int kDet = 3;

// physics/signal_table.py:COLUMNS, in order
enum Column {
  C_pim, C_k, C_eta128, C_p2, C_p3, C_p4, C_p5, C_p6, C_p7, C_twophi,
  C_m_sec, C_eta, C_f_rd, C_f_damp, C_fa3,
  C_d0, C_d1, C_d2, C_d3, C_d4,
  C_ap23, C_ap1, C_ap43, C_ap53, C_ap2,
  C_gamma1, C_gamma2, C_gamma3, C_v2, C_rho1, C_rho2, C_rho3,
  C_beta1, C_beta2, C_beta3,
  C_alpha1, C_alpha2, C_alpha3, C_alpha4, C_alpha5,
  C_sigma1, C_sigma2, C_sigma3, C_sigma4,
  C_c1_int, C_c2_int, C_c1_mrd, C_c2_mrd,
  C_pim_t, C_tidal, C_f_end, C_chi1z, C_chi2z, C_chi_p,
  C_tau0, C_tau1, C_tau2, C_fp0, C_fp1, C_fp2, C_fx0, C_fx1, C_fx2,
  C_w0, C_w1, C_w2, C_phi0, C_phi1, C_phi2, C_wsq0, C_wsq1, C_wsq2,
  C_count
};

// the Python constants, rounded to float32 as PyTorch rounds a scalar
constexpr float kAmpJoin = 0.014f;                 // phenomd._AMP_F_JOIN_INS
constexpr float kPhiJoin = 0.018f;                 // phenomd._PHI_F_JOIN_INS
constexpr float kP6Log = (float)(-6848.0 / 21.0);  // taylorf2._P6_LOG
constexpr float kPi4 = (float)(3.141592653589793 / 4.0);
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kFourThirds = (float)(4.0 / 3.0);
// tidal._taper divides by the rolloff 0.12; PyTorch on the card multiplies
// by the scalar divisor's reciprocal, taken in double and rounded to float
constexpr float kInvRolloff = (float)(1.0 / 0.12);

__device__ __forceinline__ float cbrt_f(float x) {
  return (float)pow((double)x, 1.0 / 3.0);
}

// torch.remainder(x, 1.0)
__device__ __forceinline__ float mod1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// PhenomD × matter at one bin: the amplitude and, with PHASE, Ψ + ψ_T.
// freq ≥ f_lower ≥ 1 (the caller gives bins below f_lower nothing).
template <bool PHASE>
__device__ __forceinline__ void amp_phase(const float* c, float freq,
                                          float& amp, float& psi) {
  const float f = fmaxf(freq, 1.0f);
  const float mf = f * c[C_m_sec];
  const float v = cbrt_f(c[C_pim] * f);
  const float v3 = v * v * v;
  const float amp_newt = c[C_k] / (v3 * sqrtf(v));

  float mf13 = 0.0f;
  float s;
  if (mf < kAmpJoin) {               // inspiral: PN series + ρ fits
    mf13 = cbrt_f(mf);
    const float mf23 = mf13 * mf13;
    const float mf43 = mf23 * mf23;
    const float mf53 = mf43 * mf13;
    const float mf2 = mf * mf;
    const float mf73 = mf2 * mf13;
    const float mf83 = mf73 * mf13;
    s = 1.0f + c[C_ap23] * mf23;
    s = s + c[C_ap1] * mf;
    s = s + c[C_ap43] * mf43;
    s = s + c[C_ap53] * mf53;
    s = s + c[C_ap2] * mf2;
    s = s + c[C_rho1] * mf73;
    s = s + c[C_rho2] * mf83;
    s = s + c[C_rho3] * mf2 * mf;
  } else if (mf < c[C_fa3]) {        // intermediate quartic in Mf / fa3
    const float xs = mf / c[C_fa3];
    s = c[C_d0] + c[C_d1] * xs;
    s = s + c[C_d2] * xs * xs;
    s = s + c[C_d3] * (xs * xs * xs);
    s = s + c[C_d4] * powf(xs, 4.0f);
  } else {                           // merger-ringdown
    const float fdg3 = c[C_f_damp] * c[C_gamma3];
    const float dv = mf - c[C_f_rd];
    s = expf(-dv * c[C_gamma2] / fdg3) * (fdg3 * c[C_gamma1])
        / (dv * dv + fdg3 * fdg3);
  }
  s = s < 0.0f ? 0.0f : s;           // clamp_min(·, 0), NaN kept
  float x = logf(f / c[C_f_end]) * kInvRolloff;
  x = fminf(fmaxf(x, -30.0f), 30.0f);
  amp = (amp_newt * s) * ((1.0f / (1.0f + expf(x))) * 1.0f);
  if (!PHASE) return;

  float p;
  if (mf < kPhiJoin) {               // TaylorF2 + σ
    const float v2 = v * v;
    const float v4 = v2 * v2, v5 = v2 * v3, v6 = v3 * v3;
    const float v7 = v3 * v4;
    const float logv = logf(v);
    float series = 1.0f + c[C_p2] * v2;
    series = series + c[C_p3] * v3;
    series = series + c[C_p4] * v4;
    series = series + c[C_p5] * (1.0f + 3.0f * logv) * v5;
    series = series + (c[C_p6] + kP6Log * logv) * v6;
    series = series + c[C_p7] * v7;
    p = ((1.0f / (c[C_eta128] * v5)) * 3.0f) * series;
    p = (p - c[C_twophi]) - kPi4;
    if (mf13 == 0.0f) mf13 = cbrt_f(mf);
    const float mf43 = mf * mf13;
    const float mf53 = mf43 * mf13;
    float sg = c[C_sigma1] * mf + (0.75f * c[C_sigma2]) * mf43;
    sg = sg + (0.6f * c[C_sigma3]) * mf53;
    sg = sg + (0.5f * c[C_sigma4]) * mf * mf;
    p = p + sg / c[C_eta];
  } else if (mf < 0.5f * c[C_f_rd]) {  // β ansatz
    float phi = c[C_beta1] * mf + c[C_beta2] * logf(mf);
    phi = phi - c[C_beta3] / (3.0f * (mf * mf * mf));
    p = (phi / c[C_eta] + c[C_c1_int]) + c[C_c2_int] * f;
  } else {                           // α ansatz
    const float mf14 = sqrtf(sqrtf(mf));
    float phi = c[C_alpha1] * mf - c[C_alpha2] / mf;
    phi = phi + (kFourThirds * c[C_alpha3]) * (mf / mf14);
    phi = phi + c[C_alpha4]
                    * atanf((mf - c[C_alpha5] * c[C_f_rd]) / c[C_f_damp]);
    p = (phi / c[C_eta] + c[C_c1_mrd]) + c[C_c2_mrd] * f;
  }
  if (c[C_tidal] != 0.0f) {          // ψ_T; exactly 0 without matter
    const float vt = cbrt_f(c[C_pim_t] * f);
    const float vt2 = vt * vt;
    const float vt5 = vt2 * vt2 * vt;
    const float vt7 = vt5 * vt2;
    p = p + c[C_tidal] * (19.5f * vt5 + 48.671875f * vt7);
  }
  psi = p;
}

// twist_up of one coarse factor x [K] at a bin of segment s, weight w
__device__ __forceinline__ float2 twist_at(const float2* x, int s, float w) {
  const float2 lo = x[s], hi = x[s + 1];
  const float2 u = make_float2(lo.x + w * (hi.x - lo.x),
                               lo.y + w * (hi.y - lo.y));
  const float m_lo = hypotf(lo.x, lo.y);
  const float m_u = m_lo + w * (hypotf(hi.x, hi.y) - m_lo);
  const float r = m_u / fmaxf(hypotf(u.x, u.y), 1e-12f);
  return make_float2(u.x * r, u.y * r);
}

// the complex response of detector d: F₊ (SP+SM)/2 + i F× (SP−SM)/2
__device__ __forceinline__ float2 response_d(const float* c, int d,
                                             float2 sp, float2 sm) {
  const float ar = 0.5f * (sp.x + sm.x), ai = 0.5f * (sp.y + sm.y);
  const float br = 0.5f * (sp.x - sm.x), bi = 0.5f * (sp.y - sm.y);
  const float fp = c[C_fp0 + d], fx = c[C_fx0 + d];
  return make_float2(fp * ar - fx * bi, fp * ai + fx * br);
}

__device__ __forceinline__ float block_sum(float x, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) scratch[warp] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kWarps; ++k) total += scratch[k];
  }
  return total;
}

// snr[n] = sqrt(dec · Σ_j A(f_j)² Σ_d |r_d(f_j)|² / ASD_d(f_j)²) over the
// bins f_j = j·dec·Δf, j < n_bins, of signal n (r_d = w_d aligned,
// |c_d|/2 precessing)
template <bool PREC>
__global__ void __launch_bounds__(kThreads) wf_snr(
    const float* __restrict__ table, const float2* __restrict__ sp,
    const float2* __restrict__ sm, int k_coarse,
    const int64_t* __restrict__ seg, const float* __restrict__ seg_w,
    const float* __restrict__ asd, int asd_stride, int n_bins, int dec,
    float delta_f, float f_lower, float* __restrict__ snr) {
  __shared__ float row[C_count];
  __shared__ float scratch[kWarps];
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < C_count; i += kThreads)
    row[i] = table[(size_t)n * C_count + i];
  __syncthreads();
  const float2* spn = sp + (size_t)n * k_coarse;
  const float2* smn = sm + (size_t)n * k_coarse;
  float acc = 0.0f;
  for (int j = threadIdx.x; j < n_bins; j += kThreads) {
    const float freq = (float)(j * dec) * delta_f;
    if (!(freq >= f_lower)) continue;
    float amp, psi;
    amp_phase<false>(row, freq, amp, psi);
    float band = 0.0f;
    if (PREC) {
      const int s = (int)seg[j];
      const float w = seg_w[j];
      const float2 p = twist_at(spn, s, w), m = twist_at(smn, s, w);
      for (int d = 0; d < kDet; ++d) {
        const float2 r = response_d(row, d, p, m);
        const float h = hypotf(r.x, r.y);
        const float a = fmaxf(asd[d * asd_stride + j * dec], 1e-38f);
        band = band + (h * h) * ((1.0f / (a * a)) * 1.0f);
      }
      const float half = 0.5f * amp;
      acc += (half * half) * band;
    } else {
      for (int d = 0; d < kDet; ++d) {
        const float a = fmaxf(asd[d * asd_stride + j * dec], 1e-38f);
        band = band + row[C_wsq0 + d] * ((1.0f / (a * a)) * 1.0f);
      }
      acc += (amp * amp) * band;
    }
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) snr[n] = sqrtf((float)dec * total);
}

// carrier × response as PyTorch's complex64 product rounds it: each part
// one product fused into the other's sum
__device__ __forceinline__ float2 cmul_torch(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -(a.y * b.y)),
                     __fmaf_rn(a.x, b.y, a.y * b.x));
}

// out[b, d, j] = Σ over the kept slots s of event b of the whitened strain
// of slot s in detector d at bin j, in the order of torch.sum over the
// slots: four partial sums, slot s into sum s mod 4 in slot order, then
// ((Σ0 + Σ1) + Σ2) + Σ3 (a dead slot adds an exact zero there)
template <bool PREC>
__global__ void __launch_bounds__(kThreads) wf_sum(
    const float* __restrict__ table, const float* __restrict__ keep,
    int n_slots, const float2* __restrict__ sp,
    const float2* __restrict__ sm, int k_coarse,
    const int64_t* __restrict__ seg, const float* __restrict__ seg_w,
    const float* __restrict__ asd, int n_bins, float delta_f,
    float f_lower, float sqrt_4df, float2* __restrict__ out) {
  __shared__ float rows[kMaxSlots][C_count];
  __shared__ int kept[kMaxSlots];
  __shared__ int n_kept;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    int k = 0;
    for (int s = 0; s < n_slots; ++s)
      if (keep[(size_t)b * n_slots + s] != 0.0f) kept[k++] = s;
    n_kept = k;
  }
  __syncthreads();
  const int nk = n_kept;
  for (int i = threadIdx.x; i < nk * C_count; i += kThreads) {
    const int k = i / C_count, col = i - k * C_count;
    rows[k][col] =
        table[((size_t)b * n_slots + kept[k]) * C_count + col];
  }
  __syncthreads();
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= n_bins) return;
  const float freq = (float)j * delta_f;
  float2 acc[4][kDet];
  for (int q = 0; q < 4; ++q)
    for (int d = 0; d < kDet; ++d) acc[q][d] = make_float2(0.0f, 0.0f);
  if (freq >= f_lower) {
    float asd_j[kDet];
    for (int d = 0; d < kDet; ++d)
      asd_j[d] = fmaxf(asd[d * n_bins + j], 1e-38f);
    int s = 0;
    float w = 0.0f;
    if (PREC) {
      s = (int)seg[j];
      w = seg_w[j];
    }
    for (int k = 0; k < nk; ++k) {
      const float* c = rows[k];
      float amp, psi;
      amp_phase<true>(c, freq, amp, psi);
      float2 p = make_float2(0.0f, 0.0f), m = p;
      if (PREC) {
        const size_t base = ((size_t)b * n_slots + kept[k]) * k_coarse;
        p = twist_at(sp + base, s, w);
        m = twist_at(sm + base, s, w);
      }
      for (int d = 0; d < kDet; ++d) {
        const float cyc = mod1(freq * c[C_tau0 + d]);
        float theta = psi + kTwoPi * cyc;
        float mag;
        if (PREC) {
          mag = ((0.5f * amp) / asd_j[d]) * sqrt_4df;
        } else {
          theta = theta - c[C_phi0 + d];
          mag = ((amp * c[C_w0 + d]) / asd_j[d]) * sqrt_4df;
        }
        float sn, cs;
        sincosf(theta, &sn, &cs);
        float2 h = make_float2(mag * cs, mag * -sn);
        if (PREC) h = cmul_torch(h, response_d(c, d, p, m));
        float2& a = acc[kept[k] & 3][d];
        a = make_float2(a.x + h.x, a.y + h.y);
      }
    }
  }
  for (int d = 0; d < kDet; ++d) {
    float2 t = acc[0][d];
    for (int q = 1; q < 4; ++q)
      t = make_float2(t.x + acc[q][d].x, t.y + acc[q][d].y);
    out[((size_t)b * kDet + d) * n_bins + j] = t;
  }
}

int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return (int)err;
}

}  // namespace

extern "C" int pf_wf_columns() { return C_count; }

// snr [n] of the n table rows [n, C_count]: the gate's amplitude-only SNR on
// n_bins bins f_j = j·dec·delta_f; asd [3, asd_stride] float32 with
// asd_stride ≥ (n_bins − 1)·dec + 1. prec: the precessing set, whose coarse
// twist sp, sm [n, k_coarse] complex64 and grid seg [n_bins] (int64, each
// < k_coarse − 1) and seg_w [n_bins] are read; otherwise they may be null.
// Returns the CUDA error code of the launch.
extern "C" int pf_wf_snr_launch(const void* table, int n, const void* sp,
                                const void* sm, int k_coarse, const void* seg,
                                const void* seg_w, const void* asd,
                                int asd_stride, int n_bins, int dec,
                                float delta_f, float f_lower, int prec,
                                float* snr, int device, void* stream) {
  if (n <= 0 || n_bins <= 0 || dec <= 0 || asd_stride < (n_bins - 1) * dec + 1
      || (prec && (k_coarse < 2 || sp == nullptr || sm == nullptr
                   || seg == nullptr || seg_w == nullptr))
      || device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float2* p = static_cast<const float2*>(sp);
  const float2* m = static_cast<const float2*>(sm);
  const int64_t* sg = static_cast<const int64_t*>(seg);
  const float* w = static_cast<const float*>(seg_w);
  const float* a = static_cast<const float*>(asd);
  if (prec) {
    wf_snr<true><<<n, kThreads, 0, st>>>(t, p, m, k_coarse, sg, w, a,
                                         asd_stride, n_bins, dec, delta_f,
                                         f_lower, snr);
  } else {
    wf_snr<false><<<n, kThreads, 0, st>>>(t, p, m, k_coarse, sg, w, a,
                                          asd_stride, n_bins, dec, delta_f,
                                          f_lower, snr);
  }
  return (int)cudaGetLastError();
}

// out [b, 3, n_bins] complex64 = the kept slots' whitened strain summed an
// event: table [b · n_slots, C_count], keep [b, n_slots] float32 (a slot is
// kept where it is not 0), asd [3, n_bins]; prec as above, the twist on the
// full grid.
extern "C" int pf_wf_sum_launch(const void* table, const void* keep, int b,
                                int n_slots, const void* sp, const void* sm,
                                int k_coarse, const void* seg,
                                const void* seg_w, const void* asd,
                                int n_bins, float delta_f, float f_lower,
                                float sqrt_4df, int prec, void* out,
                                int device, void* stream) {
  if (b <= 0 || n_slots <= 0 || n_slots > kMaxSlots
      || n_bins <= 0
      || (prec && (k_coarse < 2 || sp == nullptr || sm == nullptr
                   || seg == nullptr || seg_w == nullptr))
      || device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(b, (n_bins + kThreads - 1) / kThreads);
  const float* t = static_cast<const float*>(table);
  const float* k = static_cast<const float*>(keep);
  const float2* p = static_cast<const float2*>(sp);
  const float2* m = static_cast<const float2*>(sm);
  const int64_t* sg = static_cast<const int64_t*>(seg);
  const float* w = static_cast<const float*>(seg_w);
  const float* a = static_cast<const float*>(asd);
  float2* o = static_cast<float2*>(out);
  if (prec) {
    wf_sum<true><<<grid, kThreads, 0, st>>>(t, k, n_slots, p, m, k_coarse, sg,
                                            w, a, n_bins, delta_f, f_lower,
                                            sqrt_4df, o);
  } else {
    wf_sum<false><<<grid, kThreads, 0, st>>>(t, k, n_slots, p, m, k_coarse,
                                             sg, w, a, n_bins, delta_f,
                                             f_lower, sqrt_4df, o);
  }
  return (int)cudaGetLastError();
}
