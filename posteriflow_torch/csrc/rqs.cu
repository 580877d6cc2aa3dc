// Rational-quadratic spline (RQS) bijection, forward and inverse, for Hopper
// (sm_90a). Plain C interface, built with nvcc and loaded with ctypes by
// posteriflow_torch/ops/rqs_cuda.py.
//
// Replaces the TPU kernel posteriflow_tpu/ops/pallas_rqs.py:_pallas_rqs
// (:118, pallas_call at :136; body _spline_tile :37-106 and _kernel
// :109-115; entry points pallas_rqs_forward :164 and pallas_rqs_inverse
// :171). It computes what the plain version posteriflow_torch/ops/rqs.py
// computes, and follows that version where the Pallas body differs: the bin
// width is x_hi - x_lo of the pinned knots, not pick(w)·2B.
//
// Per row of x [N, D] with raw [N, D·(3K-1)], for each of the D dims:
// softmax widths and heights with a 1e-3 minimum; knot cumsum on [-B, B]
// with the end knots pinned to ±B; interior derivatives softplus + 1e-3,
// boundary derivatives 1; bin search (count of interior knots <= x); the RQ
// map (forward) or the stable quadratic root (inverse); log|dy/dx|; identity
// tails outside ±B. The logdet is summed over D in the thread: no atomics.
//
// Bound: memory. A call reads N·D·(3K-1) + N·D floats and writes N·D + N:
// at the flagship sampling shape (N = 131072, D = 7, K = 16) that is 180 MB,
// about 54 us at 3.35 TB/s, against about 0.5 GFLOP of f32 arithmetic.
// Design: one thread per row, K a template parameter so that the K-bin
// softmax, cumsum, knots and bin selection unroll into registers; no shared
// memory. Neighbouring threads read rows 4·D·(3K-1) bytes apart, so the
// loads are not coalesced: this first version is simple and right, not fast.
// Every sum runs left to right and every expression groups as in the plain
// version, and the library is built with -fmad=false: an inverse output moves
// by a knot's rounding error over the bin's slope, so the two versions must
// form the knots bit for bit alike to agree at 2e-5.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kMinBinWidth = 1e-3;
constexpr double kMinBinHeight = 1e-3;
constexpr float kMinDerivative = 1e-3f;
constexpr int kThreads = 128;

// softmax over K raw values, then the 1e-3 minimum bin size
template <int K>
__device__ __forceinline__ void bin_sizes(const float* __restrict__ r,
                                          float min_bin, float scale,
                                          float (&out)[K]) {
  float m = r[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, r[k]);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out[k] = expf(r[k] - m);
    sum += out[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = min_bin + scale * (out[k] / sum);
}

// knots [K+1] on [-B, B]: -B, cumsum·2B - B, ..., pinned B
template <int K>
__device__ __forceinline__ void knots(const float (&size)[K], float bound,
                                      float (&out)[K + 1]) {
  const float two_b = 2.f * bound;
  float cs = 0.f;
  out[0] = -bound;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    cs += size[k];
    out[k + 1] = cs * two_b - bound;
  }
  out[K] = bound;
}

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus with beta 1 and threshold 20
  return v > 20.f ? v : log1pf(expf(v));
}

template <int K, bool INVERSE>
__global__ void __launch_bounds__(kThreads)
rqs_rows(const float* __restrict__ x, const float* __restrict__ raw,
         float* __restrict__ out, float* __restrict__ logdet, int n, int d,
         float bound) {
  constexpr int R = 3 * K - 1;
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float min_w = (float)kMinBinWidth;
  const float scale_w = (float)(1.0 - kMinBinWidth * K);
  const float min_h = (float)kMinBinHeight;
  const float scale_h = (float)(1.0 - kMinBinHeight * K);

  const float* xr = x + row * d;
  const float* rr = raw + row * (long long)d * R;
  float* orow = out + row * d;
  float ld_sum = 0.f;

#pragma unroll 1
  for (int j = 0; j < d; ++j) {
    const float* r = rr + (long long)j * R;
    float w[K], h[K];
    bin_sizes<K>(r, min_w, scale_w, w);
    bin_sizes<K>(r + K, min_h, scale_h, h);
    float xk[K + 1], yk[K + 1], dk[K + 1];
    knots<K>(w, bound, xk);
    knots<K>(h, bound, yk);
    dk[0] = 1.f;
    dk[K] = 1.f;
#pragma unroll
    for (int k = 1; k < K; ++k) dk[k] = kMinDerivative + softplus(r[2 * K + k - 1]);

    const float v = xr[j];
    const bool inside = fabsf(v) <= bound;
    const float vs = fminf(fmaxf(v, -bound), bound);

    // bin index: count of interior knots <= v, then select that bin's ends
    int idx = 0;
#pragma unroll
    for (int k = 1; k < K; ++k) idx += (vs >= (INVERSE ? yk[k] : xk[k])) ? 1 : 0;
    float x_lo = xk[0], x_hi = xk[1], y_lo = yk[0], y_hi = yk[1];
    float d_lo = dk[0], d_hi = dk[1];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      if (idx == k) {
        x_lo = xk[k]; x_hi = xk[k + 1];
        y_lo = yk[k]; y_hi = yk[k + 1];
        d_lo = dk[k]; d_hi = dk[k + 1];
      }
    }

    const float wb = x_hi - x_lo;
    const float hb = y_hi - y_lo;
    const float s = hb / wb;
    const float dsum = d_hi + d_lo - 2.f * s;
    float theta;
    if (INVERSE) {
      const float dy = vs - y_lo;
      const float a = hb * (s - d_lo) + dy * dsum;
      const float b = hb * d_lo - dy * dsum;
      const float c = -s * dy;
      const float disc = fmaxf(b * b - 4.f * a * c, 0.f);
      theta = 2.f * c / (-b - sqrtf(disc) - 1e-30f);
    } else {
      theta = (vs - x_lo) / wb;
    }
    theta = fminf(fmaxf(theta, 0.f), 1.f);
    const float t1m = 1.f - theta;
    const float tt = theta * t1m;
    const float denom = s + dsum * tt;
    const float theta2 = theta * theta;
    const float dydx = s * s * (d_hi * theta2 + 2.f * s * tt + d_lo * (t1m * t1m))
                       / (denom * denom);
    const float mapped = INVERSE ? x_lo + theta * wb
                                 : y_lo + hb * (s * theta2 + d_lo * tt) / denom;
    const float ld = logf(fmaxf(dydx, 1e-30f));
    orow[j] = inside ? mapped : v;
    ld_sum += inside ? (INVERSE ? -ld : ld) : 0.f;
  }
  logdet[row] = ld_sum;
}

template <int K>
void launch_rows(const float* x, const float* raw, float* out, float* logdet,
                 int n, int d, float bound, int inverse, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  if (inverse) {
    rqs_rows<K, true><<<grid, block, 0, stream>>>(x, raw, out, logdet, n, d, bound);
  } else {
    rqs_rows<K, false><<<grid, block, 0, stream>>>(x, raw, out, logdet, n, d, bound);
  }
}

}  // namespace

// x [n, d], raw [n, d·(3k-1)], out [n, d], logdet [n]: contiguous float32 on
// `device`. Returns the CUDA error code of the launch (0 on success).
extern "C" int pf_rqs_launch(const void* x, const void* raw, void* out,
                             void* logdet, int n, int d, int k,
                             float tail_bound, int inverse, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(raw);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(logdet);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4: launch_rows<4>(xf, rf, of, lf, n, d, tail_bound, inverse, s); break;
    case 8: launch_rows<8>(xf, rf, of, lf, n, d, tail_bound, inverse, s); break;
    case 16: launch_rows<16>(xf, rf, of, lf, n, d, tail_bound, inverse, s); break;
    case 32: launch_rows<32>(xf, rf, of, lf, n, d, tail_bound, inverse, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
