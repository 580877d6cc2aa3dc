// Rational-quadratic spline (RQS) bijection, forward and inverse, for Hopper
// (sm_90a), and the backward of the forward (rqs_grad, after rqs_tile).
// Plain C interface, built with nvcc and loaded with ctypes by
// posteriflow_torch/ops/rqs_cuda.py.
//
// Replaces the TPU kernel posteriflow_tpu/ops/pallas_rqs.py:_pallas_rqs
// (:118, pallas_call at :136; body _spline_tile :37-106 and _kernel
// :109-115; entry points pallas_rqs_forward :164 and pallas_rqs_inverse
// :171). It computes what the plain version posteriflow_torch/ops/rqs.py
// computes on raw + bias, and follows that version where the Pallas body
// differs: the bin width is x_hi - x_lo of the pinned knots, not pick(w)·2B.
//
// Per (row, dim) spline of x [N, D] with raw [N, D·(3K-1)]: softmax widths
// and heights with a 1e-3 minimum; knot cumsum on [-B, B] with the end knots
// pinned to ±B; interior derivatives softplus + 1e-3, boundary derivatives
// 1; bin search (count of interior knots <= x); the RQ map (forward) or the
// stable quadratic root (inverse); log|dy/dx|; identity tails outside ±B.
// The logdet is summed over D per row.
//
// Bound: memory. A call reads N·D·(3K-1) + N·D + 3K-1 floats and writes
// N·D + N: at the flagship sampling shape (N = 131072, D = 7, K = 16) that
// is 180 MB, about 54 us at 3.35 TB/s. Its f32 work, near two thousand
// instructions a spline as compiled (K-way softmax twice with IEEE
// divisions, two softplus, the map), fills most of that time in issue
// slots, so the loads must stream while the splines are computed.
//
// Design:
// - A ring of kStages stages in shared memory, each one tile: rows_per_tile
//   consecutive rows of raw (one contiguous span) and of x, brought in by
//   two TMA bulk copies (cp.async.bulk, L2 evict-first: each byte is read
//   once) that complete on the stage's mbarrier. Blocks are persistent and
//   walk tiles blockIdx.x + i·gridDim.x; while a block computes tile i,
//   tile i+1 is in flight, and the barrier after tile i frees its stage
//   for tile i+2. The bytes in flight no longer depend on how many
//   register-heavy threads fit on an SM: one stage of a block is 48 KB at
//   the flagship shape. rows_per_tile is a multiple of 4, so every copy is
//   16-B aligned and a multiple of 16 B; the ragged last tile (N mod
//   rows_per_tile rows) is read with coalesced plain loads.
// - One thread per (row, dim) spline. Thread t of a tile takes word t·(3K-1)
//   of the stage; 3K-1 is odd, so a warp's 32 threads hit 32 banks. x is
//   read from the stage and out written at row0·D + t: coalesced. Each
//   spline's logdet goes to shared memory (two turns, so one barrier a tile
//   serves), and one thread per row sums the row's D terms in dim order.
// - The conditioner's bias [3K-1] is added to each raw value as it is read
//   from shared memory (one f32 add, as PyTorch's elementwise +), which
//   saves the separate pass over raw that the add would otherwise cost.
// - The bin search runs on the knots of the searched axis only; the other
//   axis's knots are formed in turn and the two around the bin kept, and
//   softplus is taken for the bin's two interior derivatives alone.
// - K is a template parameter, so the K-bin softmax, cumsum and selection
//   unroll into registers; D is a runtime argument.
// Every sum runs left to right (the logdet over D too) and every expression
// groups as in the plain version, and the library is built with
// -fmad=false: an inverse output moves by a knot's rounding error over the
// bin's slope, so the two versions form the knots bit for bit alike and
// their outputs and logdets agree exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kMinBinWidth = 1e-3;
constexpr double kMinBinHeight = 1e-3;
constexpr float kMinDerivative = 1e-3f;
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kBarrierBytes = 128;   // the stages' mbarriers, ahead of the ring
constexpr int kMaxDevices = 64;

// Dynamic shared memory of a block: [mbarriers | stage 0 .. stage S-1 |
// logdet per spline, two turns | bias]; a stage holds a tile's raw, then
// its x. ops/rqs_cuda.py:smem_bytes mirrors it.
long long smem_layout_bytes(int rows, int d, int k) {
  const long long r = 3 * k - 1;
  return kBarrierBytes + (long long)kStages * rows * d * (r + 1) * 4
         + 2 * 4LL * rows * d + 4LL * r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// A tile lands within microseconds; a wait of 2^24 tries means a copy that
// was never issued, and the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16 at 16-B aligned addresses;
// completion is counted on `bar`. The lines are marked evict-first in L2:
// every byte is read once, and the stream should not push out what the
// rest of the card keeps there.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(policy)
      : "memory");
}

template <bool BIAS>
__device__ __forceinline__ float raw_at(const float* r, const float* b,
                                        int k) {
  return BIAS ? r[k] + b[k] : r[k];
}

// e[k] = exp(v_k - max v) of K raw values; returns their sum, left to right
template <int K, bool BIAS>
__device__ __forceinline__ float softmax_exp(const float* r, const float* b,
                                             float (&e)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = raw_at<BIAS>(r, b, k);
  float m = e[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, e[k]);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = expf(e[k] - m);
    sum += e[k];
  }
  return sum;
}

// knots [K+1] on [-B, B]: -B, cumsum(size)·2B - B, ..., pinned B, with
// size = min_bin + scale·softmax
template <int K, bool BIAS>
__device__ __forceinline__ void knots(const float* r, const float* b,
                                      float min_bin, float scale, float bound,
                                      float (&kn)[K + 1]) {
  float e[K];
  const float sum = softmax_exp<K, BIAS>(r, b, e);
  const float two_b = 2.f * bound;
  float cs = 0.f;
  kn[0] = -bound;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    cs += min_bin + scale * (e[k] / sum);
    kn[k + 1] = cs * two_b - bound;
  }
  kn[K] = bound;
}

// knots idx and idx + 1 of the same construction, formed in turn
template <int K, bool BIAS>
__device__ __forceinline__ void knot_pair(const float* r, const float* b,
                                          float min_bin, float scale,
                                          float bound, int idx, float& lo,
                                          float& hi) {
  float e[K];
  const float sum = softmax_exp<K, BIAS>(r, b, e);
  const float two_b = 2.f * bound;
  float cs = 0.f;
  lo = -bound;
  hi = bound;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    cs += min_bin + scale * (e[k] / sum);
    const float kn = cs * two_b - bound;
    if (idx == k + 1) lo = kn;
    if (idx == k) hi = kn;
  }
}

__device__ __forceinline__ float softplus(float v) {
  // torch.nn.functional.softplus with beta 1 and threshold 20
  return v > 20.f ? v : log1pf(expf(v));
}

// One spline: r -> its 3K-1 raw values (b the bias), v the input.
// Returns the output; *ld gets its log|dy/dx| (negated for the inverse,
// 0 in the tails).
template <int K, bool INVERSE, bool BIAS>
__device__ __forceinline__ float spline(const float* r, const float* b,
                                        float v, float bound, float* ld) {
  const float min_w = (float)kMinBinWidth;
  const float scale_w = (float)(1.0 - kMinBinWidth * K);
  const float min_h = (float)kMinBinHeight;
  const float scale_h = (float)(1.0 - kMinBinHeight * K);
  const bool inside = fabsf(v) <= bound;
  const float vs = fminf(fmaxf(v, -bound), bound);

  // the searched axis: knots of y for the inverse, of x for the forward
  float kn[K + 1];
  if (INVERSE) {
    knots<K, BIAS>(r + K, b + K, min_h, scale_h, bound, kn);
  } else {
    knots<K, BIAS>(r, b, min_w, scale_w, bound, kn);
  }
  // bin index: count of interior knots <= v, then that bin's ends
  int idx = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) idx += (vs >= kn[k]) ? 1 : 0;
  float s_lo = kn[0], s_hi = kn[1];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (idx == k) {
      s_lo = kn[k];
      s_hi = kn[k + 1];
    }
  }
  float o_lo, o_hi;
  if (INVERSE) {
    knot_pair<K, BIAS>(r, b, min_w, scale_w, bound, idx, o_lo, o_hi);
  } else {
    knot_pair<K, BIAS>(r + K, b + K, min_h, scale_h, bound, idx, o_lo, o_hi);
  }
  const float x_lo = INVERSE ? o_lo : s_lo, x_hi = INVERSE ? o_hi : s_hi;
  const float y_lo = INVERSE ? s_lo : o_lo, y_hi = INVERSE ? s_hi : o_hi;
  // derivatives at the bin's ends: 1 at the boundary knots
  const int i_lo = 2 * K + (idx > 0 ? idx - 1 : 0);
  const int i_hi = 2 * K + (idx < K - 1 ? idx : K - 2);
  const float d_lo =
      idx == 0 ? 1.f : kMinDerivative + softplus(raw_at<BIAS>(r, b, i_lo));
  const float d_hi =
      idx == K - 1 ? 1.f : kMinDerivative + softplus(raw_at<BIAS>(r, b, i_hi));

  const float wb = x_hi - x_lo;
  const float hb = y_hi - y_lo;
  const float s = hb / wb;
  const float dsum = d_hi + d_lo - 2.f * s;
  float theta;
  if (INVERSE) {
    const float dy = vs - y_lo;
    const float a = hb * (s - d_lo) + dy * dsum;
    const float bq = hb * d_lo - dy * dsum;
    const float c = -s * dy;
    const float disc = fmaxf(bq * bq - 4.f * a * c, 0.f);
    theta = 2.f * c / (-bq - sqrtf(disc) - 1e-30f);
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
  const float l = logf(fmaxf(dydx, 1e-30f));
  *ld = inside ? (INVERSE ? -l : l) : 0.f;
  return inside ? mapped : v;
}

template <int K, bool INVERSE, bool BIAS>
__global__ void __launch_bounds__(kThreads, 2)
rqs_tile(const float* __restrict__ x, const float* __restrict__ raw,
         const float* __restrict__ bias, float* __restrict__ out,
         float* __restrict__ logdet, int n, int d, int rows_per_tile,
         float bound) {
  constexpr int R = 3 * K - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int tile_splines = rows_per_tile * d;
  const int stage_floats = tile_splines * (R + 1);   // raw, then x
  float* s_ld = ring + kStages * stage_floats;       // two turns of logdets
  float* s_bias = s_ld + 2 * tile_splines;

  const int n_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int n_full = n / rows_per_tile;        // tiles the bulk copy takes
  const uint32_t raw_bytes = (uint32_t)(tile_splines * R) * 4u;
  const uint32_t x_bytes = (uint32_t)tile_splines * 4u;
  const int mine = (int)blockIdx.x < n_tiles
                       ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (BIAS) {
    for (int k = threadIdx.x; k < R; k += blockDim.x) s_bias[k] = bias[k];
  }
  __syncthreads();

  // thread 0: tile j of this block, raw and x, into stage j % kStages, if
  // it is full
  auto issue = [&](int j) {
    const int tile = (int)blockIdx.x + j * (int)gridDim.x;
    if (j < mine && tile < n_full) {
      uint64_t* bar = &full[j % kStages];
      float* st = ring + (j % kStages) * stage_floats;
      mbar_expect_tx(bar, raw_bytes + x_bytes);
      bulk_load(st, raw + (long long)tile * tile_splines * R, raw_bytes, bar);
      bulk_load(st + tile_splines * R, x + (long long)tile * tile_splines,
                x_bytes, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int j = 0; j < kStages; ++j) issue(j);
  }

  uint32_t phase = 0;   // bit s: parity of stage s's next completion
  for (int j = 0; j < mine; ++j) {
    const int tile = (int)blockIdx.x + j * (int)gridDim.x;
    const int s = j % kStages;
    float* st = ring + s * stage_floats;
    float* st_x = st + tile_splines * R;
    float* ld_turn = s_ld + (j & 1) * tile_splines;
    const long long row0 = (long long)tile * rows_per_tile;
    const int rows = (int)min((long long)rows_per_tile, (long long)n - row0);
    const int splines = rows * d;
    if (tile < n_full) {
      mbar_wait(&full[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    } else {
      // the ragged last tile: coalesced plain loads
      const float* src = raw + row0 * d * R;
      for (int i = threadIdx.x; i < splines * R; i += blockDim.x) {
        st[i] = src[i];
      }
      for (int i = threadIdx.x; i < splines; i += blockDim.x) {
        st_x[i] = x[row0 * d + i];
      }
      __syncthreads();
    }
    for (int t = threadIdx.x; t < splines; t += blockDim.x) {
      float ld;
      out[row0 * d + t] =
          spline<K, INVERSE, BIAS>(st + t * R, s_bias, st_x[t], bound, &ld);
      ld_turn[t] = ld;
    }
    // stage s is read and this turn's logdets written: the stage takes tile
    // j + kStages while the rows are summed and tile j + 1 is computed
    __syncthreads();
    if (threadIdx.x == 0) issue(j + kStages);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float sum = ld_turn[r * d];
      for (int jd = 1; jd < d; ++jd) sum += ld_turn[r * d + jd];
      logdet[row0 + r] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward of the forward direction: rqs_grad<K, BIAS>.
//
// The TPU package has no Pallas VJP: it trains through the XLA spline
// (posteriflow_tpu/models/flow.py:96, use_pallas=False). Here the training
// path runs rqs_tile<K, false, BIAS> forward, and this kernel gives the
// gradients that autograd through the plain version
// (posteriflow_torch/ops/rqs.py rqs_forward_vjp) gives: for upstream g_out
// [N, D] and g_logdet [N], g_x [N, D] and g_raw [N, D·(3K-1)]. The bias is
// a constant (the conditioner's derivative init) and gets no gradient.
//
// Bound: it reads x, raw, g_out, g_logdet and writes g_x, g_raw: at the
// training shape (N = 640, D = 7, K = 16) 1.74 MB, half a microsecond at
// 3.35 TB/s. There the launch (about a microsecond for any kernel) and the
// instructions each SM issues for its ~17 warps set the time: the design
// spreads the 4,480 splines over every SM, keeps each lane's chain short
// and takes the IEEE divisions (with their slow-path branches) only where
// the forward's bits or autograd's clamp need them. At N = 131072 it moves
// 357 MB, and instruction issue bounds it: the lanes of a spline repeat
// the left-to-right sums and the map, so a spline costs G/32 of a warp's
// instructions (G below) where one thread a spline cost 1/32 of a longer
// chain (times in PERF.md).
//
// Design: a group of G lanes a spline, G = K rounded up to a power of two
// (shuffle widths must be powers of two), 32/G splines a warp (G divides
// 32, so a group never straddles warps), kGradThreads threads a block.
// Lane j < K holds raw[j] (width), raw[K+j] (height) and, for j < K-1,
// raw[2K+j] (interior derivative), each with its bias: three runs of K
// contiguous floats that a warp loads and stores coalesced, with no shared
// memory. Where K is not a power of two (K = 12: G = 16) lanes K..G-1 pad
// the group: they load nothing and store nothing, hold -inf as their width
// and height (so they add -inf to the max and 0 to every sum, the
// butterfly included) and stay alive for the shuffles. For K a power of
// two G = K and the padding conditions are compile-time true.
// - The forward's knots, bit for bit: the softmax's max by shuffle (exact in
//   any order); each lane its own exp and IEEE division with the forward's
//   expressions (softmax_exp, knots; built with -fmad=false); the sum of
//   the exps and the knot cumsum left to right, as the forward takes them:
//   each lane gathers the group's K values by independent shuffles and runs
//   the same chain of adds. Lane j keeps knot j+1 (lane K-1 the pinned end
//   B); the bin is the count of interior knots <= x, by a ballot over the
//   group with the forward's comparison. So a point on a knot lands in the
//   forward's bin.
// - The bin's ends and derivatives come by shuffle from lanes idx-1 and
//   idx, and every lane of the group runs the RQ map and its reverse on
//   them (one short scalar chain, the same on every lane: no divergence).
//   Only the bin must be the forward's; the map's values enter only the
//   gradient, so its quotients other than theta are fast reciprocals, and
//   log dydx is differentiated as 2 log s + log m - 2 log denom.
// - The reverse, per lane, as autograd takes clamp and where: the gradient
//   passes clamp(theta, 0, 1) inclusive of the ends and max(dydx, 1e-30)
//   where dydx >= 1e-30; softplus' is 1 above 20; in the tails g_x = g_out
//   and g_raw = 0. A knot i moves with every bin size j < i (times 2B; the
//   pinned ends take nothing), so lane j's gradient on its softmax entry is
//   scale·2B·((j < idx ? c_lo : 0) + (j <= idx ? c_hi : 0)), and lane j's
//   raw gets p_j·(g_p_j - Σ p_i g_p_i). The bin's two derivative terms go
//   to lanes idx-1 and idx.
// Not in autograd's order: Σ p_i g_p_i is a butterfly over the group
// (autograd goes through the division, the left-to-right sum, the exp and
// the max), and the map's reverse is the log-derivative form above, so the
// gradients differ from the plain VJP by rounding (held to 1e-5 of the
// largest entry plus 1e-6).
// All lanes stay alive to the end (a lane past the last spline computes
// the last spline again and stores nothing), and every shuffle and the
// ballot run on all 32 lanes of the warp.
constexpr int kGradThreads = 128;
constexpr unsigned kWarp = 0xffffffffu;

// the lanes of a spline's group: K rounded up to a power of two
__host__ __device__ constexpr int group_width(int k) {
  int g = 1;
  while (g < k) g <<= 1;
  return g;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kWarp, v, off, G));
  }
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kWarp, v, off, G);
  }
  return v;
}

// One axis of a spline over the K working lanes of its group of G, lane j
// holding v = raw[j] (+ bias), a padding lane -inf: sets *p to the lane's
// softmax entry e_j / sum (0 on a padding lane) and returns knot j + 1 (the
// pinned end on lanes K-1 and up), each bit for bit as softmax_exp and
// knots form it: the sum and the cumsum gather lanes 0..K-1 left to right.
template <int K, int G>
__device__ __forceinline__ float lane_knot(float v, int j, float min_bin,
                                           float scale, float bound,
                                           float* p) {
  const float e = expf(v - group_max<G>(v));
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) sum += __shfl_sync(kWarp, e, k, G);
  *p = e / sum;
  const float size = min_bin + scale * *p;
  float cs = 0.f, mine = 0.f;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    cs += __shfl_sync(kWarp, size, k, G);
    mine = k == j ? cs : mine;
  }
  return j < K - 1 ? mine * (2.f * bound) - bound : bound;
}

template <int K, bool BIAS>
__global__ void __launch_bounds__(kGradThreads)
rqs_grad(const float* __restrict__ x, const float* __restrict__ raw,
         const float* __restrict__ bias, const float* __restrict__ g_out,
         const float* __restrict__ g_logdet, float* __restrict__ g_x,
         float* __restrict__ g_raw, int n, int d, float bound) {
  constexpr int R = 3 * K - 1;
  constexpr int G = group_width(K);
  constexpr bool kPad = G != K;              // lanes K..G-1 pad the group
  const float min_w = (float)kMinBinWidth;
  const float scale_w = (float)(1.0 - kMinBinWidth * K);
  const float min_h = (float)kMinBinHeight;
  const float scale_h = (float)(1.0 - kMinBinHeight * K);
  const int splines = n * d;                 // < 2^31: pf_rqs_grad_launch
  const int j = (int)threadIdx.x % G;
  const bool lane = !kPad || j < K;          // a working lane
  const int first = (int)(threadIdx.x & 31u) - j;   // the group's lane 0
  const int spline =
      (int)blockIdx.x * (kGradThreads / G) + (int)threadIdx.x / G;
  const bool live = spline < splines;
  const int sp = live ? spline : splines - 1;

  const float* r = raw + (long long)sp * R;
  float w = __int_as_float(0xff800000), h = w, u = 0.f;   // -inf
  if (lane) {
    w = r[j];
    h = r[K + j];
    if (j < K - 1) u = r[2 * K + j];
    if (BIAS) {
      w += bias[j];
      h += bias[K + j];
      if (j < K - 1) u += bias[2 * K + j];
    }
  }
  const float v = x[sp], g_y = g_out[sp], g_l = g_logdet[sp / d];
  const bool inside = fabsf(v) <= bound;
  const float vs = fminf(fmaxf(v, -bound), bound);

  // the forward's knots, bin and derivatives
  float p_w, p_h;
  const float kx = lane_knot<K, G>(w, j, min_w, scale_w, bound, &p_w);
  const float ky = lane_knot<K, G>(h, j, min_h, scale_h, bound, &p_h);
  const unsigned below = __ballot_sync(kWarp, j < K - 1 && vs >= kx);
  const int idx = __popc((below >> first) & ((1u << (K - 1)) - 1u));
  const float z = expf(u);
  const float dv = kMinDerivative + (u > 20.f ? u : log1pf(z));  // softplus
  // every lane shuffles, then selects: a shuffle under a branch that
  // differs between the groups of a warp would not be reached by all
  const int lo = idx > 0 ? idx - 1 : 0;
  const float kx_lo = __shfl_sync(kWarp, kx, lo, G);
  const float ky_lo = __shfl_sync(kWarp, ky, lo, G);
  const float dv_lo = __shfl_sync(kWarp, dv, lo, G);
  const float x_hi = __shfl_sync(kWarp, kx, idx, G);
  const float y_hi = __shfl_sync(kWarp, ky, idx, G);
  const float dv_hi = __shfl_sync(kWarp, dv, idx, G);
  const float x_lo = idx > 0 ? kx_lo : -bound;
  const float y_lo = idx > 0 ? ky_lo : -bound;
  const float d_lo = idx > 0 ? dv_lo : 1.f;
  const float d_hi = idx < K - 1 ? dv_hi : 1.f;

  // the forward's map; theta by an IEEE division, as autograd's clamp
  // sees it, the other quotients by fast reciprocals (they enter only the
  // gradient)
  const float wb = x_hi - x_lo;
  const float hb = y_hi - y_lo;
  const float iw = __fdividef(1.f, wb);
  const float s = hb * iw;
  const float dsum = d_hi + d_lo - 2.f * s;
  const float theta_raw = (vs - x_lo) / wb;
  const float theta = fminf(fmaxf(theta_raw, 0.f), 1.f);
  const float t1m = 1.f - theta;
  const float tt = theta * t1m;
  const float denom = s + dsum * tt;
  const float iq = __fdividef(1.f, denom);
  const float theta2 = theta * theta;
  const float num = s * theta2 + d_lo * tt;
  const float m = d_hi * theta2 + 2.f * s * tt + d_lo * (t1m * t1m);

  // y = y_lo + hb·num/denom and log(max(dydx, 1e-30)) in reverse, with
  // log dydx = 2 log s + log m - 2 log denom (s, m, denom > 0)
  const float gl = s * s * m * (iq * iq) >= 1e-30f ? g_l : 0.f;
  const float g_num = g_y * hb * iq;
  const float g_m = gl * __fdividef(1.f, m);
  const float g_den = -g_y * hb * num * (iq * iq) - 2.f * gl * iq;
  float g_h = g_y * num * iq;
  const float g_s = g_num * theta2 + g_den * (1.f - 2.f * tt)
                    + 2.f * gl * __fdividef(1.f, s) + g_m * 2.f * tt;
  const float g_dlo = (g_num + g_den) * tt + g_m * (t1m * t1m);
  const float g_dhi = g_den * tt + g_m * theta2;
  const float g_tt = g_num * d_lo + g_den * dsum + g_m * 2.f * s;
  const float g_t1m = g_tt * theta + g_m * 2.f * d_lo * t1m;
  const float g_theta = g_num * 2.f * s * theta + g_m * 2.f * d_hi * theta
                        + g_tt * t1m - g_t1m;
  const float g_th_raw =
      (theta_raw >= 0.f && theta_raw <= 1.f) ? g_theta : 0.f;
  const float g_vs = g_th_raw * iw;
  float g_w = -g_th_raw * theta_raw * iw;
  g_h += g_s * iw;
  g_w -= g_s * s * iw;
  const float g_xhi = g_w;
  const float g_xlo = -g_th_raw * iw - g_w;
  const float g_yhi = g_h;
  const float g_ylo = g_y - g_h;

  // knots -> bin sizes -> softmax, lane j's entry of each axis: knot i is
  // interior for 1 <= i <= K-1 and moves with size j < i
  const float two_b = 2.f * bound;
  const float c_lo_x = idx >= 1 ? g_xlo : 0.f;
  const float c_hi_x = idx + 1 <= K - 1 ? g_xhi : 0.f;
  const float c_lo_y = idx >= 1 ? g_ylo : 0.f;
  const float c_hi_y = idx + 1 <= K - 1 ? g_yhi : 0.f;
  const float gp_w = scale_w * two_b
                     * ((j < idx ? c_lo_x : 0.f) + (j <= idx ? c_hi_x : 0.f));
  const float gp_h = scale_h * two_b
                     * ((j < idx ? c_lo_y : 0.f) + (j <= idx ? c_hi_y : 0.f));
  const float dot_w = group_sum<G>(p_w * gp_w);
  const float dot_h = group_sum<G>(p_h * gp_h);
  // the bin's two interior derivatives: softplus' = sigmoid
  const float sg = u > 20.f ? 1.f : __fdividef(z, z + 1.f);
  float g_u = 0.f;
  if (idx > 0 && j == idx - 1) g_u = g_dlo * sg;
  if (idx < K - 1 && j == idx) g_u = g_dhi * sg;

  if (live && lane) {
    float* gr = g_raw + (long long)sp * R;
    gr[j] = inside ? p_w * (gp_w - dot_w) : 0.f;
    gr[K + j] = inside ? p_h * (gp_h - dot_h) : 0.f;
    if (j < K - 1) gr[2 * K + j] = inside ? g_u : 0.f;
    if (j == 0) g_x[sp] = inside ? g_vs : g_y;
  }
}

template <int K, bool BIAS>
int launch_grad(const float* x, const float* raw, const float* bias,
                const float* g_out, const float* g_logdet, float* g_x,
                float* g_raw, int n, int d, float bound,
                cudaStream_t stream) {
  constexpr int S = kGradThreads / group_width(K);   // splines a block
  const int grid = (int)(((long long)n * d + S - 1) / S);
  rqs_grad<K, BIAS><<<grid, kGradThreads, 0, stream>>>(
      x, raw, bias, g_out, g_logdet, g_x, g_raw, n, d, bound);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch_grad(const float* x, const float* raw, const float* bias,
                  const float* g_out, const float* g_logdet, float* g_x,
                  float* g_raw, int n, int d, float bound,
                  cudaStream_t stream) {
  return bias ? launch_grad<K, true>(x, raw, bias, g_out, g_logdet, g_x,
                                     g_raw, n, d, bound, stream)
              : launch_grad<K, false>(x, raw, bias, g_out, g_logdet, g_x,
                                      g_raw, n, d, bound, stream);
}

// make `device` current, unless it already is
int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return (int)err;
}

struct Launch {
  const float* x;
  const float* raw;
  const float* bias;
  float* out;
  float* logdet;
  int n, d, rows_per_tile, grid, smem_bytes, device;
  float bound;
  cudaStream_t stream;
};

template <int K, bool INVERSE, bool BIAS>
int launch(const Launch& a) {
  // the most dynamic shared memory this instance was allowed, by device
  static int allowed[kMaxDevices] = {};
  auto* kernel = rqs_tile<K, INVERSE, BIAS>;
  if (a.smem_bytes > allowed[a.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[a.device] = a.smem_bytes;
  }
  kernel<<<a.grid, kThreads, a.smem_bytes, a.stream>>>(
      a.x, a.raw, a.bias, a.out, a.logdet, a.n, a.d, a.rows_per_tile,
      a.bound);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch(const Launch& a, bool inverse) {
  if (inverse) {
    return a.bias ? launch<K, true, true>(a) : launch<K, true, false>(a);
  }
  return a.bias ? launch<K, false, true>(a) : launch<K, false, false>(a);
}

}  // namespace

// x [n, d] and raw [n, d·(3k-1)] (both 16-B aligned), out [n, d],
// logdet [n]:
// contiguous float32 on `device`; bias [3k-1] float32 or null. The tile plan
// (rows_per_tile, grid, smem_bytes) comes from ops/rqs_cuda.py:tile_plan.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pf_rqs_launch(const void* x, const void* raw, const void* bias,
                             void* out, void* logdet, int n, int d, int k,
                             float tail_bound, int inverse, int rows_per_tile,
                             int grid, int smem_bytes, int device,
                             void* stream) {
  if (n <= 0 || d <= 0 || rows_per_tile <= 0 || rows_per_tile % 4 != 0
      || grid <= 0 || device < 0 || device >= kMaxDevices
      || reinterpret_cast<uintptr_t>(raw) % 16 != 0
      || reinterpret_cast<uintptr_t>(x) % 16 != 0
      || smem_bytes < smem_layout_bytes(rows_per_tile, d, k)) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = use_device(device);
  if (err != 0) return err;
  const Launch a{static_cast<const float*>(x), static_cast<const float*>(raw),
                 static_cast<const float*>(bias), static_cast<float*>(out),
                 static_cast<float*>(logdet), n, d, rows_per_tile, grid,
                 smem_bytes, device, tail_bound,
                 static_cast<cudaStream_t>(stream)};
  switch (k) {
    case 4: return dispatch<4>(a, inverse != 0);
    case 8: return dispatch<8>(a, inverse != 0);
    case 12: return dispatch<12>(a, inverse != 0);
    case 16: return dispatch<16>(a, inverse != 0);
    case 32: return dispatch<32>(a, inverse != 0);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Gradients of the forward spline on raw + bias: x [n, d], raw
// [n, d·(3k-1)], g_out [n, d], g_logdet [n] -> g_x [n, d], g_raw
// [n, d·(3k-1)]; contiguous float32 on `device`, bias [3k-1] float32 or
// null (it gets no gradient); n·d below 2^31. Returns the CUDA error code
// of the launch.
extern "C" int pf_rqs_grad_launch(const void* x, const void* raw,
                                  const void* bias, const void* g_out,
                                  const void* g_logdet, void* g_x,
                                  void* g_raw, int n, int d, int k,
                                  float tail_bound, int device,
                                  void* stream) {
  if (n <= 0 || d <= 0 || device < 0 || device >= kMaxDevices
      || (long long)n * d >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = use_device(device);
  if (err != 0) return err;
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(raw);
  const float* bf = static_cast<const float*>(bias);
  const float* go = static_cast<const float*>(g_out);
  const float* gl = static_cast<const float*>(g_logdet);
  float* gx = static_cast<float*>(g_x);
  float* gr = static_cast<float*>(g_raw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 4: return dispatch_grad<4>(xf, rf, bf, go, gl, gx, gr, n, d,
                                    tail_bound, st);
    case 8: return dispatch_grad<8>(xf, rf, bf, go, gl, gx, gr, n, d,
                                    tail_bound, st);
    case 12: return dispatch_grad<12>(xf, rf, bf, go, gl, gx, gr, n, d,
                                      tail_bound, st);
    case 16: return dispatch_grad<16>(xf, rf, bf, go, gl, gx, gr, n, d,
                                      tail_bound, st);
    case 32: return dispatch_grad<32>(xf, rf, bf, go, gl, gx, gr, n, d,
                                      tail_bound, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
