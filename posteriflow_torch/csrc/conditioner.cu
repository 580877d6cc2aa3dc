// The tail of a flow conditioner's hidden layer in one pass, for Hopper
// (sm_90a): the bias add, the context add and flax's tanh GELU over a bf16
// product [N, H]. Plain C interface, built with nvcc and loaded with ctypes
// by posteriflow_torch/ops/conditioner_cuda.py.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses these elementwise ops
// into the products around them. PyTorch runs them op by op, eleven passes
// over the activation (bias add, context add, nine GELU ops) and a twelfth
// for the float32 copy that the output projection reads. This kernel
// computes what models/flow.py's ops compute, bit for bit:
//   s = rnd(rnd(p + bias) + ctx)                          (ctx optional)
//   gelu(s) = rnd(s · rnd(0.5 · rnd(1 + rnd(tanhf(rnd(c1 · rnd(s +
//             rnd(c2 · rnd(rnd(s · s) · s)))))))))
// where rnd rounds a float to bf16 (nearest even), as PyTorch's bf16
// kernels round each result they store (their float-to-bf16 conversion is
// the same cvt.rn instruction). Every op is taken in float32 and rounded,
// never in native bf16 arithmetic (whose single rounding of a sum can
// differ); the products and sums are __fmul_rn / __fadd_rn, which the
// compiler never contracts into an FMA, and tanh is tanhf as PyTorch's
// bf16 tanh calls it. c1 and c2 are the bf16-rounded constants.
//
// Bound: memory, and issue slots nearly as much. A call reads the bf16
// product (2 B an element) and writes bf16 (2 B) or float32 (4 B): at the
// flagship sampling shape (N = 131072, H = 256) 134 or 201 MB, 40 or 60 us
// at 3.35 TB/s. It also issues ~45 instructions an element (eleven ops,
// each a float32 op, a conversion and its unpacking, and tanhf's ~15):
// ~1.5 G, ~50 us at the card's 128 lanes an SM a clock.
//
// Design:
// - A thread owns 8 consecutive columns of a row: 16-B loads of the
//   product and the context, 16-B stores (bf16) or two (float32). H/8
//   threads cover a row, a block kThreads / (H/8) whole rows.
// - Each rounding converts two elements at once (cvt.rn.bf16x2.f32, one
//   instruction for the pair, which a scalar conversion takes for one) and
//   unpacks them with a shift and a mask: the conversions were a third of
//   the instructions.
// - Blocks are persistent (a few per SM) and walk the rows in a grid
//   stride, so a thread keeps one column group and reads its 8 bias
//   values once. The warps resident on an SM hide the loads' latency
//   (each row's ~360 instructions a thread outlast a load many times).
// - The context row of row r is r / rep: rep = 1 for a context per row
//   (the density direction), rep = n for a context per event broadcast
//   over its n draws (sampling). A sampling request's few context rows
//   stay in cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a and b rounded to bf16 (nearest even) into one word, a in the low half
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a and b rounded to bf16 and widened back: exact in float32
__device__ __forceinline__ void rnd(float& a, float& b) {
  const uint32_t w = pack(a, b);
  a = lo(w);
  b = hi(w);
}

// flax's tanh GELU on two bf16 values, op by op as models/flow.py:gelu,
// packed as pack() packs them
__device__ __forceinline__ uint32_t gelu(float x0, float x1, float c1,
                                         float c2) {
  float a = __fmul_rn(x0, x0), b = __fmul_rn(x1, x1);
  rnd(a, b);
  a = __fmul_rn(a, x0), b = __fmul_rn(b, x1);
  rnd(a, b);
  a = __fmul_rn(c2, a), b = __fmul_rn(c2, b);
  rnd(a, b);
  a = __fadd_rn(x0, a), b = __fadd_rn(x1, b);
  rnd(a, b);
  a = __fmul_rn(c1, a), b = __fmul_rn(c1, b);
  rnd(a, b);
  a = tanhf(a), b = tanhf(b);
  rnd(a, b);
  a = __fadd_rn(1.0f, a), b = __fadd_rn(1.0f, b);
  rnd(a, b);
  a = __fmul_rn(0.5f, a), b = __fmul_rn(0.5f, b);
  rnd(a, b);
  return pack(__fmul_rn(x0, a), __fmul_rn(x1, b));
}

template <bool CTX, bool F32>
__global__ void __launch_bounds__(kThreads)
    cond_gelu(const uint4* __restrict__ p, const uint4* __restrict__ bias,
              const uint4* __restrict__ ctx, void* __restrict__ out, int rows,
              int hv, int rows_per_block, int rep, float c1, float c2) {
  const int col = threadIdx.x % hv;
  const int stride = gridDim.x * rows_per_block;
  const uint4 bw = __ldg(bias + col);
  const uint32_t bias2[4] = {bw.x, bw.y, bw.z, bw.w};
  for (int row = blockIdx.x * rows_per_block + threadIdx.x / hv; row < rows;
       row += stride) {
    const size_t v = (size_t)row * hv + col;
    const uint4 pw = p[v];
    const uint32_t p2[4] = {pw.x, pw.y, pw.z, pw.w};
    uint32_t q2[4] = {0, 0, 0, 0};
    if (CTX) {
      const uint4 qw = __ldg(ctx + (size_t)(row / rep) * hv + col);
      q2[0] = qw.x, q2[1] = qw.y, q2[2] = qw.z, q2[3] = qw.w;
    }
    uint32_t y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s0 = __fadd_rn(lo(p2[j]), lo(bias2[j]));
      float s1 = __fadd_rn(hi(p2[j]), hi(bias2[j]));
      rnd(s0, s1);
      if (CTX) {
        s0 = __fadd_rn(s0, lo(q2[j])), s1 = __fadd_rn(s1, hi(q2[j]));
        rnd(s0, s1);
      }
      y[j] = gelu(s0, s1, c1, c2);
    }
    if (F32) {           // bf16 widened to float32: exact
      float4* o = static_cast<float4*>(out) + 2 * v;
      o[0] = make_float4(lo(y[0]), hi(y[0]), lo(y[1]), hi(y[1]));
      o[1] = make_float4(lo(y[2]), hi(y[2]), lo(y[3]), hi(y[3]));
    } else {
      static_cast<uint4*>(out)[v] = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
}

int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return (int)err;
}

template <bool CTX, bool F32>
int dispatch(const void* p, const void* bias, const void* ctx, void* out,
             int rows, int hv, int rep, float c1, float c2, int grid,
             cudaStream_t stream) {
  const int rows_per_block = kThreads / hv;
  cond_gelu<CTX, F32><<<grid, rows_per_block * hv, 0, stream>>>(
      static_cast<const uint4*>(p), static_cast<const uint4*>(bias),
      static_cast<const uint4*>(ctx), out, rows, hv, rows_per_block, rep, c1,
      c2);
  return (int)cudaGetLastError();
}

}  // namespace

// out [rows, h] = gelu(p + bias [+ ctx[row / rep]]) with every op rounded
// to bf16: p [rows, h] and bias [h] bf16, ctx [ceil(rows / rep), h] bf16 or
// null, out bf16 or (out_f32) float32; contiguous, 16-B aligned, on
// `device`; h a multiple of 8 up to 8·kThreads, rows + grid·rows_per_block
// below 2^31. Returns the CUDA error code of the launch.
extern "C" int pf_cond_gelu_launch(const void* p, const void* bias,
                                   const void* ctx, void* out, int rows,
                                   int h, int rep, int out_f32, float c1,
                                   float c2, int grid, int device,
                                   void* stream) {
  const int hv = h / 8;
  if (rows <= 0 || h <= 0 || h % 8 != 0 || hv > kThreads || rep <= 0
      || grid <= 0 || device < 0 || device >= kMaxDevices
      || (long long)rows + (long long)grid * (kThreads / hv) >= (1LL << 31)
      || reinterpret_cast<uintptr_t>(p) % 16 != 0
      || reinterpret_cast<uintptr_t>(bias) % 16 != 0
      || reinterpret_cast<uintptr_t>(ctx) % 16 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctx != nullptr) {
    return out_f32 ? dispatch<true, true>(p, bias, ctx, out, rows, hv, rep, c1,
                                          c2, grid, st)
                   : dispatch<true, false>(p, bias, ctx, out, rows, hv, rep,
                                           c1, c2, grid, st);
  }
  return out_f32 ? dispatch<false, true>(p, bias, ctx, out, rows, hv, rep, c1,
                                         c2, grid, st)
                 : dispatch<false, false>(p, bias, ctx, out, rows, hv, rep, c1,
                                          c2, grid, st);
}
