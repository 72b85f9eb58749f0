// Per-sample feedback recurrences over [B, T] streams: the complex slew-rate
// clamp and the sequential AGC loop.
//
// Replaces two TPU kernels of radiorust_tpu/ops/pallas_scan.py:
//   rr_slew_scan  <- slew_scan (:191; steps _slew_step :161 and
//                    _slew_step_rsqrt :175, both run by _run_scan :115)
//   rr_agc_scan   <- agc_scan  (:216; step _agc_step :203, also _run_scan)
//
// What it computes, per stream s and sample t in order (carry c[s]):
//   slew:  d = x - p;  p += d * min(1, md / |d|);  y = p;  carry p
//          (rsqrt form: compare |d|^2 > md^2, scale = md * rsqrt(|d|^2))
//   agc:   y = g x;  g = clip(g + rate (ref - |y|), 0, max_gain);  carry g
// The slew recurrence has no associative form, so each stream is a serial
// loop over time.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic.  Each
// sample is a chain of about ten dependent float operations (one MUFU
// rsqrt or an IEEE sqrt/divide), and a chunk of T samples is T such steps
// back to back; at the morse chain's 64 streams x 4096 samples the whole
// kernel runs on 2 SMs out of 132 and reads 2 MB.
//
// What the design does about it: one thread per stream, its carry in
// registers.  A block owns kRows = 32 streams.  Streams are rows of a
// row-major [B, T] array, so a thread walking its own row would read at
// stride T; instead the block's four warps stage a [kRows x kTile] time
// tile of both planes into shared memory with coalesced row reads (rows
// padded to kTile + 1 floats, so the walking warp hits 32 distinct banks),
// warp 0 walks the tile writing each output over its input, and all warps
// store the tile back coalesced.  The TPU kernel's lane padding of B to
// 128, its [T, B] transpose and its 8x unroll are Mosaic rules and are
// gone.
//
// Rounding: every step uses __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// contracts nothing into an FMA and each operation rounds as the plain
// PyTorch loop's separate kernels do; along a long slewing run a
// contraction difference would add up.  sqrt and divide are the IEEE
// __fsqrt_rn / __fdiv_rn; the rsqrt form uses rsqrtf only where
// |d|^2 > md^2 > 0 selects it, so no inf or NaN is ever selected.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // streams per block: one warp walks them
constexpr int kTile = 128;     // samples per staged time tile
constexpr int kThreads = 128;  // four warps stage and store tiles

// Run ``step`` over every sample of the block's rows, in time order, with
// the output written in place of the input.  ``step(xr, xi)`` is called
// by thread r < rows for row r only.
template <class Step>
__device__ __forceinline__ void walk_tiles(const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           float* __restrict__ yr,
                                           float* __restrict__ yi, int B,
                                           int T, Step& step) {
  __shared__ float sr[kRows][kTile + 1];
  __shared__ float si[kRows][kTile + 1];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int tt = min(kTile, T - t0);
    for (int r = warp; r < rows; r += kThreads / 32) {
      const size_t base = (size_t)(row0 + r) * T + t0;
      for (int c = lane; c < tt; c += 32) {
        sr[r][c] = xr[base + c];
        si[r][c] = xi[base + c];
      }
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      float* pr = sr[threadIdx.x];
      float* pi = si[threadIdx.x];
      for (int c = 0; c < tt; ++c) step(pr[c], pi[c]);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kThreads / 32) {
      const size_t base = (size_t)(row0 + r) * T + t0;
      for (int c = lane; c < tt; c += 32) {
        yr[base + c] = sr[r][c];
        yi[base + c] = si[r][c];
      }
    }
    __syncthreads();  // the next tile's loads overwrite sr / si
  }
}

template <bool RSQRT>
struct SlewStep {
  float md, md2, pr, pi;
  __device__ __forceinline__ void operator()(float& xr, float& xi) {
    const float dr = __fsub_rn(xr, pr);
    const float di = __fsub_rn(xi, pi);
    const float n2 = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
    float scale;
    if (RSQRT) {
      scale = n2 > md2 ? __fmul_rn(md, rsqrtf(n2)) : 1.f;
    } else {
      const float norm = __fsqrt_rn(n2);
      scale = norm > md ? __fdiv_rn(md, norm) : 1.f;
    }
    pr = __fadd_rn(pr, __fmul_rn(dr, scale));
    pi = __fadd_rn(pi, __fmul_rn(di, scale));
    xr = pr;
    xi = pi;
  }
};

struct AgcStep {
  float rate, ref, max_gain, g;
  __device__ __forceinline__ void operator()(float& xr, float& xi) {
    const float yr = __fmul_rn(xr, g);
    const float yi = __fmul_rn(xi, g);
    const float env = __fsqrt_rn(__fadd_rn(__fmul_rn(yr, yr),
                                           __fmul_rn(yi, yi)));
    g = __fadd_rn(g, __fmul_rn(rate, __fsub_rn(ref, env)));
    g = fminf(fmaxf(g, 0.f), max_gain);
    xr = yr;
    xi = yi;
  }
};

// grid ceil(B / kRows), block kThreads.  md: one float on the device.
template <bool RSQRT>
__global__ void __launch_bounds__(kThreads) slew_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ prev_r, const float* __restrict__ prev_i,
    const float* __restrict__ md, float* __restrict__ yr,
    float* __restrict__ yi, float* __restrict__ out_r,
    float* __restrict__ out_i, int B, int T) {
  const int s = blockIdx.x * kRows + threadIdx.x;
  const bool mine = threadIdx.x < kRows && s < B;
  SlewStep<RSQRT> step;
  step.md = md[0];
  step.md2 = __fmul_rn(step.md, step.md);
  step.pr = mine ? prev_r[s] : 0.f;
  step.pi = mine ? prev_i[s] : 0.f;
  walk_tiles(xr, xi, yr, yi, B, T, step);
  if (mine) {
    out_r[s] = step.pr;
    out_i[s] = step.pi;
  }
}

// sc: rate, reference, max_gain as three floats on the device.
__global__ void __launch_bounds__(kThreads) agc_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ gain, const float* __restrict__ sc,
    float* __restrict__ yr, float* __restrict__ yi,
    float* __restrict__ gain_out, int B, int T) {
  const int s = blockIdx.x * kRows + threadIdx.x;
  const bool mine = threadIdx.x < kRows && s < B;
  AgcStep step{sc[0], sc[1], sc[2], mine ? gain[s] : 0.f};
  walk_tiles(xr, xi, yr, yi, B, T, step);
  if (mine) gain_out[s] = step.g;
}

}  // namespace

extern "C" {

// The wrapper checks B > 0, T > 0, shapes, dtypes and contiguity.
int rr_slew_scan(const float* xr, const float* xi, const float* prev_r,
                 const float* prev_i, const float* md, float* yr, float* yi,
                 float* out_r, float* out_i, int b, int t, int rsqrt,
                 void* stream) {
  const dim3 grid((b + kRows - 1) / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  if (rsqrt)
    slew_kernel<true><<<grid, kThreads, 0, st>>>(xr, xi, prev_r, prev_i, md,
                                                 yr, yi, out_r, out_i, b, t);
  else
    slew_kernel<false><<<grid, kThreads, 0, st>>>(
        xr, xi, prev_r, prev_i, md, yr, yi, out_r, out_i, b, t);
  return (int)cudaGetLastError();
}

int rr_agc_scan(const float* xr, const float* xi, const float* gain,
                const float* sc, float* yr, float* yi, float* gain_out,
                int b, int t, void* stream) {
  const dim3 grid((b + kRows - 1) / kRows);
  agc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xr, xi, gain, sc, yr, yi, gain_out, b, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
