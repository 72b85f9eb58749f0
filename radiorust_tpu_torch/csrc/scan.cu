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
// sample is a chain of about a dozen dependent instructions (one MUFU
// rsqrt with its denormal fix-up, or an IEEE sqrt/divide): 83 cycles a
// step for the rsqrt form on registers alone (chip_smoke.py --clocks, H100
// 80GB HBM3).  At the morse chain's 64 streams x 4096 samples the call
// reads and writes 4 MB (1.25 us at 3.35 TB/s); a serial walk of the 4096
// samples, one thread per stream, took ~167-197 cycles a sample (the
// design before this one: shared-memory tiles, 120 cycles the walk, the
// rest staging and barriers).
//
// Slew: a time-segmented speculative scan (slew_segments).  The output
// y[t] *is* the carry after step t, so two walks of one stream from
// different carries that agree bit for bit at some sample agree at every
// later one.  On keyer envelopes every unclamped step lands exactly on
// the input (Sterbenz: 1 - p and 0 - p are exact near the targets), so a
// walk forgets its carry within one step of each ramp's end.  One block
// per stream; thread k owns the segment [k L, k L + L) of its row:
//   1. it walks its segment from a guessed carry (the input sample just
//      before it; segment 0 takes the true carry), writing y;
//   2. in passes, each segment whose predecessor's last output differs
//      bit for bit from the carry it last walked from re-walks from that
//      output, and stops where the re-walked p meets the stored y in both
//      planes (__float_as_uint): the stored rest is already the walk from
//      there.  A segment that walks to its end without meeting the stored
//      outputs has a new last output, and its successor repairs in the
//      next pass; the passes end when no segment needs one
//      (__syncthreads_or).  Segment 0 is exact after step 1 and segment j
//      after pass j, so at most T / L passes run, and the result is the
//      serial loop's bit for bit by construction.
// The critical path is the longest clamped ramp plus about 2 L steps
// (~480 + 128 samples at 48 kHz, 100 Hz/s), not T; on input that never
// converges (every step clamped) it is T + L steps and T / L passes.
// The block first copies its row into shared memory with coalesced
// 16-byte loads (segments one quad of padding apart, so the lanes' quad
// loads hit distinct banks); a lane then walks its segment there a quad
// at a time, the next quad's loads (x, and in a repair the stored y)
// issued ahead, a repair comparing each quad's last sample only, and y
// leaves in one coalesced copy at the end.  The carry never leaves
// registers, no barrier sits inside a walk and no step waits on a branch:
// ~88 cycles a step for a first walk, ~102 for a repair, against the
// chain's 83.  (A row too long for shared memory, about 13000 samples, is
// walked in device memory, one sample at a time.)  The TPU kernel's lane
// padding of B to 128, its [T, B] transpose and its 8x unroll are Mosaic
// rules and are gone.
//
// AGC: one thread per stream, its carry in registers (walk_tiles).  A
// block owns kRows = 32 streams.  Streams are rows of a row-major [B, T]
// array, so a thread walking its own row would read at stride T; instead
// the block's four warps stage a [kRows x kTile] time tile of both planes
// into shared memory with coalesced row reads (rows padded to kTile + 1
// floats, so the walking warp hits 32 distinct banks), warp 0 walks the
// tile writing each output over its input, and all warps store the tile
// back coalesced.
//
// Rounding: every step uses __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// contracts nothing into an FMA and each operation rounds as the plain
// PyTorch loop's separate kernels do; along a long slewing run a
// contraction difference would add up.  sqrt and divide are the IEEE
// __fsqrt_rn / __fdiv_rn; the rsqrt form uses rsqrtf only where
// |d|^2 > md^2 > 0 selects it, so no inf or NaN is ever selected.
//
// A development build (-DRR_SCAN_CLOCKS, chip_smoke.py --clocks) adds
// rr_slew_clocks: clock64() stamps of the serial tiled walk (the design
// before the segments: staging, walk, barriers), of the bare step chain on
// registers, and of the segmented kernel (walks, passes).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;      // streams per block: one warp walks them
constexpr int kTile = 128;     // samples per staged time tile
constexpr int kThreads = 128;  // four warps stage and store tiles
constexpr int kMaxSegments = 256;    // slew segments of a stream (threads)
constexpr size_t kMaxSlewSmem = 232448 - 2 * 4 * kMaxSegments;
                                     // a block's shared copy of its row

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

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Walk samples [t0, t1) of one row from step's carry, writing y.  With
// kRepair, stop where the new p meets the stored y in both planes
// (returns true: the stored rest is this walk's).  kShared: the row is
// the block's copy in shared memory, walked as quads (t0 and t1
// multiples of 4, 16-byte aligned), each quad's loads issued a quad
// ahead; a repair compares each quad's last sample only, so no step
// waits on a branch: walks that meet inside a quad agree from there on,
// at its last sample too, and the quad's stored values past the meeting
// point equal the new ones.  Else the row is in device memory, walked and
// compared one sample at a time.
template <bool kRepair, bool kShared, class Step>
__device__ __forceinline__ bool walk_segment(Step& st, const float* xr,
                                             const float* xi, float* yr,
                                             float* yi, int t0, int t1) {
  if (!kShared) {
    for (int t = t0; t < t1; ++t) {
      float a = __ldg(xr + t), b = __ldg(xi + t);
      st(a, b);
      if (kRepair && same_bits(a, yr[t]) && same_bits(b, yi[t])) return true;
      yr[t] = a;
      yi[t] = b;
    }
    return false;
  }
  const float4* x4r = reinterpret_cast<const float4*>(xr);
  const float4* x4i = reinterpret_cast<const float4*>(xi);
  float4* y4r = reinterpret_cast<float4*>(yr);
  float4* y4i = reinterpret_cast<float4*>(yi);
  const int q0 = t0 >> 2, q1 = t1 >> 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ar = x4r[q0], ai = x4i[q0], br = zero, bi = zero;
  if (kRepair) {
    br = y4r[q0];
    bi = y4i[q0];
  }
  for (int qd = q0; qd < q1; ++qd) {
    const int qn = min(qd + 1, q1 - 1);   // the next quad, or this one
    const float4 nar = x4r[qn], nai = x4i[qn];
    const float4 nbr = kRepair ? y4r[qn] : zero;
    const float4 nbi = kRepair ? y4i[qn] : zero;
    float o_r[4] = {ar.x, ar.y, ar.z, ar.w};
    float o_i[4] = {ai.x, ai.y, ai.z, ai.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) st(o_r[e], o_i[e]);
    y4r[qd] = make_float4(o_r[0], o_r[1], o_r[2], o_r[3]);
    y4i[qd] = make_float4(o_i[0], o_i[1], o_i[2], o_i[3]);
    if (kRepair && same_bits(o_r[3], br.w) && same_bits(o_i[3], bi.w))
      return true;
    ar = nar;
    ai = nai;
    br = nbr;
    bi = nbi;
  }
  return false;
}

#ifdef RR_SCAN_CLOCKS
#define RR_CLOCK(v) v = clock64()
#else
#define RR_CLOCK(v)
#endif

// Floats of one plane of a block's shared copy: segment k of L samples
// at k (L + 4), one quad of padding apart, so the lanes' quad loads (L
// samples apart) fall in distinct banks.
__host__ __device__ __forceinline__ int plane_floats(int segs, int L) {
  return segs * (L + 4);
}

// The speculative segmented walk of one stream per block (see the head of
// this file).  grid B, block = ceil(T / L) threads rounded up to a warp
// (at most kMaxSegments); L a multiple of 4.  md: one float on the device.
// kShared (T % 4 == 0, 16-byte aligned planes): the block first copies
// its row of x into shared memory (coalesced quads), the walks read and
// write the shared copy, and y leaves in one coalesced copy at the end;
// dynamic shared memory 4 planes of plane_floats(blockDim.x, L).  Else
// the walks read and write device memory.  clk: the development build's
// stamps of block 0, [4 * thread + (first walk cycles, repair walk
// cycles, repair steps walked to the end, passes)]; nullptr otherwise.
template <bool RSQRT, bool kShared>
__global__ void __launch_bounds__(kMaxSegments) slew_segments(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ prev_r, const float* __restrict__ prev_i,
    const float* __restrict__ md, float* yr, float* yi,
    float* __restrict__ out_r, float* __restrict__ out_i, int T, int L,
    long long* clk) {
  extern __shared__ float4 seg_smem4[];
  __shared__ float last_r[kMaxSegments], last_i[kMaxSegments];
  const int k = threadIdx.x;
  const int t0 = k * L, t1 = min(T, t0 + L);
  const bool live = t0 < T;
  const size_t row = (size_t)blockIdx.x * T;
  xr += row;
  xi += row;
  yr += row;
  yi += row;
  SlewStep<RSQRT> st;
  st.md = md[0];
  st.md2 = __fmul_rn(st.md, st.md);
  // The carry walked from: the true one for segment 0, else a guess.
  float cr = 0.f, ci = 0.f;
  if (k == 0) {
    cr = prev_r[blockIdx.x];
    ci = prev_i[blockIdx.x];
  } else if (live) {
    cr = __ldg(xr + t0 - 1);
    ci = __ldg(xi + t0 - 1);
  }
  // This segment's walk: its row slices and bounds.
  const float *wxr = xr, *wxi = xi;
  float *wyr = yr, *wyi = yi;
  int w0 = t0, w1 = t1;
  float* sm = reinterpret_cast<float*>(seg_smem4);
  const int P = plane_floats(blockDim.x, L), pad = L + 4;
  if (kShared) {
    for (int g = threadIdx.x; g < T / 4; g += blockDim.x) {
      const int t = 4 * g, at = t + 4 * (t / L);
      *reinterpret_cast<float4*>(sm + at) =
          __ldg(reinterpret_cast<const float4*>(xr) + g);
      *reinterpret_cast<float4*>(sm + P + at) =
          __ldg(reinterpret_cast<const float4*>(xi) + g);
    }
    __syncthreads();
    wxr = sm + k * pad;
    wxi = wxr + P;
    wyr = sm + 2 * P + k * pad;
    wyi = wyr + P;
    w0 = 0;
    w1 = t1 - t0;
  }
  long long c0 = 0, c1 = 0, walk_cycles = 0, steps = 0, passes = 0;
  RR_CLOCK(c0);
  st.pr = cr;
  st.pi = ci;
  if (live) walk_segment<false, kShared>(st, wxr, wxi, wyr, wyi, w0, w1);
  RR_CLOCK(c1);
  const long long first_walk = c1 - c0;
  float lr = st.pr, li = st.pi;   // this segment's stored last output
  for (;;) {
    last_r[k] = lr;
    last_i[k] = li;
    __syncthreads();
    bool need = false;
    float pr = 0.f, pi = 0.f;
    if (live && k > 0) {
      pr = last_r[k - 1];
      pi = last_i[k - 1];
      need = !same_bits(pr, cr) || !same_bits(pi, ci);
    }
    // Also the barrier before the next pass overwrites last_r / last_i.
    if (!__syncthreads_or(need)) break;
    ++passes;
    if (need) {
      cr = pr;
      ci = pi;
      st.pr = cr;
      st.pi = ci;
      RR_CLOCK(c0);
      const bool met =
          walk_segment<true, kShared>(st, wxr, wxi, wyr, wyi, w0, w1);
      RR_CLOCK(c1);
      walk_cycles += c1 - c0;
      if (!met) {
        lr = st.pr;
        li = st.pi;
        steps += t1 - t0;
      }
    }
  }
  if (kShared) {   // the shared y back to the row, coalesced
    for (int g = threadIdx.x; g < T / 4; g += blockDim.x) {
      const int t = 4 * g, at = t + 4 * (t / L);
      reinterpret_cast<float4*>(yr)[g] =
          *reinterpret_cast<const float4*>(sm + 2 * P + at);
      reinterpret_cast<float4*>(yi)[g] =
          *reinterpret_cast<const float4*>(sm + 3 * P + at);
    }
  }
  if (live && t1 == T) {
    out_r[blockIdx.x] = lr;
    out_i[blockIdx.x] = li;
  }
  if (clk != nullptr && blockIdx.x == 0) {   // development build only
    clk[4 * k] = first_walk;
    clk[4 * k + 1] = walk_cycles;
    clk[4 * k + 2] = steps;
    clk[4 * k + 3] = passes;
  }
}

// Launch slew_segments: the shared copy where T % 4 == 0, the planes are
// 16-byte aligned and the copy fits shared memory; else device memory.
template <bool RSQRT>
int launch_slew(const float* xr, const float* xi, const float* prev_r,
                const float* prev_i, const float* md, float* yr, float* yi,
                float* out_r, float* out_i, int b, int t, int seg,
                long long* clk, cudaStream_t st) {
  const int nseg = (t + seg - 1) / seg;
  if (seg < 4 || seg % 4 || nseg > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  const int threads = (nseg + 31) / 32 * 32;
  const size_t smem = 4 * sizeof(float) * plane_floats(threads, seg);
  const bool shared =
      t % 4 == 0 && smem <= kMaxSlewSmem &&
      ((uintptr_t)xr | (uintptr_t)xi | (uintptr_t)yr | (uintptr_t)yi) % 16 ==
          0;
  if (shared) {
    const cudaError_t err = cudaFuncSetAttribute(
        slew_segments<RSQRT, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    slew_segments<RSQRT, true><<<b, threads, smem, st>>>(
        xr, xi, prev_r, prev_i, md, yr, yi, out_r, out_i, t, seg, clk);
  } else {
    slew_segments<RSQRT, false><<<b, threads, 0, st>>>(
        xr, xi, prev_r, prev_i, md, yr, yi, out_r, out_i, t, seg, clk);
  }
  return (int)cudaGetLastError();
}

#ifdef RR_SCAN_CLOCKS
// The serial tiled walk that slew_segments replaced (one thread per
// stream, kRows streams a block, four warps staging kTile-sample tiles
// through shared memory, warp 0 walking), with clock64() stamps by thread
// 0 of block 0 summed over the tiles: clk[0] staging and the first
// barrier, clk[1] the walk, clk[2] the barrier after it, clk[3] the store
// and the last barrier.
template <bool RSQRT>
__global__ void __launch_bounds__(kThreads) slew_tiled_clocks(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ prev_r, const float* __restrict__ prev_i,
    const float* __restrict__ md, float* __restrict__ yr,
    float* __restrict__ yi, int B, int T, long long* clk) {
  __shared__ float sr[kRows][kTile + 1];
  __shared__ float si[kRows][kTile + 1];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = row0 + threadIdx.x;
  SlewStep<RSQRT> step;
  step.md = md[0];
  step.md2 = __fmul_rn(step.md, step.md);
  step.pr = threadIdx.x < rows ? prev_r[s] : 0.f;
  step.pi = threadIdx.x < rows ? prev_i[s] : 0.f;
  long long acc[4] = {0, 0, 0, 0};
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int tt = min(kTile, T - t0);
    const long long a = clock64();
    for (int r = warp; r < rows; r += kThreads / 32) {
      const size_t base = (size_t)(row0 + r) * T + t0;
      for (int c = lane; c < tt; c += 32) {
        sr[r][c] = xr[base + c];
        si[r][c] = xi[base + c];
      }
    }
    __syncthreads();
    const long long b = clock64();
    if (threadIdx.x < rows) {
      float* pr = sr[threadIdx.x];
      float* pi = si[threadIdx.x];
      for (int c = 0; c < tt; ++c) step(pr[c], pi[c]);
    }
    const long long c = clock64();
    __syncthreads();
    const long long d = clock64();
    for (int r = warp; r < rows; r += kThreads / 32) {
      const size_t base = (size_t)(row0 + r) * T + t0;
      for (int cc = lane; cc < tt; cc += 32) {
        yr[base + cc] = sr[r][cc];
        yi[base + cc] = si[r][cc];
      }
    }
    __syncthreads();
    const long long e = clock64();
    acc[0] += b - a;
    acc[1] += c - b;
    acc[2] += d - c;
    acc[3] += e - d;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < 4; ++i) clk[i] = acc[i];
}

// The bare step chain: T dependent steps of one carry on registers toward
// a far target (every step clamped), no memory; clk[0] its cycles.
template <bool RSQRT>
__global__ void slew_chain_clocks(const float* __restrict__ md, int T,
                                  float* sink, long long* clk) {
  SlewStep<RSQRT> step;
  step.md = md[0];
  step.md2 = __fmul_rn(step.md, step.md);
  step.pr = 0.f;
  step.pi = 0.f;
  const float far = 1e6f + threadIdx.x;
  const long long a = clock64();
  for (int t = 0; t < T; ++t) {
    float x = far, y = far;
    step(x, y);
  }
  const long long b = clock64();
  sink[threadIdx.x] = step.pr + step.pi;
  if (threadIdx.x == 0) clk[0] = b - a;
}
#endif

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

// The wrapper checks B > 0, T > 0, shapes, dtypes and contiguity, and
// gives the segment length seg (a multiple of 4, ceil(T / seg) <=
// kMaxSegments).
int rr_slew_scan(const float* xr, const float* xi, const float* prev_r,
                 const float* prev_i, const float* md, float* yr, float* yi,
                 float* out_r, float* out_i, int b, int t, int seg,
                 int rsqrt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rsqrt)
    return launch_slew<true>(xr, xi, prev_r, prev_i, md, yr, yi, out_r,
                             out_i, b, t, seg, nullptr, st);
  return launch_slew<false>(xr, xi, prev_r, prev_i, md, yr, yi, out_r, out_i,
                            b, t, seg, nullptr, st);
}

#ifdef RR_SCAN_CLOCKS
// Development build only: the rsqrt form's cycle split on [b, t] planes,
// written to clk (int64): [0..3] the tiled walk's (slew_tiled_clocks),
// [4] the bare chain of t steps, then from [8] 4 * kMaxSegments entries
// of slew_segments' block 0 at segment length seg.  Outputs land in yr /
// yi (the segmented walk's, last).
int rr_slew_clocks(const float* xr, const float* xi, const float* prev_r,
                   const float* prev_i, const float* md, float* yr,
                   float* yi, float* out_r, float* out_i, int b, int t,
                   int seg, long long* clk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  slew_tiled_clocks<true><<<(b + kRows - 1) / kRows, kThreads, 0, st>>>(
      xr, xi, prev_r, prev_i, md, yr, yi, b, t, clk);
  slew_chain_clocks<true><<<1, 32, 0, st>>>(md, t, out_r, clk + 4);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_slew<true>(xr, xi, prev_r, prev_i, md, yr, yi, out_r, out_i,
                           b, t, seg, clk + 8, st);
}
#endif

int rr_agc_scan(const float* xr, const float* xi, const float* gain,
                const float* sc, float* yr, float* yi, float* gain_out,
                int b, int t, void* stream) {
  const dim3 grid((b + kRows - 1) / kRows);
  agc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xr, xi, gain, sc, yr, yi, gain_out, b, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
