// Per-sample feedback recurrences over [B, T] streams: the complex slew-rate
// clamp and the feedback AGC loop.
//
// Replaces two TPU kernels of radiorust_tpu/ops/pallas_scan.py:
//   rr_slew_scan  <- slew_scan (:191; steps _slew_step :161 and
//                    _slew_step_rsqrt :175, both run by _run_scan :115)
//   rr_agc_scan   <- agc_scan  (:216; step _agc_step :203, also _run_scan)
//   rr_agc_step      the same AGC kernel on complex64 rows, for the step
//                    of AgcControl (radiorust_tpu/blocks/transform.py:218)
//
// What it computes, per stream s and sample t in order (carry c[s]):
//   slew:  d = x - p;  p += d * min(1, md / |d|);  y = p;  carry p
//          (rsqrt form: compare |d|^2 > md^2, scale = md * rsqrt(|d|^2))
//   agc:   y = g x;  g = clip(g + rate (ref - |y|), 0, max_gain);  carry g
// The slew recurrence has no associative form, so each stream is a serial
// loop over time.  The AGC update is a clamped-affine map of g, and such
// maps compose (below).
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
// AGC: a block-parallel scan of the loop's clamped-affine maps
// (agc_segments).  A call reads x and writes y, 16 bytes a sample: 1.05 MB
// at path F's 64 x 1024, 0.31 us at 3.35 TB/s.  A serial walk instead
// takes T dependent steps of ~40 cycles or more (two multiplies, a sqrt,
// an update, a clamp): the design before this one, one thread a stream
// and 32 streams a block, took 81.6 us a call there.  With g >= 0,
// |y| = g |x|, so sample t sends the gain through
//   f_t(g) = clip(a_t g + b, 0, max_gain),  a_t = 1 - rate |x_t|,
//   b = rate ref,
// and the composition of two such maps is one, (a, b, lo, hi): the JAX
// package's _agc_compose (radiorust_tpu/blocks/transform.py:183), slope
// and offset capped at +-1e18 so that sustained overdrive stays finite.
// One block per stream; lane k owns the samples [k L, k L + L) of a tile:
//   1. the block stages the tile into shared memory with coalesced 16-byte
//      loads (two complex64 samples, or four of one plane, a load);
//      segments sit L | 1 floats apart, an odd stride, so the lanes'
//      reads of their own segments hit 32 distinct banks;
//   2. fold: each lane composes its segment's maps into one;
//   3. combine: an exclusive scan of the lanes' maps, five __shfl_up_sync
//      rounds in a warp, then the warp totals through shared memory,
//      applied in turn to the gain entering the tile;
//   4. entry gain and walk: each lane applies its prefix to that gain and
//      walks its L samples with the loop's own step, writing y over x in
//      the shared copy; the lane owning the tile's last sample hands its
//      gain on to the next tile, or out;
//   5. y leaves in one coalesced copy.
// The critical path is about 2 L steps, five shuffle rounds and a few
// warp applies, not T steps.  The wrapper gives 256 lanes (whole warps,
// fewer for a row of fewer samples): L = 4 at F's T = 1024, where 32, 64,
// 128 and 256 lanes took 12.7, 7.8, 5.4 and 4.6 us a call (chip_smoke.py's
// sweep, graph replays of 10 calls, H100 80GB HBM3).  A row longer than a
// tile (kAgcTile samples) goes through tile after tile with the gain
// carried.  Only the entry
// gains come from composed maps; the walk is the loop's own arithmetic.
// So in the loop's contracting regime (rate |x| < 2) y and g agree with
// the serial loop to rounding, and under sustained overdrive, where the
// loop is chaotic, they are one finite, clamped shadowing of it, as the
// JAX package's AgcControl is.
//
// NaN: the walk clamps with comparisons (g < 0 -> 0, g > max_gain ->
// max_gain), and the maps' min, max and clip keep NaN, as torch.clamp,
// torch.minimum and jnp.clip do (fminf / fmaxf return the operand that is
// not NaN, which would reset the gain): a NaN sample makes y and g NaN
// from that sample on, as in the plain versions.  rr_agc_step writes y as
// PyTorch's complex product x (g + 0i), so that a NaN or inf in one plane
// reaches both as in AgcControl's x * g.
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
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxSegments = 256;    // slew segments of a stream (threads)
constexpr size_t kMaxSlewSmem = 232448 - 2 * 4 * kMaxSegments;
                                     // a block's shared copy of its row
constexpr int kAgcMaxThreads = 256;  // AGC lanes (segments) of a block
constexpr int kAgcTile = 4096;       // AGC samples of a row staged at once
constexpr float kAgcCap = 1e18f;     // slope / offset cap: _AGC_CAP

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
constexpr int kRows = 32;      // streams per block: one warp walks them
constexpr int kTile = 128;     // samples per staged time tile
constexpr int kThreads = 128;  // four warps stage and store tiles

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

// A clamped-affine map of the AGC loop gain: g -> clip(a g + b, lo, hi).
struct Clamped {
  float a, b, lo, hi;
};

// min, max and clip that keep NaN, as torch.minimum, torch.maximum and
// torch.clamp do.
__device__ __forceinline__ float nan_min(float p, float q) {
  return (p < q || isnan(p)) ? p : q;
}

__device__ __forceinline__ float nan_max(float p, float q) {
  return (p > q || isnan(p)) ? p : q;
}

__device__ __forceinline__ float nan_clip(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

// (f2 . f1), f1 the earlier map: the JAX package's _agc_compose, term for
// term.
__device__ __forceinline__ Clamped compose(const Clamped& f1,
                                           const Clamped& f2) {
  const float p = __fmul_rn(f2.a, f1.lo), q = __fmul_rn(f2.a, f1.hi);
  Clamped r;
  r.a = nan_clip(__fmul_rn(f1.a, f2.a), -kAgcCap, kAgcCap);
  r.b = nan_clip(__fadd_rn(__fmul_rn(f2.a, f1.b), f2.b), -kAgcCap, kAgcCap);
  r.lo = nan_clip(__fadd_rn(nan_min(p, q), f2.b), f2.lo, f2.hi);
  r.hi = nan_clip(__fadd_rn(nan_max(p, q), f2.b), f2.lo, f2.hi);
  return r;
}

__device__ __forceinline__ float apply(const Clamped& f, float g) {
  return nan_clip(__fadd_rn(__fmul_rn(f.a, g), f.b), f.lo, f.hi);
}

__device__ __forceinline__ Clamped shfl_up(const Clamped& f, int d) {
  return {__shfl_up_sync(0xffffffffu, f.a, d),
          __shfl_up_sync(0xffffffffu, f.b, d),
          __shfl_up_sync(0xffffffffu, f.lo, d),
          __shfl_up_sync(0xffffffffu, f.hi, d)};
}

struct AgcKnobs {
  float rate, ref, max_gain, rb;   // rb = rate * ref
};

// Sample (xr, xi)'s map: a = clip(1 - rate |x|, +-cap), b = rate ref,
// bounds [0, max_gain].
__device__ __forceinline__ Clamped sample_map(const AgcKnobs& k, float xr,
                                              float xi) {
  const float absx =
      __fsqrt_rn(__fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi)));
  return {nan_clip(__fsub_rn(1.f, __fmul_rn(k.rate, absx)), -kAgcCap,
                   kAgcCap),
          k.rb, 0.f, k.max_gain};
}

// One step of the loop on sample (xr, xi), which it overwrites with y:
// g x per plane, or with kComplex the complex product x (g + 0i).
template <bool kComplex>
__device__ __forceinline__ void agc_walk_step(const AgcKnobs& k, float& g,
                                              float& xr, float& xi) {
  const float yr = __fmul_rn(xr, g), yi = __fmul_rn(xi, g);
  const float env =
      __fsqrt_rn(__fadd_rn(__fmul_rn(yr, yr), __fmul_rn(yi, yi)));
  float ng = __fadd_rn(g, __fmul_rn(k.rate, __fsub_rn(k.ref, env)));
  ng = ng < 0.f ? 0.f : ng;   // comparisons: NaN passes through
  ng = ng > k.max_gain ? k.max_gain : ng;
  if (kComplex) {
    const float re = __fsub_rn(yr, __fmul_rn(xi, 0.f));
    xi = __fadd_rn(__fmul_rn(xr, 0.f), yi);
    xr = re;
  } else {
    xr = yr;
    xi = yi;
  }
  g = ng;
}

// Tile sample t's slot in a plane of the shared copy: segment t / L at
// (t / L) * P, P = L | 1.
__device__ __forceinline__ int agc_slot(int t, int L, int P) {
  return (t / L) * P + t % L;
}

template <class F>
struct Quad {   // the 16-byte vector of a float pointer, const or not
  using type = float4;
};
template <>
struct Quad<const float> {
  using type = const float4;
};

// Copy the tile's n samples at row offset `at` between device memory and
// the shared planes (kLoad: into them from p, q; else out of them into p,
// q), coalesced: 16-byte accesses where the tile's rows are 16-byte
// aligned (two complex samples, or four samples of each plane), the rest
// one sample a thread.  kComplex: p is the interleaved complex64 row, q
// unused; else p, q are the planes.
template <bool kComplex, bool kLoad, class F>
__device__ __forceinline__ void agc_copy(F* p, F* q, size_t at, int n,
                                         int L, int P, float* sr,
                                         float* si) {
  using F4 = typename Quad<F>::type;
  constexpr int per = kComplex ? 2 : 4;   // samples a 16-byte access
  F* a = kComplex ? p + 2 * at : p + at;
  F* b = kComplex ? a : q + at;
  const bool vec = (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
  const int nv = vec ? n / per * per : 0;
  for (int v = threadIdx.x; v < nv / per; v += blockDim.x) {
    F4* a4 = reinterpret_cast<F4*>(a) + v;
    F4* b4 = reinterpret_cast<F4*>(b) + v;
    alignas(16) float u[4];
    alignas(16) float w[4];
    if constexpr (kLoad) {
      *reinterpret_cast<float4*>(u) = __ldg(a4);
      if (!kComplex) *reinterpret_cast<float4*>(w) = __ldg(b4);
    }
#pragma unroll
    for (int e = 0; e < per; ++e) {
      const int s = agc_slot(per * v + e, L, P);
      float& re = kComplex ? u[2 * e] : u[e];
      float& im = kComplex ? u[2 * e + 1] : w[e];
      if constexpr (kLoad) {
        sr[s] = re;
        si[s] = im;
      } else {
        re = sr[s];
        im = si[s];
      }
    }
    if constexpr (!kLoad) {
      *a4 = *reinterpret_cast<const float4*>(u);
      if (!kComplex) *b4 = *reinterpret_cast<const float4*>(w);
    }
  }
  for (int t = nv + threadIdx.x; t < n; t += blockDim.x) {
    const int s = agc_slot(t, L, P);
    F* re = kComplex ? a + 2 * t : a + t;
    F* im = kComplex ? re + 1 : b + t;
    if constexpr (kLoad) {
      sr[s] = *re;
      si[s] = *im;
    } else {
      *re = sr[s];
      *im = si[s];
    }
  }
}

// The AGC loop over one stream a block (see the head of this file).
// blockDim.x lanes, a multiple of 32 up to kAgcMaxThreads, of L samples
// each; a tile holds blockDim.x * L <= kAgcTile samples.  rate, ref,
// max_gain: one float each on the device.  kComplex: x and y are complex64
// rows read and written as interleaved floats (xr, yr; xi, yi unused), y =
// x (g + 0i); else float planes, y = g x per plane.
template <bool kComplex>
__global__ void __launch_bounds__(kAgcMaxThreads) agc_segments(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ gain, const float* __restrict__ rate,
    const float* __restrict__ ref, const float* __restrict__ max_gain,
    float* __restrict__ yr, float* __restrict__ yi,
    float* __restrict__ gain_out, int T, int L) {
  __shared__ float sr[kAgcTile + kAgcMaxThreads];
  __shared__ float si[kAgcTile + kAgcMaxThreads];
  __shared__ Clamped warp_total[kAgcMaxThreads / 32];
  __shared__ float carry;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const int P = L | 1;
  AgcKnobs kn;
  kn.rate = rate[0];
  kn.ref = ref[0];
  kn.max_gain = max_gain[0];
  kn.rb = __fmul_rn(kn.rate, kn.ref);
  const size_t row = (size_t)blockIdx.x * T;
  const int tile = blockDim.x * L;
  float* pr = sr + k * P;   // this lane's segment in the shared copy
  float* pi = si + k * P;
  float g = gain[blockIdx.x];   // the gain entering the tile
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int n = min(tile, T - t0);
    agc_copy<kComplex, true>(xr, xi, row + t0, n, L, P, sr, si);
    __syncthreads();
    const int len = max(0, min(n - k * L, L));
    // Fold.  A lane without samples holds the identity; only lanes
    // without samples come after it, so no lane with samples reads it.
    Clamped f = {1.f, 0.f, -CUDART_INF_F, CUDART_INF_F};
    if (len > 0) {
      f = sample_map(kn, pr[0], pi[0]);
      for (int i = 1; i < len; ++i)
        f = compose(f, sample_map(kn, pr[i], pi[i]));
    }
    // Combine: the inclusive scan of the warp's maps, the map before this
    // lane's, the warp's total.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Clamped o = shfl_up(f, d);
      if (lane >= d) f = compose(o, f);
    }
    const Clamped before = shfl_up(f, 1);
    if (lane == 31) warp_total[warp] = f;
    __syncthreads();
    // Entry gain, then the walk.
    float gl = g;
    for (int w = 0; w < warp; ++w) gl = apply(warp_total[w], gl);
    if (lane > 0) gl = apply(before, gl);
    for (int i = 0; i < len; ++i)
      agc_walk_step<kComplex>(kn, gl, pr[i], pi[i]);
    if (len > 0 && k * L + len == n) carry = gl;
    __syncthreads();
    agc_copy<kComplex, false>(yr, yi, row + t0, n, L, P, sr, si);
    g = carry;
    __syncthreads();   // the next tile overwrites sr, si, carry
  }
  if (k == 0) gain_out[blockIdx.x] = g;
}

template <bool kComplex>
int launch_agc(const float* xr, const float* xi, const float* gain,
               const float* rate, const float* ref, const float* max_gain,
               float* yr, float* yi, float* gain_out, int b, int t,
               int threads, int seg, cudaStream_t st) {
  if (threads < 32 || threads % 32 || threads > kAgcMaxThreads || seg < 1 ||
      seg > kAgcTile / threads)
    return (int)cudaErrorInvalidValue;
  agc_segments<kComplex><<<b, threads, 0, st>>>(
      xr, xi, gain, rate, ref, max_gain, yr, yi, gain_out, t, seg);
  return (int)cudaGetLastError();
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

// The AGC loop on [b, t] float planes; rate, ref, max_gain: one float each
// on the device.  The wrapper checks b > 0, t > 0, shapes, dtypes and
// contiguity, and gives the geometry: threads lanes (a multiple of 32, at
// most kAgcMaxThreads) of seg samples, threads * seg <= kAgcTile.
int rr_agc_scan(const float* xr, const float* xi, const float* gain,
                const float* rate, const float* ref, const float* max_gain,
                float* yr, float* yi, float* gain_out, int b, int t,
                int threads, int seg, void* stream) {
  return launch_agc<false>(xr, xi, gain, rate, ref, max_gain, yr, yi,
                           gain_out, b, t, threads, seg,
                           (cudaStream_t)stream);
}

// The same on [b, t] complex64 rows x, read in place, and y (x (g + 0i)),
// written in place; the checks and geometry as for rr_agc_scan.
int rr_agc_step(const void* x, const float* gain, const float* rate,
                const float* ref, const float* max_gain, void* y,
                float* gain_out, int b, int t, int threads, int seg,
                void* stream) {
  return launch_agc<true>(static_cast<const float*>(x), nullptr, gain, rate,
                          ref, max_gain, static_cast<float*>(y), nullptr,
                          gain_out, b, t, threads, seg,
                          (cudaStream_t)stream);
}

}  // extern "C"
