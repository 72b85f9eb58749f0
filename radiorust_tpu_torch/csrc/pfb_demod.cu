// Polyphase filterbank channelizer with a per-channel FM demod, M = 64.
//
// Replaces one TPU kernel of radiorust_tpu/ops/pallas_channelizer.py:
//   rr_pfb_demod, rr_pfb_demod_step <- fused_pfb_demod (:130, body
//                                      _make_kernel :84)
//
// What it computes, per stream s, on x = [history || chunk] cut into
// frames of 64 samples (the history holds K + 1 frames, so T + 2 frames t
// come out of a chunk of T frames):
//   v[t, m] = sum_{j < K} x[(t + j) * 64 + m] * taps[j, m]         branch FIR
//   y[t, c] = sum_{m < 64} v[t, m] exp(-2 pi i m c / 64)           branch DFT
//   d[t, c] = atan2(Im, Re of y[t, c] * conj(y[t - 1, c])) * fac[s]  demod
// Two signatures share the kernel:
// - rr_pfb_demod, the JAX function's: x as float planes [b, total], d
//   written frame-major, d[s, t * 64 + c], for every t; y[-1] is taken as
//   0, so d[0, c] = 0 (the TPU kernel wraps around; the callers drop the
//   first two frames either way);
// - rr_pfb_demod_step, the ChannelizerDemod block's step: x read in place
//   as complex64 from two pointers, hist [b, (K + 1) * 64] (zeros where
//   the stream's reset flag is set) and chunk [b, n]; the two warm-up
//   frames are not written; frame u = t - 2 goes channel-major to
//   y[s * 64 + c, u] as complex64 with a zero imaginary part, frame u = 0
//   repeating last_out[s, c] unless have_prev[s] && !reset[s]; frame T - 1
//   to last_out_new [b, 64], and the last (K + 1) * 64 samples of
//   [hist || chunk] to new_hist.
//
// What bounds it on an H100: bytes.  An output reads 8 bytes of input
// (once) and writes 8 (step) or 4 (plane) for 4 K flops of FIR, ~30 of
// FFT and ~8 of demod: at path D (4 streams x 65536 samples, K = 8) the
// step moves 2.1 MB in and 2.1 MB out, 1.26 us at 3.35 TB/s, against
// ~0.3 us of float32 operations.  The kernel it replaces summed the DFT
// as 64 x 64 products over shared memory (512 flops and four shared loads
// a multiply-add for each output, a 32 KB DFT matrix staged by every
// block) in one wave of 132 blocks, and took ~19 us at D.
//
// What the design does about it:
// - The 64-point DFT is an FFT in registers, 64 = 8 x 8, with no matrix:
//   an 8-lane group holds one frame, lane l its branches m = l + 8 j in
//   register j; a radix-8 pass across the registers, the twiddle
//   exp(-2 pi i l k1 / 64) (7 roots a lane, read once from a float32
//   table of 64 designed in float64 on the host, ops/filter.py
//   fft_roots), an 8 x 8 exchange inside the group through a shared tile
//   of 33 complex a row (conflict-free both ways), and a radix-8 pass
//   again: lane k1 then holds channel c = k1 + 8 k2 in register k2.
//   About 30 flops an output.
// - Branch FIR: taps [K, 64] in shared memory; the block's span of input
//   frames staged by plain 16-byte vector loads (two complex samples, or
//   four of a plane; scalar loads where a base pointer is not 16-byte
//   aligned) into shared frames of 72 samples, so the four frames a warp
//   reads at once fall on distinct banks; a lane accumulates its 8
//   branches over the K taps in registers.
// - Demod across frames: a block's 4 warps hold 16 consecutive frames, 4
//   a warp, one an 8-lane group; the previous frame of a channel comes
//   from the group before by __shfl_sync, or, for a warp's first group,
//   from the warp before's last through shared memory.  A block's first
//   frame is a halo it computes itself, so no block reads another's
//   output.  Native atan2f.
// - Filling the card: 15 output frames a block of 128 threads (1 halo
//   frame in 16), 276 blocks at D (K = 8), ~26 KB of shared memory each,
//   every block resident at once (2-3 a SM).  At ~8 warps an SM the time
//   is set by instruction issue and latency, not bytes: a sweep of tile
//   shapes on the H100 (2 to 8 warps, 1 to 4 rounds of 4 frames a warp)
//   found one round a warp, one halo a block, fastest.
// Plain float32 FMA: no tensor cores or TF32.

#include <cuda_runtime.h>

#include <cstdint>

#include "fft.cuh"

namespace {

using namespace rr;

constexpr int kM = 64;                  // channels (the DFT size)
constexpr int kGroups = 4;                 // frames a warp holds
constexpr int kWarps = 4;                  // warps a block
constexpr int kTile = kWarps * kGroups - 1;  // output frames a block
constexpr int kThreads = 32 * kWarps;
constexpr int kFrameStride = kM + 8;       // staged samples a frame (padded)
constexpr int kTileRow = 8 * kGroups + 1;  // exchange tile: complex a row
constexpr int kEdgeRow = 9;                // a warp's last frame: a lane's row

struct Args {
  const float *xr, *xi;            // plane mode: x planes [b, total]
  const float2 *hist, *x;          // step mode: [b, (k + 1) * 64], [b, n]
  const unsigned char *reset, *have_prev;  // step mode: [b] flags
  const float* last_in;            // step mode: [b, 64]
  const float* fac;                // [b] (fac_stride 1) or a scalar (0)
  const float* taps;               // [k, 64]
  const float* roots;              // exp(-2 pi i j / 64), re [64] then im
  float* d;                        // plane mode: [b, count * 64]
  float2 *y, *new_hist;            // step mode: [b * 64, count], [b, (k + 1) * 64]
  float* last_out;                 // step mode: [b, 64]
  int fac_stride, k, n, total;
  int first;      // frame t of output 0: 0 (plane), 2 (step)
  int count;      // output frames a stream
  int frames_in;  // input frames a stream: count + first + k - 1
  int vec;        // every input base pointer 16-byte aligned
};

size_t smem_bytes(int k) {
  return sizeof(float2) * ((size_t)(kTile + k) * kFrameStride +
                           kWarps * 8 * (kTileRow + kEdgeRow)) +
         sizeof(float) * (size_t)k * kM;
}

// Input frames f0 .. f0 + nf - 1 of stream s into the padded shared
// frames sx, zeros outside [0, frames_in).
template <bool kStep>
__device__ void stage(const Args& a, int s, int f0, int nf, float2* sx) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kStep) {
    // Units of two complex samples (one float4); frames f <= k are hist.
    const bool cleared = a.reset[s];
    const int h = (a.k + 1) * kM;
    for (int u = threadIdx.x; u < nf * kM / 2; u += kThreads) {
      const int fl = u / (kM / 2), i = 2 * (u % (kM / 2)), f = f0 + fl;
      float4 v = zero;
      if (f >= 0 && f < a.frames_in) {
        const float2* src = f <= a.k
                                ? a.hist + (size_t)s * h + f * kM + i
                                : a.x + (size_t)s * a.n + (f - a.k - 1) * kM + i;
        v = a.vec ? __ldg(reinterpret_cast<const float4*>(src))
                  : make_float4(src[0].x, src[0].y, src[1].x, src[1].y);
        if (f <= a.k && cleared) v = zero;  // after the load: no wait on it
      }
      *reinterpret_cast<float4*>(sx + fl * kFrameStride + i) = v;
    }
  } else {
    // Units of four samples of each plane.
    for (int u = threadIdx.x; u < nf * kM / 4; u += kThreads) {
      const int fl = u / (kM / 4), i = 4 * (u % (kM / 4)), f = f0 + fl;
      float4 re = zero, im = zero;
      if (f >= 0 && f < a.frames_in) {
        const size_t at = (size_t)s * a.total + f * kM + i;
        if (a.vec) {
          re = __ldg(reinterpret_cast<const float4*>(a.xr + at));
          im = __ldg(reinterpret_cast<const float4*>(a.xi + at));
        } else {
          re = make_float4(a.xr[at], a.xr[at + 1], a.xr[at + 2], a.xr[at + 3]);
          im = make_float4(a.xi[at], a.xi[at + 1], a.xi[at + 2], a.xi[at + 3]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(sx + fl * kFrameStride + i);
      dst[0] = make_float4(re.x, im.x, re.y, im.y);
      dst[1] = make_float4(re.z, im.z, re.w, im.w);
    }
  }
}

// grid (ceil(count / kTile), b), block kThreads, shared smem_bytes(k).
template <bool kStep>
__global__ void __launch_bounds__(kThreads) pfb_demod_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float2* sx = reinterpret_cast<float2*>(smem4);          // staged frames
  float2* xch = sx + (kTile + a.k) * kFrameStride;         // exchange tiles
  float2* edge = xch + kWarps * 8 * kTileRow;              // warps' last frames
  float* st = reinterpret_cast<float*>(edge + kWarps * 8 * kEdgeRow);  // taps

  const int s = blockIdx.y;
  const int o0 = blockIdx.x * kTile;   // the block's first output frame
  const int t0 = a.first + o0;         // ... as frame t
  // The block computes frames t0 - 1 + q, q < kTile + 1: q = 0 is the
  // halo.  Frame t reads input frames t .. t + k - 1, staged at q ..
  // q + k - 1.
  stage<kStep>(a, s, t0 - 1, kTile + a.k, sx);
  for (int e = threadIdx.x; e < a.k * kM; e += kThreads) st[e] = a.taps[e];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 8, l = lane % 8;
  cf tw[8];  // exp(-2 pi i l k1 / 64), k1 < 8
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1)
    tw[k1] = {a.roots[l * k1], a.roots[kM + l * k1]};
  const float fs = a.fac[s * a.fac_stride];
  float2* tile = xch + warp * 8 * kTileRow;
  __syncthreads();

  const int q = warp * kGroups + g;
  const int t = t0 - 1 + q;
  // Branch FIR: v[j] accumulates branch l + 8 j.
  cf v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = {0.f, 0.f};
#pragma unroll 4
  for (int j = 0; j < a.k; ++j) {
    const float2* row = sx + (q + j) * kFrameStride + l;
    const float* tap = st + j * kM + l;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 xv = row[8 * r];
      const float w = tap[8 * r];
      v[r].r = fmaf(xv.x, w, v[r].r);
      v[r].i = fmaf(xv.y, w, v[r].i);
    }
  }
  // 64-point FFT.  Radix 8 across registers (v[k1] = sum_j branch(l + 8 j)
  // W8^(j k1)), twiddle W64^(l k1).
  butterfly<8, false>(v);
#pragma unroll
  for (int k1 = 1; k1 < 8; ++k1) v[k1] = cmul(v[k1], tw[k1]);
  // 8 x 8 exchange inside the group: lane k1 gathers v[k1] of lanes l.
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1)
    tile[k1 * kTileRow + g * 8 + l] = make_float2(v[k1].r, v[k1].i);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 e = tile[l * kTileRow + g * 8 + j];
    v[j] = {e.x, e.y};
  }
  // Radix 8 across the lanes' values: v[k2] = y[t, l + 8 k2].
  butterfly<8, false>(v);
  if (t < 0) {  // before the first frame: y[-1] = 0
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = {0.f, 0.f};
  }
  // The previous frame: the group before's by shuffle; for group 0, the
  // last group of the warp before, through shared memory.
  if (g == kGroups - 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      edge[(warp * 8 + l) * kEdgeRow + r] = make_float2(v[r].r, v[r].i);
  }
  cf prev[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    prev[r] = {__shfl_sync(0xffffffffu, v[r].r, (lane + 24) % 32),
               __shfl_sync(0xffffffffu, v[r].i, (lane + 24) % 32)};
  __syncthreads();
  if (g == 0 && warp > 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 e = edge[((warp - 1) * 8 + l) * kEdgeRow + r];
      prev[r] = {e.x, e.y};
    }
  }

  const int u = o0 + q - 1;  // output frame index of frame t
  if (q > 0 && u < a.count) {
    const bool repeat = kStep && u == 0 && !(a.have_prev[s] && !a.reset[s]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int c = l + 8 * r;
      const float re = v[r].r * prev[r].r + v[r].i * prev[r].i;
      const float im = v[r].i * prev[r].r - v[r].r * prev[r].i;
      float dv = atan2f(im, re) * fs;
      if constexpr (kStep) {
        if (repeat) dv = a.last_in[s * kM + c];
        a.y[((size_t)s * kM + c) * a.count + u] = make_float2(dv, 0.f);
        if (u == a.count - 1) a.last_out[s * kM + c] = dv;
      } else {
        a.d[((size_t)s * a.count + u) * kM + c] = dv;
      }
    }
  }

  if constexpr (kStep) {
    // The new history: the last (k + 1) * 64 samples of [hist || chunk].
    const int h = (a.k + 1) * kM;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < h;
         i += gridDim.x * kThreads) {
      const int at = i + a.n;  // in [hist || chunk]
      float2 e = make_float2(0.f, 0.f);
      if (at >= h)
        e = a.x[(size_t)s * a.n + at - h];
      else if (!a.reset[s])
        e = a.hist[(size_t)s * h + at];
      a.new_hist[(size_t)s * h + i] = e;
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool kStep>
int launch(const Args& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.k);
  cudaError_t err = cudaFuncSetAttribute(
      pfb_demod_kernel<kStep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.count + kTile - 1) / kTile, b);
  pfb_demod_kernel<kStep><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plane mode: x planes [b, total] with total = (k - 1) * 64 + frames * 64,
// fac (fac_stride 1: [b]; 0: one value), taps [k, 64], roots [128]; writes
// d [b, frames * 64].  The wrapper checks the layout.
int rr_pfb_demod(const float* xr, const float* xi, const float* fac,
                 int fac_stride, const float* taps, const float* roots,
                 float* d, int b, int total, int k, void* stream) {
  Args a = {};
  a.xr = xr;
  a.xi = xi;
  a.fac = fac;
  a.fac_stride = fac_stride;
  a.taps = taps;
  a.roots = roots;
  a.d = d;
  a.k = k;
  a.total = total;
  a.first = 0;
  a.frames_in = total / kM;
  a.count = a.frames_in - (k - 1);
  a.vec = aligned16(xr) && aligned16(xi);
  return launch<false>(a, b, (cudaStream_t)stream);
}

// Step mode: hist [b, (k + 1) * 64] and x [b, n] complex64 (n a multiple
// of 64), reset and have_prev [b] bools, last_in [b, 64]; writes y
// [b * 64, n / 64] complex64, new_hist [b, (k + 1) * 64] and last_out
// [b, 64].  The wrapper checks the layout.
int rr_pfb_demod_step(const float2* hist, const float2* x,
                      const unsigned char* reset,
                      const unsigned char* have_prev, const float* last_in,
                      const float* fac, int fac_stride, const float* taps,
                      const float* roots, float2* y, float2* new_hist,
                      float* last_out, int b, int n, int k, void* stream) {
  Args a = {};
  a.hist = hist;
  a.x = x;
  a.reset = reset;
  a.have_prev = have_prev;
  a.last_in = last_in;
  a.fac = fac;
  a.fac_stride = fac_stride;
  a.taps = taps;
  a.roots = roots;
  a.y = y;
  a.new_hist = new_hist;
  a.last_out = last_out;
  a.k = k;
  a.n = n;
  a.first = 2;
  a.count = n / kM;
  a.frames_in = a.count + a.first + k - 1;
  a.vec = aligned16(hist) && aligned16(x);
  return launch<true>(a, b, (cudaStream_t)stream);
}

}  // extern "C"
