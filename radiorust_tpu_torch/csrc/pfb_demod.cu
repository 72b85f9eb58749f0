// Polyphase filterbank channelizer with a per-channel FM demod, M = 64.
//
// Replaces one TPU kernel of radiorust_tpu/ops/pallas_channelizer.py:
//   rr_pfb_demod  <- fused_pfb_demod (:130, body _make_kernel :84)
//
// What it computes, per stream s, on x = [history || chunk] cut into frames
// of M samples (the history holds K + 1 frames, so T = chunk / M + 2 frames
// come out; the caller drops the first two):
//   v[t, m] = sum_{j < K} x[(t + j) * M + m] * taps[j, m]       branch FIR
//   y[t, c] = sum_{m < M} v[t, m] * W[m, c]                      branch DFT
//   d[t, c] = atan2(Im, Re of y[t, c] * conj(y[t - 1, c])) * fac[s]
// written frame-major, d[s, t * M + c].  W is exp(-2 pi i m c / M) from the
// host (float64 design cast to float32, as the TPU kernel takes it).  Frame
// 0 has no predecessor: y[-1] is taken as 0, so d[0, c] = 0.  (The TPU
// kernel's frame 0 wraps around to the last frame; the caller drops it
// either way.)
//
// What bounds it on an H100: each output costs 8 * M + 4 * K flops (544 at
// K = 8) on 8 bytes read about once and 4 written.  At 4 streams x 65536
// samples that is 0.14 GFLOP and 3.2 MB per step: 2 us at the float32 FMA
// peak and 1 us at the device-memory peak, so neither bounds it; the
// latency of the three dependent phases and the shared-memory reads do.
//
// What the design does about it: one block per (stream, tile of kTile
// frames), 4 x 33 = 132 blocks at that path, one wave on 132 SMs.  A block
// stages its tile's input span of kTile + K frames, the taps and the
// M x M DFT in shared memory, computes the branch values of its frames and
// of the one frame before them (so no block reads another's output), then
// y by the DFT, then the demod, one thread per (frame, channel) in each
// phase.  The 32 threads of a warp share the frame, so the branch-value
// reads broadcast and the DFT-column reads are consecutive.  The TPU
// kernel's two-frames-per-128-lane block-diagonal DFT and its lane rolls
// are Mosaic layout rules and are not carried over.  Plain float32 FMA,
// native atan2f.

#include <cuda_runtime.h>

namespace {

constexpr int kM = 64;        // channels (the DFT size)
constexpr int kTile = 32;     // output frames per block
constexpr int kThreads = 256;

// grid (ceil(T / kTile), b), block kThreads.  Shared memory (floats):
// span 2 * (kTile + k) * kM (reused for y), taps k * kM, W 2 * kM * kM,
// branch values 2 * (kTile + 1) * kM.
__global__ void __launch_bounds__(kThreads)
pfb_demod_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ fac,
                 const float* __restrict__ taps,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 float* __restrict__ d, int total, int k, int frames) {
  extern __shared__ float smem[];
  const int span = (kTile + k) * kM;
  float* sxr = smem;
  float* sxi = sxr + span;
  float* stap = sxi + span;
  float* swr = stap + k * kM;
  float* swi = swr + kM * kM;
  float* vr = swi + kM * kM;
  float* vi = vr + (kTile + 1) * kM;
  float* yr = sxr;  // y replaces the span once the branch values are in
  float* yi = sxi;

  const int s = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  // Local frame f is frame t0 - 1 + f; its span starts at sample
  // (t0 - 1) * kM + f * kM.
  const long base = (long)(t0 - 1) * kM;
  const float* rowr = xr + (size_t)s * total;
  const float* rowi = xi + (size_t)s * total;
  for (int e = tid; e < span; e += kThreads) {
    const long g = base + e;
    const bool in = g >= 0 && g < total;
    sxr[e] = in ? rowr[g] : 0.f;
    sxi[e] = in ? rowi[g] : 0.f;
  }
  for (int e = tid; e < k * kM; e += kThreads) stap[e] = taps[e];
  for (int e = tid; e < kM * kM; e += kThreads) {
    swr[e] = wr[e];
    swi[e] = wi[e];
  }
  __syncthreads();

  const int rows = kTile + 1;
  for (int e = tid; e < rows * kM; e += kThreads) {   // branch FIR
    const int f = e / kM, m = e % kM;
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < k; ++j) {
      const float w = stap[j * kM + m];
      ar = fmaf(sxr[(f + j) * kM + m], w, ar);
      ai = fmaf(sxi[(f + j) * kM + m], w, ai);
    }
    vr[e] = ar;
    vi[e] = ai;
  }
  __syncthreads();

  for (int e = tid; e < rows * kM; e += kThreads) {   // branch DFT
    const int f = e / kM, c = e % kM;
    float ar = 0.f, ai = 0.f;
    if (t0 - 1 + f >= 0) {
      const float* pr = vr + f * kM;
      const float* pi = vi + f * kM;
      for (int m = 0; m < kM; ++m) {
        const float a = pr[m], b = pi[m];
        const float cr = swr[m * kM + c], ci = swi[m * kM + c];
        ar = fmaf(a, cr, fmaf(-b, ci, ar));
        ai = fmaf(a, ci, fmaf(b, cr, ai));
      }
    }
    yr[e] = ar;
    yi[e] = ai;
  }
  __syncthreads();

  const float fs = fac[s];
  float* out = d + (size_t)s * frames * kM;
  for (int e = tid; e < kTile * kM; e += kThreads) {  // demod
    const int f = e / kM + 1, c = e % kM;
    const int t = t0 + f - 1;
    if (t >= frames) break;
    const float cr = yr[f * kM + c], ci = yi[f * kM + c];
    const float pr = yr[(f - 1) * kM + c], pi = yi[(f - 1) * kM + c];
    const float re = cr * pr + ci * pi;   // Re[y * conj(y[-1])]
    const float im = ci * pr - cr * pi;   // Im[y * conj(y[-1])]
    out[(size_t)t * kM + c] = atan2f(im, re) * fs;
  }
}

}  // namespace

extern "C" {

// Channelize and demodulate b streams: x planes [b, total] with total =
// (k - 1) * 64 + frames * 64, fac [b], taps [k, 64], W planes [64, 64];
// writes d [b, frames * 64].  The wrapper checks the layout.
int rr_pfb_demod(const float* xr, const float* xi, const float* fac,
                 const float* taps, const float* wr, const float* wi,
                 float* d, int b, int total, int k, void* stream) {
  const int frames = total / kM - (k - 1);
  const size_t smem =
      sizeof(float) * ((size_t)2 * (kTile + k) * kM + (size_t)k * kM +
                       2 * kM * kM + 2 * (kTile + 1) * kM);
  cudaError_t err = cudaFuncSetAttribute(
      pfb_demod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((frames + kTile - 1) / kTile, b);
  pfb_demod_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, fac, taps, wr, wi, d, total, k, frames);
  return (int)cudaGetLastError();
}

}  // extern "C"
