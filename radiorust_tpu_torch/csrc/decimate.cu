// Rational p:q FIR decimation, with an optional complex mixer prologue.
//
// Replaces two TPU kernels of radiorust_tpu/ops/pallas_frontend.py:
//   rr_decimate      <- pallas_decimate      (:181, body _make_decim_kernel :138)
//   rr_mix_decimate  <- fused_mix_decimate   (:241, body _make_kernel :42)
//
// What it computes, per stream s, over buf = [hist || x] (hist = Kw - p):
//   y[s, m*q + r] = sum_{u < Kw} W[r, u] * buf[s, m*p + u]
//   new_hist[s]   = buf[s, n : n + hist]
// on one real plane or two (re, im) sharing the taps.  The mixer form first
// multiplies x by osc[a*inner + b] = A[a] * B[b] and by the per-stream start
// phasor p0, in that order, so the history stays in the mixed domain.
//
// What bounds it on an H100: at the receive chain's shapes (p=8, q=1,
// Kw=295 in the tail; p=8, q=3, Kw=41 at the head) each output costs Kw
// FMAs on inputs that neighbouring outputs share, so read from device
// memory it is memory-bound (read n samples, write n*q/p), while the
// arithmetic is Kw*q/p FMAs per input sample - about 37 in the tail.
//
// What the design does about it: one block owns one stream and a tile of
// kTileM decimation periods.  It stages that tile's input span, read in
// place from hist and x (no concatenated copy in device memory), and the
// [q, Kw] taps in shared memory, then one thread computes one output
// (s, m, r) at a time from shared memory.  Each input sample is read from
// device memory about once (the span overlaps its neighbour by hist).
// The mixer is applied while staging, so the mixed signal never reaches
// device memory.  The last tile's block also writes the new history.
// Plain float32 FMA; no tensor cores.  Outputs of one warp read the span
// at stride p, which costs shared-memory bank conflicts: later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 128;   // decimation periods per block
constexpr int kThreads = 256;

struct Mixer {
  const float* ar;
  const float* ai;
  const float* br;
  const float* bi;
  const float* p0r;
  const float* p0i;
  int inner;
};

// Sample j of [hist || x] of stream s, both planes.  With MIX, x is mixed
// exactly in the order of the TPU kernel: osc = A*B, then x*osc, then *p0.
template <bool MIX, int NP>
__device__ __forceinline__ void load_sample(
    int s, int j, int n, int hist, const float* __restrict__ x0,
    const float* __restrict__ x1, const float* __restrict__ h0,
    const float* __restrict__ h1, const Mixer& mix, float& v0, float& v1) {
  if (j < hist) {
    v0 = h0[(size_t)s * hist + j];
    if (NP == 2) v1 = h1[(size_t)s * hist + j];
    return;
  }
  const int i = j - hist;
  v0 = x0[(size_t)s * n + i];
  if (NP == 2) v1 = x1[(size_t)s * n + i];
  if (MIX) {
    const int a = i / mix.inner;
    const int b = i - a * mix.inner;
    const float ar = mix.ar[a], ai = mix.ai[a];
    const float br = mix.br[b], bi = mix.bi[b];
    // __fmul_rn / __fadd_rn: no FMA contraction, the rounding of the
    // reference's separate multiplies and adds.
    const float oscr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
    const float osci = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
    const float mr0 = __fsub_rn(__fmul_rn(v0, oscr), __fmul_rn(v1, osci));
    const float mi0 = __fadd_rn(__fmul_rn(v0, osci), __fmul_rn(v1, oscr));
    const float pr = mix.p0r[s], pi = mix.p0i[s];
    v0 = __fsub_rn(__fmul_rn(mr0, pr), __fmul_rn(mi0, pi));
    v1 = __fadd_rn(__fmul_rn(mr0, pi), __fmul_rn(mi0, pr));
  }
}

// grid (ceil(M / kTileM), batch), block kThreads.
// Shared: taps [q*kw] then NP spans of (kTileM - 1)*p + kw floats.
template <bool MIX, int NP>
__global__ void __launch_bounds__(kThreads) decimate_kernel(
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ h0, const float* __restrict__ h1,
    const float* __restrict__ w, float* __restrict__ y0,
    float* __restrict__ y1, float* __restrict__ nh0, float* __restrict__ nh1,
    int n, int hist, int p, int q, int kw, Mixer mix) {
  extern __shared__ float smem[];
  const int s = blockIdx.y;
  const int M = n / p;
  const int m0 = blockIdx.x * kTileM;
  const int mt = min(kTileM, M - m0);
  const int span = (mt - 1) * p + kw;
  const int span_alloc = (kTileM - 1) * p + kw;
  float* ws = smem;
  float* b0 = ws + q * kw;
  float* b1 = b0 + span_alloc;

  for (int i = threadIdx.x; i < q * kw; i += blockDim.x) ws[i] = w[i];
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    float v0, v1 = 0.f;
    load_sample<MIX, NP>(s, m0 * p + i, n, hist, x0, x1, h0, h1, mix, v0, v1);
    b0[i] = v0;
    if (NP == 2) b1[i] = v1;
  }
  __syncthreads();

  const size_t out_row = (size_t)s * M * q;
  for (int o = threadIdx.x; o < mt * q; o += blockDim.x) {
    const int ml = o / q;
    const int r = o - ml * q;
    const float* wr = ws + r * kw;
    const float* s0 = b0 + ml * p;
    const float* s1 = b1 + ml * p;
    float acc0 = 0.f, acc1 = 0.f;
    for (int u = 0; u < kw; ++u) {
      const float wu = wr[u];
      acc0 = fmaf(wu, s0[u], acc0);
      if (NP == 2) acc1 = fmaf(wu, s1[u], acc1);
    }
    const size_t at = out_row + (size_t)(m0 + ml) * q + r;
    y0[at] = acc0;
    if (NP == 2) y1[at] = acc1;
  }

  // New history = buf[n : n + hist], recomputed from device memory by the
  // same code path as the staged samples (so the values are identical).
  if (blockIdx.x == gridDim.x - 1) {
    for (int i = threadIdx.x; i < hist; i += blockDim.x) {
      float v0, v1 = 0.f;
      load_sample<MIX, NP>(s, n + i, n, hist, x0, x1, h0, h1, mix, v0, v1);
      nh0[(size_t)s * hist + i] = v0;
      if (NP == 2) nh1[(size_t)s * hist + i] = v1;
    }
  }
}

template <bool MIX, int NP>
int launch(const float* x0, const float* x1, const float* h0,
           const float* h1, const float* w, float* y0, float* y1,
           float* nh0, float* nh1, int b, int n, int hist, int p, int q,
           int kw, Mixer mix, cudaStream_t stream) {
  const int M = n / p;
  const size_t smem =
      sizeof(float) * ((size_t)q * kw + (size_t)NP * ((kTileM - 1) * p + kw));
  cudaError_t err = cudaFuncSetAttribute(
      decimate_kernel<MIX, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kTileM - 1) / kTileM, b);
  decimate_kernel<MIX, NP><<<grid, kThreads, smem, stream>>>(
      x0, x1, h0, h1, w, y0, y1, nh0, nh1, n, hist, p, q, kw, mix);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The wrapper checks the shared-memory size of a launch,
// 4 * (q*kw + nplanes*((kTileM - 1)*p + kw)) bytes, before calling.
int rr_decimate(const float* x0, const float* x1, const float* h0,
                const float* h1, const float* w, float* y0, float* y1,
                float* nh0, float* nh1, int b, int n, int hist, int p, int q,
                int kw, int nplanes, void* stream) {
  Mixer none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1};
  cudaStream_t st = (cudaStream_t)stream;
  if (nplanes == 1)
    return launch<false, 1>(x0, x1, h0, h1, w, y0, y1, nh0, nh1, b, n, hist,
                            p, q, kw, none, st);
  return launch<false, 2>(x0, x1, h0, h1, w, y0, y1, nh0, nh1, b, n, hist, p,
                          q, kw, none, st);
}

int rr_mix_decimate(const float* xr, const float* xi, const float* ar,
                    const float* ai, const float* br, const float* bi,
                    const float* p0r, const float* p0i, const float* hr,
                    const float* hi, const float* w, float* outr,
                    float* outi, float* nhr, float* nhi, int b, int n,
                    int hist, int p, int q, int kw, int inner,
                    void* stream) {
  Mixer mix{ar, ai, br, bi, p0r, p0i, inner};
  return launch<true, 2>(xr, xi, hr, hi, w, outr, outi, nhr, nhi, b, n, hist,
                         p, q, kw, mix, (cudaStream_t)stream);
}

}  // extern "C"
