// Overlap-save filter by a dense four-step DFT, with an optional FM-demod
// prologue.
//
// Replaces four TPU kernels of radiorust_tpu/ops/pallas_filter.py:
//   rr_overlap_save  <- fused_overlap_save (:547, body _make_kernel :512 over
//                       _os_pipeline :448)
//   rr_filter_bank   <- fused_filter_bank (:632, body _make_bank_kernel :588)
//   rr_demod_filter  <- fused_demod_filter (:778, body
//                       _make_demod_filter_kernel :749, _make_demod :706,
//                       _make_pair_filter :728)
//   rr_filter_demod_filter <- fused_filter_demod_filter (:886, body
//                       _make_filter_demod_filter_kernel :833)
//
// What it computes, per stream, on z = [prev (m) || cur (n)], N = m + n =
// n1 * n2, time t = i2 + n2*i1, frequency k = k1 + n1*k2:
//   T[k1,i2] = sum_i1 D1[k1,i1] z[i1,i2];   U = T * tw           (launch 1)
//   V[k1,k2] = sum_i2 U[k1,i2] D2[i2,k2];   P = V * G[k1,k2]
//   Q[k1,i2] = sum_k2 P[k1,k2] conj(D2)[k2,i2];  S = Q * conj(tw) (launch 2)
//   y[i1,i2] = sum_k1 E1[k1,i1] S[k1,i2]  for t < n               (launch 3)
// G is the response grid with the 1/N of the inverse folded in, E1 =
// conj(D1)[:, :ho].  The factor matrices come from the host (float64
// design, cast to float32), exactly as the TPU kernel takes them.
// The demod form first computes d = atan2(Im, Re of x * conj(x[-1])) *
// factor (first sample from the carried last sample, or the carried last
// output after a break), writes d, and packs stream 2j into the real and
// 2j+1 into the imaginary part of one transform input [prevd || d], which
// is exact for a real impulse response; the filter then runs at b/2.
// The bank form runs launch 1 once and, in launch 2, each forward row once
// for all K responses; launch 3 runs over the K * b stacked band rows (the
// TPU kernel's stacked inverse) and writes the [b, K, n] output directly.
// The merged form is the filter, then the demod prologue on its filtered
// planes (carried sample: the last *filtered* sample, which it also
// emits), then the pair-packed deemphasis filter.  The TPU kernel kept the
// filtered intermediate in VMEM; here it is a [b, n] device buffer (4.7 MB
// at batch 64 x 9216) that the 50 MB L2 holds between the launches.
//
// What bounds it on an H100: the dense DFT costs 8*(n1 + 2*n2 + ho) flops
// per sample per stream, about 60 MFLOP per stream and step at the
// receive chain's 120 x 128 transform, against 16 bytes per sample of
// device-memory traffic per launch: it is bound by the float32 FMA rate
// and by shared-memory operand reads, not by device memory.  The bank
// costs 8*(n1 + n2) flops per sample forward once and 8*(n2 + ho) per
// sample and band inverse: 6.7 GFLOP for the stereo decoder's three bands
// at batch 64, against 10.6 GFLOP for three separate filters.
//
// What the design does about it: three launches over a [X, N] complex
// scratch (two float planes) that the wrapper allocates.  Launches 1 and 3
// stage a 32-column strip of one stream's n1 x n2 grid in shared memory,
// and each warp walks one row of D1 (or E1) that all its lanes read at the
// same address.  Launch 2 keeps the whole n2 x n2 D2 in shared memory and
// runs several grid rows per block, so D2 is read from device memory once
// per block.  Plain float32 FMA, no tensor cores and no TF32: a radix FFT
// and tensor-core DFT stages are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // grid columns per block in launches 1 and 3
constexpr int kRowsY = 8;     // threadIdx.y extent in launches 1 and 3
constexpr int kN2 = 128;      // the port's fixed lane factor
constexpr int kRowsPerBlock = 4;  // grid rows in flight per block, launch 2
constexpr int kMidBlocks = 264;   // two waves of 132 SMs

// Launch 1: stage-1 DFT over i1 of one 32-column strip, then the twiddle.
// grid (n2 / kCols, X), block (kCols, kRowsY), shared 2 * n1 * kCols floats.
__global__ void os_forward1(const float* __restrict__ prevr,
                            const float* __restrict__ previ, int prev_stride,
                            const float* __restrict__ curr,
                            const float* __restrict__ curi, int cur_stride,
                            int m, const float* __restrict__ d1r,
                            const float* __restrict__ d1i,
                            const float* __restrict__ twr,
                            const float* __restrict__ twi,
                            float* __restrict__ ar, float* __restrict__ ai,
                            int n1, int n2) {
  extern __shared__ float smem[];
  float* zr = smem;
  float* zi = smem + n1 * kCols;
  const int s = blockIdx.y;
  const int tx = threadIdx.x;
  const int c = blockIdx.x * kCols + tx;
  for (int i1 = threadIdx.y; i1 < n1; i1 += kRowsY) {
    const int t = i1 * n2 + c;
    float vr, vi;
    if (t < m) {
      vr = prevr[(size_t)s * prev_stride + t];
      vi = previ[(size_t)s * prev_stride + t];
    } else {
      vr = curr[(size_t)s * cur_stride + (t - m)];
      vi = curi[(size_t)s * cur_stride + (t - m)];
    }
    zr[i1 * kCols + tx] = vr;
    zi[i1 * kCols + tx] = vi;
  }
  __syncthreads();
  const size_t N = (size_t)n1 * n2;
  for (int k1 = threadIdx.y; k1 < n1; k1 += kRowsY) {
    const float* dr = d1r + (size_t)k1 * n1;
    const float* di = d1i + (size_t)k1 * n1;
    float accr = 0.f, acci = 0.f;
    for (int i1 = 0; i1 < n1; ++i1) {
      const float a = dr[i1], b = di[i1];
      const float x = zr[i1 * kCols + tx], y = zi[i1 * kCols + tx];
      accr = fmaf(a, x, fmaf(-b, y, accr));
      acci = fmaf(a, y, fmaf(b, x, acci));
    }
    const float wr = twr[(size_t)k1 * n2 + c], wi = twi[(size_t)k1 * n2 + c];
    ar[s * N + (size_t)k1 * n2 + c] = accr * wr - acci * wi;
    ai[s * N + (size_t)k1 * n2 + c] = accr * wi + acci * wr;
  }
}

// Launch 2: per grid row (stream, k1): n2-point DFT, then for each of
// nbands responses: multiply, inverse n2-point DFT, conjugate twiddle,
// written to row band * rows + row of the output scratch.  The filter runs
// it in place with one band; the bank reads each forward row once for all
// its bands.
// grid kMidBlocks (grid-stride over rows), block (kN2, kRowsPerBlock),
// shared D2 (2 * kN2 * kN2 floats) + 2 * kRowsPerBlock * kN2 floats.
__global__ void __launch_bounds__(kN2 * kRowsPerBlock)
os_middle(const float* ar, const float* ai, float* outr, float* outi,
          const float* __restrict__ d2r, const float* __restrict__ d2i,
          const float* __restrict__ gr, const float* __restrict__ gi,
          const float* __restrict__ twr, const float* __restrict__ twi,
          int rows, int n1, int nbands) {
  extern __shared__ float smem[];
  float* sd2r = smem;
  float* sd2i = sd2r + kN2 * kN2;
  float* ur = sd2i + kN2 * kN2;
  float* ui = ur + kRowsPerBlock * kN2;
  const int tid = threadIdx.y * kN2 + threadIdx.x;
  for (int i = tid; i < kN2 * kN2; i += kN2 * kRowsPerBlock) {
    sd2r[i] = d2r[i];
    sd2i[i] = d2i[i];
  }
  const int tx = threadIdx.x;
  float* rr = ur + threadIdx.y * kN2;
  float* ri = ui + threadIdx.y * kN2;
  for (int g = blockIdx.x * kRowsPerBlock; g < rows;
       g += gridDim.x * kRowsPerBlock) {
    const int row = g + threadIdx.y;
    const bool live = row < rows;
    const int k1 = row % n1;
    const size_t at = (size_t)row * kN2 + tx;
    __syncthreads();  // D2 staged; previous iteration done with rr/ri
    if (live) {
      rr[tx] = ar[at];
      ri[tx] = ai[at];
    }
    __syncthreads();
    float vr = 0.f, vi = 0.f;
    if (live) {
      for (int i2 = 0; i2 < kN2; ++i2) {   // V[k2 = tx]
        const float a = rr[i2], b = ri[i2];
        const float c = sd2r[i2 * kN2 + tx], d = sd2i[i2 * kN2 + tx];
        vr = fmaf(a, c, fmaf(-b, d, vr));
        vi = fmaf(a, d, fmaf(b, c, vi));
      }
    }
    for (int band = 0; band < nbands; ++band) {
      float pr = 0.f, pi = 0.f;
      if (live) {
        const size_t gat = ((size_t)band * n1 + k1) * kN2 + tx;
        const float g0 = gr[gat], g1 = gi[gat];
        pr = vr * g0 - vi * g1;
        pi = vr * g1 + vi * g0;
      }
      __syncthreads();  // every row of the block is done reading rr/ri
      if (live) {
        rr[tx] = pr;
        ri[tx] = pi;
      }
      __syncthreads();
      if (live) {
        float qr = 0.f, qi = 0.f;
        for (int k2 = 0; k2 < kN2; ++k2) {   // Q[i2 = tx], times conj(D2)
          const float a = rr[k2], b = ri[k2];
          const float c = sd2r[k2 * kN2 + tx], d = sd2i[k2 * kN2 + tx];
          qr = fmaf(a, c, fmaf(b, d, qr));
          qi = fmaf(b, c, fmaf(-a, d, qi));
        }
        const float wr = twr[(size_t)k1 * kN2 + tx];
        const float wi = twi[(size_t)k1 * kN2 + tx];
        const size_t out = ((size_t)band * rows + row) * kN2 + tx;
        outr[out] = qr * wr + qi * wi;
        outi[out] = qi * wr - qr * wi;
      }
    }
  }
}

// Launch 3: inverse stage 1 over k1 for rows i1 < ho, written where t < n.
// Scratch stream s lands on output row (s % row_mod) * row_mul + s / row_mod
// (the identity for row_mod = X, row_mul = 1; the bank's [b, K, n] layout
// for row_mod = b, row_mul = K).
// grid (n2 / kCols, X), block (kCols, kRowsY), shared 2 * n1 * kCols floats.
__global__ void os_inverse1(const float* __restrict__ ar,
                            const float* __restrict__ ai,
                            const float* __restrict__ e1r,
                            const float* __restrict__ e1i,
                            float* __restrict__ outr,
                            float* __restrict__ outi, int out_stride, int n,
                            int n1, int n2, int ho, int row_mod,
                            int row_mul) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + n1 * kCols;
  const int s = blockIdx.y;
  const size_t o = (size_t)(s % row_mod) * row_mul + s / row_mod;
  const int tx = threadIdx.x;
  const int c = blockIdx.x * kCols + tx;
  const size_t N = (size_t)n1 * n2;
  for (int k1 = threadIdx.y; k1 < n1; k1 += kRowsY) {
    sr[k1 * kCols + tx] = ar[s * N + (size_t)k1 * n2 + c];
    si[k1 * kCols + tx] = ai[s * N + (size_t)k1 * n2 + c];
  }
  __syncthreads();
  for (int i1 = threadIdx.y; i1 < ho; i1 += kRowsY) {
    float accr = 0.f, acci = 0.f;
    for (int k1 = 0; k1 < n1; ++k1) {
      const float a = e1r[(size_t)k1 * ho + i1], b = e1i[(size_t)k1 * ho + i1];
      const float x = sr[k1 * kCols + tx], y = si[k1 * kCols + tx];
      accr = fmaf(a, x, fmaf(-b, y, accr));
      acci = fmaf(a, y, fmaf(b, x, acci));
    }
    const int t = i1 * n2 + c;
    if (t < n) {
      outr[o * out_stride + t] = accr;
      outi[o * out_stride + t] = acci;
    }
  }
}

// Demod prologue: thread per (stream s, t < N).  t < m copies prevd, the
// rest demodulates sample i = t - m; stream 2j lands in zr[j], 2j+1 in zi[j].
// Where flr/fli are given, the last input sample of each stream is written
// there (the merged kernel's carried filtered sample).
// grid (ceil(N / 256), b), block 256.
__global__ void demod_pack(const float* __restrict__ curr,
                           const float* __restrict__ curi,
                           const float* __restrict__ plr,
                           const float* __restrict__ pli,
                           const float* __restrict__ prevd,
                           const float* __restrict__ last_out,
                           const float* __restrict__ have_prev,
                           const float* __restrict__ fac,
                           float* __restrict__ dout, float* __restrict__ zr,
                           float* __restrict__ zi, float* __restrict__ flr,
                           float* __restrict__ fli, int n, int m) {
  const int s = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = n + m;
  if (t >= N) return;
  float v;
  if (t < m) {
    v = prevd[(size_t)s * m + t];
  } else {
    const int i = t - m;
    const size_t at = (size_t)s * n + i;
    const float xr = curr[at], xi = curi[at];
    const float sr = i == 0 ? plr[s] : curr[at - 1];
    const float si = i == 0 ? pli[s] : curi[at - 1];
    const float re = xr * sr + xi * si;   // Re[x * conj(x[-1])]
    const float im = xi * sr - xr * si;   // Im[x * conj(x[-1])]
    v = atan2f(im, re) * fac[s];
    if (i == 0 && have_prev[s] < 0.5f) v = last_out[s];
    dout[at] = v;
    if (flr != nullptr && i == n - 1) {
      flr[s] = xr;
      fli[s] = xi;
    }
  }
  float* z = (s & 1) ? zi : zr;
  z[(size_t)(s >> 1) * N + t] = v;
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The three launches on X streams and nbands responses (grid planes
// [nbands, n1, 128]).  Launch 1 writes the forward scratch fr/fi [X, N];
// launch 2 writes band k of stream s to row k * X + s of the band scratch
// br/bi [nbands * X, N] (the forward scratch itself, in place, for one
// band); launch 3 writes it to output row s * nbands + k.
int run_stages(const float* prevr, const float* previ, int prev_stride,
               const float* curr, const float* curi, int cur_stride, int m,
               int n, int X, int nbands, const float* d1r, const float* d1i,
               const float* d2r, const float* d2i, const float* twr,
               const float* twi, const float* e1r, const float* e1i,
               const float* gr, const float* gi, float* fr, float* fi,
               float* br, float* bi, float* outr, float* outi,
               int out_stride, int n1, int ho, cudaStream_t stream) {
  const int n2 = kN2;
  const size_t strip = sizeof(float) * 2 * n1 * kCols;
  const size_t mid = sizeof(float) * 2 * (kN2 * kN2 + kRowsPerBlock * kN2);
  int err;
  if ((err = set_smem((const void*)os_forward1, strip))) return err;
  if ((err = set_smem((const void*)os_middle, mid))) return err;
  if ((err = set_smem((const void*)os_inverse1, strip))) return err;
  const dim3 threads(kCols, kRowsY);
  os_forward1<<<dim3(n2 / kCols, X), threads, strip, stream>>>(
      prevr, previ, prev_stride, curr, curi, cur_stride, m, d1r, d1i, twr,
      twi, fr, fi, n1, n2);
  if ((err = (int)cudaGetLastError())) return err;
  const int rows = X * n1;
  int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMidBlocks) blocks = kMidBlocks;
  os_middle<<<blocks, dim3(kN2, kRowsPerBlock), mid, stream>>>(
      fr, fi, br, bi, d2r, d2i, gr, gi, twr, twi, rows, n1, nbands);
  if ((err = (int)cudaGetLastError())) return err;
  os_inverse1<<<dim3(n2 / kCols, X * nbands), threads, strip, stream>>>(
      br, bi, e1r, e1i, outr, outi, out_stride, n, n1, n2, ho, X, nbands);
  return (int)cudaGetLastError();
}

// One response, launch 2 in place on the scratch.
int run_pipeline(const float* prevr, const float* previ, int prev_stride,
                 const float* curr, const float* curi, int cur_stride,
                 int m, int n, int X, const float* d1r, const float* d1i,
                 const float* d2r, const float* d2i, const float* twr,
                 const float* twi, const float* e1r, const float* e1i,
                 const float* gr, const float* gi, float* scr_r,
                 float* scr_i, float* outr, float* outi, int out_stride,
                 int n1, int ho, cudaStream_t stream) {
  return run_stages(prevr, previ, prev_stride, curr, curi, cur_stride, m, n,
                    X, 1, d1r, d1i, d2r, d2i, twr, twi, e1r, e1i, gr, gi,
                    scr_r, scr_i, scr_r, scr_i, outr, outi, out_stride, n1,
                    ho, stream);
}

}  // namespace

extern "C" {

// One overlap-save step for X complex streams: prev [X, m] and cur [X, n]
// planes (row strides given), grid planes [n1, 128], scratch planes
// [X, N], out planes [X, n] (row stride given).
int rr_overlap_save(const float* prevr, const float* previ, int prev_stride,
                    const float* curr, const float* curi, int cur_stride,
                    int m, int n, int X, const float* d1r, const float* d1i,
                    const float* d2r, const float* d2i, const float* twr,
                    const float* twi, const float* e1r, const float* e1i,
                    const float* gr, const float* gi, float* scr_r,
                    float* scr_i, float* outr, float* outi, int out_stride,
                    int n1, int ho, void* stream) {
  return run_pipeline(prevr, previ, prev_stride, curr, curi, cur_stride, m,
                      n, X, d1r, d1i, d2r, d2i, twr, twi, e1r, e1i, gr, gi,
                      scr_r, scr_i, outr, outi, out_stride, n1, ho,
                      (cudaStream_t)stream);
}

// FM demod of b streams (b even) into dout [b, n] and the pair-packed
// transform input zr/zi [b/2, N], then the overlap-save pipeline on it,
// writing y [b, n] (stream 2j from the real, 2j+1 from the imaginary part).
int rr_demod_filter(const float* curr, const float* curi, const float* plr,
                    const float* pli, const float* prevd,
                    const float* last_out, const float* have_prev,
                    const float* fac, float* dout, float* zr, float* zi,
                    int b, int n, int m, const float* d1r, const float* d1i,
                    const float* d2r, const float* d2i, const float* twr,
                    const float* twi, const float* e1r, const float* e1i,
                    const float* gr, const float* gi, float* scr_r,
                    float* scr_i, float* y, int n1, int ho, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = n + m;
  demod_pack<<<dim3((N + 255) / 256, b), 256, 0, st>>>(
      curr, curi, plr, pli, prevd, last_out, have_prev, fac, dout, zr, zi,
      nullptr, nullptr, n, m);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return run_pipeline(zr, zi, N, zr + m, zi + m, N, m, n, b / 2, d1r, d1i,
                      d2r, d2i, twr, twi, e1r, e1i, gr, gi, scr_r, scr_i, y,
                      y + n, 2 * n, n1, ho, st);
}

// Channel filter, FM demod and deemphasis filter of b streams (b even), the
// two filters sharing the factor matrices and the history length m:
// the channel filter writes the filtered planes fr/fi [b, n]; the demod
// prologue reads them with the carried filtered sample plr/pli, writes
// dout [b, n], zr/zi [b/2, N] and the last filtered sample flr/fli [b];
// the deemphasis filter writes y [b, n] from the pair-packed zr/zi.  The
// scratch planes hold [b, N].
int rr_filter_demod_filter(
    const float* prevr, const float* previ, const float* curr,
    const float* curi, const float* plr, const float* pli,
    const float* prevd, const float* last_out, const float* have_prev,
    const float* fac, float* fr, float* fi, float* dout, float* zr,
    float* zi, float* flr, float* fli, int b, int n, int m,
    const float* d1r, const float* d1i, const float* d2r, const float* d2i,
    const float* twr, const float* twi, const float* e1r, const float* e1i,
    const float* g1r, const float* g1i, const float* g2r, const float* g2i,
    float* scr_r, float* scr_i, float* y, int n1, int ho, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = n + m;
  int err = run_pipeline(prevr, previ, m, curr, curi, n, m, n, b, d1r, d1i,
                         d2r, d2i, twr, twi, e1r, e1i, g1r, g1i, scr_r,
                         scr_i, fr, fi, n, n1, ho, st);
  if (err) return err;
  demod_pack<<<dim3((N + 255) / 256, b), 256, 0, st>>>(
      fr, fi, plr, pli, prevd, last_out, have_prev, fac, dout, zr, zi, flr,
      fli, n, m);
  if ((err = (int)cudaGetLastError())) return err;
  return run_pipeline(zr, zi, N, zr + m, zi + m, N, m, n, b / 2, d1r, d1i,
                      d2r, d2i, twr, twi, e1r, e1i, g2r, g2i, scr_r, scr_i,
                      y, y + n, 2 * n, n1, ho, st);
}

// K overlap-save filters of b complex streams sharing one forward
// transform: prev [b, m] and cur [b, n] planes, grid planes [K, n1, 128],
// forward scratch fr/fi [b, N], band scratch br/bi [K * b, N], out planes
// [b, K, n].
int rr_filter_bank(const float* prevr, const float* previ, const float* curr,
                   const float* curi, int m, int n, int b, int nbands,
                   const float* d1r, const float* d1i, const float* d2r,
                   const float* d2i, const float* twr, const float* twi,
                   const float* e1r, const float* e1i, const float* gr,
                   const float* gi, float* fr, float* fi, float* br,
                   float* bi, float* outr, float* outi, int n1, int ho,
                   void* stream) {
  return run_stages(prevr, previ, m, curr, curi, n, m, n, b, nbands, d1r,
                    d1i, d2r, d2i, twr, twi, e1r, e1i, gr, gi, fr, fi, br,
                    bi, outr, outi, n, n1, ho, (cudaStream_t)stream);
}

}  // extern "C"
