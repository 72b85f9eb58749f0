// Overlap-save filter by a four-step FFT, with an optional FM-demod
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
// n1 * n2 with n2 a power of two up to 256 (the plan of ops/filter.py
// kernel_factors: 128 wherever it divides N), time t = i2 + n2*i1,
// frequency k = k1 + n1*k2:
//   T[k1,i2] = FFT_n1 of column i2 of z[i1,i2];   U = T * tw       (launch 1)
//   V[k1,k2] = FFT_n2 of row k1 of U;   P = V * G[k1,k2]
//   S[k1,i2] = inverse FFT_n2 of row k1 of P, times conj(tw)       (launch 2)
//   y[i1,i2] = inverse FFT_n1 of column i2 of S, for t < n          (launch 3)
// with tw[k1,i2] = exp(-2 pi i k1 i2 / N) and G the response grid with
// the 1/N of the inverse folded in.  The TPU kernel ran each stage as a
// dense DFT on its matrix unit; the H100 has no float32 matrix unit at
// this precision, so here each stage is a radix FFT.  Every twiddle and
// root comes from float32 tables designed in float64 on the host
// (ops/filter.py _tables: the n1 column roots, the n2 row roots, tw) and
// the column pass order from its radices (ops/filter.py fft_radices).
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
// What bounds it on an H100: bytes.  Each launch reads and writes about
// 16 bytes per sample and stream (two float planes in, two out); the
// flops are some 160 per sample over all three launches at the receive
// chain's 120 x 128 transform (column passes 8, 3, 5; row passes 4 and
// 2^5, forward and inverse), about 3 flops per byte where the card
// balances at 20.  A prime column length p runs one generic pass of 8p
// flops per sample (n1 = 761: the dense DFT's cost, no more).  The bank
// reads the forward rows once for its K bands and writes K inverse rows.
// The dense four-step DFT this replaces cost 8 * (n1 + 256 + ho) flops
// per sample (3584 at n1 = 120) and was bound by FMA issue and
// shared-memory operand loads.
//
// What the design does about it: three launches over a [X, N] complex
// scratch (two float planes) that the wrapper allocates, each touching
// device memory once per sample.  Launches 1 and 3 stage a strip of C
// columns of one stream's grid (the widest of 32, 16, ..., 1 within n2
// whose two strip buffers of n1 rows and the column roots fit shared
// memory: 32 up to n1 = 447, 16 up to 874, 8 up to 1704, ..., one column
// up to 9685 rows, so a long column streams narrower strips) with
// 16-byte cp.async copies (four loads where a chunk straddles the
// prev || cur seam or is misaligned; scalar loads in strips under four
// columns) and run the column FFT as Stockham passes between the two
// buffers: radix 8, 4, 2, 3 and 5 butterflies, one thread per butterfly
// and column, and one generic pass (one thread per output) for any other
// prime.  A column past a one-column strip (n1 > 9685: an odd N past
// 9685, N = 2 x odd past 19370, ...) takes the same passes in device
// memory instead, one launch per pass over all columns of all grids,
// between the forward (or band) scratch and a column scratch [X, N] the
// wrapper allocates (10 MB a pair at m = n = 10001, batch 64).  It is the
// slow route that is right: a generic pass of a prime p re-reads each
// input p times through L1 and gathers its roots, 8p flops a sample (N =
// 19373: 155 kflop a sample); measured on an H100 80GB HBM3 at 700 W, #3
// takes 1.08 ms at m = n = 10001, batch 64 (passes of 73 and 137), and
// 7.5 ms at the prime N = 19373, batch 2.  Launch 2 holds one grid row
// in registers, V = n2 / 32 complex values a lane on a warp (n2 >= 32; a
// row of n2 < 32 points takes n2 lanes, one value each), and runs the
// row FFT there: a radix-V pass across the lane's values, then radix-2
// passes across lanes through __shfl_xor_sync; no matrix sits in shared
// memory, so 9 blocks of 4 rows fit an SM (56 registers a thread at n2 =
// 128) and even 512 rows spread over 128 blocks.  Plain float32 FMA: no
// tensor cores, TF32 or library FFT.  Measured on an H100 80GB HBM3 at 700 W,
// the three launches move 44 MB in 28.7 us at the receive chain's batch
// 64 (~1.5 TB/s, mostly from L2): each launch is one short wave, and its
// tail and the gaps between launches bound it before either roofline.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "fft.cuh"

namespace {

using namespace rr;

constexpr int kMaxN2 = 256;       // the longest row: 8 values a lane
constexpr int kColThreads = 256;  // threads of a column block: (C, 256 / C)
constexpr int kRowThreads = 128;  // a row block: 4 warps
constexpr size_t kMaxSmem = 232448;  // shared bytes a block may use (H100)

// Tables of one transform geometry (ops/filter.py _tables), unpacked.
struct Plan {
  const float* r1r;  // n1 column roots exp(-2 pi i j / n1), re and im
  const float* r1i;
  const float* r2r;  // n2 row roots exp(-2 pi i j / n2)
  const float* r2i;
  const float* twr;  // [n1, n2] four-step twiddle
  const float* twi;
  const int* radix;  // column radices, in pass order
  int npass;
  int n1;
  int n2;
};

Plan make_plan(const float* tables, const int* radix, int npass, int n2,
               int n1) {
  Plan p;
  p.r1r = tables;
  p.r1i = tables + n1;
  p.r2r = tables + 2 * n1;
  p.r2i = p.r2r + n2;
  p.twr = p.r2i + n2;
  p.twi = p.twr + (size_t)n1 * n2;
  p.radix = radix;
  p.npass = npass;
  p.n1 = n1;
  p.n2 = n2;
  return p;
}

// One Stockham pass of radix P down the C columns of a strip: butterfly
// (k < s, q < m) reads x[k + s*(q + m*j)], j < P, and writes
// y[k + s*(P*q + r)] = DFT_P[r] * w^(q*r*stride), w the n1 column root.
// Element e of column c sits at e * C + c of each plane.
template <int P, bool kInv>
__device__ void radix_pass(const float* xr, const float* xi, float* yr,
                           float* yi, int m, int s, int stride,
                           const float* wr, const float* wi) {
  const int C = blockDim.x, c = threadIdx.x;
  for (int b = threadIdx.y; b < m * s; b += blockDim.y) {
    const int k = b % s, q = b / s;
    cf a[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int at = (k + s * (q + m * j)) * C + c;
      a[j] = {xr[at], xi[at]};
    }
    butterfly<P, kInv>(a);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const cf v = r ? cmul(a[r], root<kInv>(wr, wi, q * r * stride)) : a[r];
      const int at = (k + s * (P * q + r)) * C + c;
      yr[at] = v.r;
      yi[at] = v.i;
    }
  }
}

// The same pass for any other prime p, one thread per output (k, q, r):
// DFT_p row r against the roots w^((j*r mod p) * n1/p), 8p flops.
template <bool kInv>
__device__ void generic_pass(const float* xr, const float* xi, float* yr,
                             float* yi, int p, int m, int s, int stride,
                             int n1, const float* wr, const float* wi) {
  const int C = blockDim.x, c = threadIdx.x, step = n1 / p;
  for (int o = threadIdx.y; o < n1; o += blockDim.y) {
    const int r = o % p, kq = o / p, k = kq % s, q = kq / s;
    float accr = 0.f, acci = 0.f;
    int e = 0;  // j * r mod p
    for (int j = 0; j < p; ++j) {
      const int at = (k + s * (q + m * j)) * C + c;
      const cf w = root<kInv>(wr, wi, e * step);
      const float x = xr[at], y = xi[at];
      accr = fmaf(x, w.r, fmaf(-y, w.i, accr));
      acci = fmaf(x, w.i, fmaf(y, w.r, acci));
      e += r;
      if (e >= p) e -= p;
    }
    cf v = {accr, acci};
    if (r) v = cmul(v, root<kInv>(wr, wi, q * r * stride));
    const int at = (k + s * (p * q + r)) * C + c;
    yr[at] = v.r;
    yi[at] = v.i;
  }
}

// The length-n1 FFT down every column of the strip in buf (planes re, im
// of n1 x C, then a second such pair): the plan's Stockham passes, from
// one buffer to the other.  Returns the buffer holding the result, in
// natural order.  Entered and left with the block synchronised.
template <bool kInv>
__device__ const float* column_fft(float* buf, int plane, const Plan& pl,
                                   const float* wr, const float* wi) {
  float* x = buf;
  float* y = buf + 2 * plane;
  int n = pl.n1, s = 1;
  for (int ps = 0; ps < pl.npass; ++ps) {
    const int p = pl.radix[ps], m = n / p, stride = pl.n1 / n;
    const float *xr = x, *xi = x + plane;
    float *yr = y, *yi = y + plane;
    switch (p) {
      case 2: radix_pass<2, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi); break;
      case 3: radix_pass<3, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi); break;
      case 4: radix_pass<4, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi); break;
      case 5: radix_pass<5, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi); break;
      case 8: radix_pass<8, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi); break;
      default:
        generic_pass<kInv>(xr, xi, yr, yi, p, m, s, stride, pl.n1, wr, wi);
    }
    __syncthreads();
    float* t = x;
    x = y;
    y = t;
    n = m;
    s *= p;
  }
  return x;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Samples t..t+3 of [prev (m) || cur] into shared dst: one 16-byte
// cp.async where they lie on one side of the seam at an aligned address,
// else four loads.
__device__ __forceinline__ void stage4(float* dst, const float* prev,
                                       const float* cur, int t, int m) {
  const float* src =
      t + 4 <= m ? prev + t : (t >= m ? cur + (t - m) : nullptr);
  if (src != nullptr && ((uintptr_t)src & 15) == 0) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = t + e < m ? prev[t + e] : cur[t + e - m];
}

size_t strip_bytes(int n1, int cols) {
  return sizeof(float) * (4 * (size_t)n1 * cols + 2 * (size_t)n1);
}

// The widest strip of 32, 16, ..., 1 columns within a row of n2 that fits
// shared memory (ops/filter.py strip_cols mirrors it); 0 if none does.
int strip_cols(int n1, int n2) {
  for (int c = 32; c >= 1; c >>= 1)
    if (c <= n2 && strip_bytes(n1, c) <= kMaxSmem) return c;
  return 0;
}

// Element (i1, c0 + c) of the n1 x n2 grid of [a (m) || b] into the strip
// planes buf (re) and buf + plane (im), columns c < C: quads of four by
// stage4 where a strip has four columns or more, else one at a time.
__device__ __forceinline__ void stage_strip(float* buf, int plane,
                                            const float* ar, const float* ai,
                                            const float* br, const float* bi,
                                            int m, int n1, int n2, int c0,
                                            int tid, int nt) {
  const int C = blockDim.x;
  if (C >= 4) {
    const int quads = C / 4;
    for (int ch = tid; ch < n1 * quads; ch += nt) {
      const int i1 = ch / quads, cc = 4 * (ch % quads);
      const int t = i1 * n2 + c0 + cc;
      stage4(buf + i1 * C + cc, ar, br, t, m);
      stage4(buf + plane + i1 * C + cc, ai, bi, t, m);
    }
  } else {
    for (int ch = tid; ch < n1 * C; ch += nt) {
      const int i1 = ch / C, cc = ch % C;
      const int t = i1 * n2 + c0 + cc;
      buf[i1 * C + cc] = t < m ? ar[t] : br[t - m];
      buf[plane + i1 * C + cc] = t < m ? ai[t] : bi[t - m];
    }
  }
}

// Launch 1: the column FFT of one strip of C columns of stream s's
// [prev || cur] grid, then the twiddle, written to scratch row s.
// grid (n2 / C, X), block (C, kColThreads / C), shared strip_bytes(n1, C).
__global__ void __launch_bounds__(kColThreads)
    os_forward_columns(const float* __restrict__ prevr,
                       const float* __restrict__ previ, int prev_stride,
                       const float* __restrict__ curr,
                       const float* __restrict__ curi, int cur_stride, int m,
                       Plan pl, float* __restrict__ ar,
                       float* __restrict__ ai) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int n1 = pl.n1, n2 = pl.n2, C = blockDim.x, plane = n1 * C;
  float* wr = buf + 4 * plane;
  float* wi = wr + n1;
  const int s = blockIdx.y, c0 = blockIdx.x * C, tx = threadIdx.x;
  const int tid = threadIdx.y * C + tx, nt = C * blockDim.y;
  const float* pr = prevr + (size_t)s * prev_stride;
  const float* pi = previ + (size_t)s * prev_stride;
  const float* cr = curr + (size_t)s * cur_stride;
  const float* ci = curi + (size_t)s * cur_stride;
  stage_strip(buf, plane, pr, pi, cr, ci, m, n1, n2, c0, tid, nt);
  for (int i = tid; i < n1; i += nt) {
    wr[i] = pl.r1r[i];
    wi[i] = pl.r1i[i];
  }
  cp_async_wait_all();
  __syncthreads();
  const float* x = column_fft<false>(buf, plane, pl, wr, wi);
  const size_t N = (size_t)n1 * n2;
  for (int k1 = threadIdx.y; k1 < n1; k1 += blockDim.y) {
    const int at = k1 * n2 + c0 + tx;
    const cf v = cmul({x[k1 * C + tx], x[plane + k1 * C + tx]},
                      {pl.twr[at], pl.twi[at]});
    ar[s * N + at] = v.r;
    ai[s * N + at] = v.i;
  }
}

// n2 = V * LR point FFT of one grid row held by LR lanes (l = lane % LR)
// of a warp: lane l holds x[l + LR j] in v[j]; on return it holds
// X[V * brev(l) + j] (brev over log2 LR bits).  A radix-V pass across the
// lane's values with twiddle w^(l*j), then radix-2 decimation in
// frequency across lanes l ^ h, h = LR / 2 .. 1 (partners stay in the
// lane's group of LR).
template <int V, int LR>
__device__ __forceinline__ void row_fft(cf* v, int l, const float* wr,
                                        const float* wi) {
  constexpr int n2 = V * LR;
  if constexpr (V > 1) butterfly<V, false>(v);
#pragma unroll
  for (int j = 1; j < V; ++j) v[j] = cmul(v[j], root<false>(wr, wi, l * j));
#pragma unroll
  for (int h = LR / 2; h >= 1; h >>= 1) {
    const bool upper = l & h;
    const cf w = root<false>(wr, wi, (l & (h - 1)) * (n2 / (2 * h)));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const cf p = {__shfl_xor_sync(0xffffffffu, v[j].r, h),
                    __shfl_xor_sync(0xffffffffu, v[j].i, h)};
      v[j] = upper ? cmul(p - v[j], w) : v[j] + p;
    }
  }
}

// The inverse of row_fft (unnormalised): from X[V * brev(l) + j] in v[j]
// to x[l + LR j], by radix-2 decimation in time across lanes, h = 1 ..
// LR / 2, the conjugate twiddle, and the inverse radix-V pass.
template <int V, int LR>
__device__ __forceinline__ void row_ifft(cf* v, int l, const float* wr,
                                         const float* wi) {
  constexpr int n2 = V * LR;
#pragma unroll
  for (int h = 1; h < LR; h <<= 1) {
    const bool upper = l & h;
    const cf w = root<true>(wr, wi, (l & (h - 1)) * (n2 / (2 * h)));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (upper) v[j] = cmul(v[j], w);
      const cf p = {__shfl_xor_sync(0xffffffffu, v[j].r, h),
                    __shfl_xor_sync(0xffffffffu, v[j].i, h)};
      v[j] = upper ? p - v[j] : v[j] + p;
    }
  }
#pragma unroll
  for (int j = 1; j < V; ++j) v[j] = cmul(v[j], root<true>(wr, wi, l * j));
  if constexpr (V > 1) butterfly<V, true>(v);
}

// Launch 2: per grid row (stream, k1), LR lanes: the n2 = V * LR point
// FFT, then for each of nbands responses: multiply, inverse FFT,
// conjugate twiddle, written to row band * rows + row of the output
// scratch.  The filter runs it in place with one band (each lane group
// reads its row before it writes); the bank reads each forward row once
// for all its bands.  Lanes past the last row keep to the shuffles with
// zeros and store nothing.
// grid ceil(rows / (kRowThreads / LR)), block kRowThreads.
template <int V, int LR>
__global__ void __launch_bounds__(kRowThreads)
    os_rows(const float* ar, const float* ai, float* outr, float* outi,
            Plan pl, const float* __restrict__ gr,
            const float* __restrict__ gi, int rows, int nbands) {
  constexpr int n2 = V * LR, kLog = LR == 32 ? 5 : LR == 16 ? 4 : LR == 8
      ? 3 : LR == 4 ? 2 : LR == 2 ? 1 : 0;
  __shared__ float wr[n2], wi[n2];
  for (int i = threadIdx.x; i < n2; i += kRowThreads) {
    wr[i] = pl.r2r[i];
    wi[i] = pl.r2i[i];
  }
  __syncthreads();
  const int first = blockIdx.x * (kRowThreads / LR);
  // Whole warps past the last row leave: the shuffles see all 32 lanes.
  if (first + (threadIdx.x >> 5) * (32 / LR) >= rows) return;
  const int l = threadIdx.x % LR;
  const int row = first + threadIdx.x / LR;
  // A row of 32 lanes is a whole warp, live past the check above.
  const bool live = LR == 32 || row < rows;
  const int k1 = live ? row % pl.n1 : 0;
  const size_t at = (size_t)row * n2 + l;
  cf v[V], tw[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = live ? cf{ar[at + LR * j], ai[at + LR * j]} : cf{0.f, 0.f};
    const int t = k1 * n2 + l + LR * j;
    tw[j] = {pl.twr[t], -pl.twi[t]};
  }
  row_fft<V, LR>(v, l, wr, wi);
  const int k2 = kLog ? V * (int)(__brev(l) >> (32 - kLog)) : 0;
  for (int band = 0; band < nbands; ++band) {
    const size_t g = ((size_t)band * pl.n1 + k1) * n2 + k2;
    cf y[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      y[j] = live ? cmul(v[j], {gr[g + j], gi[g + j]}) : cf{0.f, 0.f};
    row_ifft<V, LR>(y, l, wr, wi);
    const size_t out = ((size_t)band * rows + row) * n2 + l;
    if (live) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const cf z = cmul(y[j], tw[j]);
        outr[out + LR * j] = z.r;
        outi[out + LR * j] = z.i;
      }
    }
  }
}

template <int V, int LR>
int launch_rows(const float* ar, const float* ai, float* outr, float* outi,
                const Plan& pl, const float* gr, const float* gi, int rows,
                int nbands, cudaStream_t stream) {
  constexpr int per_block = kRowThreads / LR;
  os_rows<V, LR><<<(rows + per_block - 1) / per_block, kRowThreads, 0,
                   stream>>>(ar, ai, outr, outi, pl, gr, gi, rows, nbands);
  return (int)cudaGetLastError();
}

// Launch 2 at the plan's row length n2 (a power of two up to 256).
int run_rows(const float* ar, const float* ai, float* outr, float* outi,
             const Plan& pl, const float* gr, const float* gi, int rows,
             int nbands, cudaStream_t st) {
  switch (pl.n2) {
    case 1: return launch_rows<1, 1>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 2: return launch_rows<1, 2>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 4: return launch_rows<1, 4>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 8: return launch_rows<1, 8>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 16: return launch_rows<1, 16>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 32: return launch_rows<1, 32>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 64: return launch_rows<2, 32>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 128: return launch_rows<4, 32>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    case 256: return launch_rows<8, 32>(ar, ai, outr, outi, pl, gr, gi, rows, nbands, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch 3: the inverse column FFT of one strip of scratch row s, rows
// i1 < ho written where t < n, to output row (s % row_mod) * row_mul +
// s / row_mod (the identity for row_mod = X, row_mul = 1; the bank's
// [b, K, n] layout for row_mod = b, row_mul = K).
// grid (n2 / C, X), block (C, kColThreads / C), shared strip_bytes(n1, C).
__global__ void __launch_bounds__(kColThreads)
    os_inverse_columns(const float* __restrict__ ar,
                       const float* __restrict__ ai, Plan pl,
                       float* __restrict__ outr, float* __restrict__ outi,
                       int out_stride, int n, int ho, int row_mod,
                       int row_mul) {
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int n1 = pl.n1, n2 = pl.n2, C = blockDim.x, plane = n1 * C;
  const int N = n1 * n2;
  float* wr = buf + 4 * plane;
  float* wi = wr + n1;
  const int s = blockIdx.y, c0 = blockIdx.x * C, tx = threadIdx.x;
  const int tid = threadIdx.y * C + tx, nt = C * blockDim.y;
  const float* sr = ar + (size_t)s * N;
  const float* si = ai + (size_t)s * N;
  // One source: with the seam at N every element comes from sr / si.
  stage_strip(buf, plane, sr, si, sr, si, N, n1, n2, c0, tid, nt);
  for (int i = tid; i < n1; i += nt) {
    wr[i] = pl.r1r[i];
    wi[i] = pl.r1i[i];
  }
  cp_async_wait_all();
  __syncthreads();
  const float* x = column_fft<true>(buf, plane, pl, wr, wi);
  const size_t o = (size_t)(s % row_mod) * row_mul + s / row_mod;
  for (int i1 = threadIdx.y; i1 < ho; i1 += blockDim.y) {
    const int t = i1 * n2 + c0 + tx;
    if (t < n) {
      outr[o * out_stride + t] = x[i1 * C + tx];
      outi[o * out_stride + t] = x[plane + i1 * C + tx];
    }
  }
}

// The column route past a one-column strip (strip_cols 0: n1 > 9685
// rows).  Launches 1 and 3 run the same Stockham passes, butterflies and
// float32 column roots as column_fft, one launch per pass over whole
// [n1, n2] grids in device memory (an L2-resident scratch), one thread per
// butterfly and column (per output and column in a generic prime pass), so
// each pass spreads over the card.

// What a pass reads: element e of column c of grid row s, at t = e * n2 +
// c of [a (m) || b] (row strides sa, sb): launch 1's [prev || cur], or a
// scratch [rows, N] (m = N, a = b).
struct GridSrc {
  const float *ar, *ai, *br, *bi;
  int sa, sb, m;
  __device__ __forceinline__ cf at(int s, int t) const {
    if (t < m) return {ar[(size_t)s * sa + t], ai[(size_t)s * sa + t]};
    return {br[(size_t)s * sb + t - m], bi[(size_t)s * sb + t - m]};
  }
};

// Where a pass writes element e of column c of grid row s: kScratch at
// s * N + e * n2 + c of y; kTwiddle the same times tw[e, c] (launch 1's
// last pass); kOutput at t = e * n2 + c of output row (s % row_mod) *
// row_mul + s / row_mod, where e < ho and t < n (launch 3's last pass, as
// os_inverse_columns writes).
enum DstKind { kScratch, kTwiddle, kOutput };
struct GridDst {
  float *yr, *yi;
  int kind, out_stride, n, ho, row_mod, row_mul;
  __device__ __forceinline__ void put(const Plan& pl, int s, int e, int c,
                                      cf v) const {
    const int t = e * pl.n2 + c;
    size_t at;
    if (kind == kOutput) {
      if (e >= ho || t >= n) return;
      at = ((size_t)(s % row_mod) * row_mul + s / row_mod) * out_stride + t;
    } else {
      if (kind == kTwiddle) v = cmul(v, {pl.twr[t], pl.twi[t]});
      at = (size_t)s * pl.n1 * pl.n2 + t;
    }
    yr[at] = v.r;
    yi[at] = v.i;
  }
};

constexpr int kPassThreads = 256;

// One radix-P pass (P in 2, 3, 4, 5, 8) of every column of grid row
// blockIdx.y: radix_pass with the strip's columns widened to the grid's.
// grid (ceil(n1 / P * n2 / kPassThreads), rows), block kPassThreads.
template <int P, bool kInv>
__global__ void __launch_bounds__(kPassThreads)
    os_column_pass(GridSrc x, GridDst y, Plan pl, int m, int s, int stride) {
  const int row = blockIdx.y, n2 = pl.n2;
  const int idx = blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= m * s * n2) return;
  const int c = idx % n2, b = idx / n2, k = b % s, q = b / s;
  cf a[P];
#pragma unroll
  for (int j = 0; j < P; ++j) a[j] = x.at(row, (k + s * (q + m * j)) * n2 + c);
  butterfly<P, kInv>(a);
#pragma unroll
  for (int r = 0; r < P; ++r)
    y.put(pl, row, k + s * (P * q + r), c,
          r ? cmul(a[r], root<kInv>(pl.r1r, pl.r1i, q * r * stride)) : a[r]);
}

// One generic pass of prime p: generic_pass with the grid's columns.
// grid (ceil(n1 * n2 / kPassThreads), rows), block kPassThreads.
template <bool kInv>
__global__ void __launch_bounds__(kPassThreads)
    os_column_generic(GridSrc x, GridDst y, Plan pl, int p, int m, int s,
                      int stride) {
  const int row = blockIdx.y, n2 = pl.n2;
  const int idx = blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= pl.n1 * n2) return;
  const int c = idx % n2, o = idx / n2;
  const int r = o % p, kq = o / p, k = kq % s, q = kq / s;
  const int step = pl.n1 / p;
  float accr = 0.f, acci = 0.f;
  int e = 0;  // j * r mod p
  for (int j = 0; j < p; ++j) {
    const cf v = x.at(row, (k + s * (q + m * j)) * n2 + c);
    const cf w = root<kInv>(pl.r1r, pl.r1i, e * step);
    accr = fmaf(v.r, w.r, fmaf(-v.i, w.i, accr));
    acci = fmaf(v.r, w.i, fmaf(v.i, w.r, acci));
    e += r;
    if (e >= p) e -= p;
  }
  cf v = {accr, acci};
  if (r) v = cmul(v, root<kInv>(pl.r1r, pl.r1i, q * r * stride));
  y.put(pl, row, k + s * (p * q + r), c, v);
}

// The pass order of an n-point column: ops/filter.py fft_radices (8 while
// it divides, then 4 or 2, 3s, 5s, other primes ascending).  Returns the
// number of passes.
int column_radices(int n, int* out) {
  int np = 0;
  for (int p : {8, 4, 2, 3, 5})
    while (n % p == 0) {
      out[np++] = p;
      n /= p;
    }
  for (int p = 7; n > 1; p += 2)
    while (n % p == 0) {
      out[np++] = p;
      n /= p;
    }
  return np;
}

// Launch 1 or 3 by the device-memory route on `rows` grids: the passes
// from src, each but the last writing near or far (the one before the
// last writes near, and they alternate back), the last writing last.
template <bool kInv>
int column_passes(const GridSrc& src, const GridDst& near,
                  const GridDst& far, const GridDst& last, const Plan& pl,
                  int rows, cudaStream_t stream) {
  int radix[32];
  const int np = column_radices(pl.n1, radix);
  const int N = pl.n1 * pl.n2;
  GridSrc x = src;
  int n = pl.n1, s = 1;
  for (int ps = 0; ps < np; ++ps) {
    const int p = radix[ps], m = n / p, stride = pl.n1 / n;
    const GridDst& y = ps == np - 1 ? last : (np - 1 - ps) % 2 ? near : far;
    // Threads a grid row: one a butterfly (specialised radices) or one an
    // output (a generic prime, 7 included), times the columns.
    const bool special = p == 2 || p == 3 || p == 4 || p == 5 || p == 8;
    const int work = (special ? m * s : pl.n1) * pl.n2;
    const dim3 grid((work + kPassThreads - 1) / kPassThreads, rows);
    switch (p) {
      case 2: os_column_pass<2, kInv><<<grid, kPassThreads, 0, stream>>>(x, y, pl, m, s, stride); break;
      case 3: os_column_pass<3, kInv><<<grid, kPassThreads, 0, stream>>>(x, y, pl, m, s, stride); break;
      case 4: os_column_pass<4, kInv><<<grid, kPassThreads, 0, stream>>>(x, y, pl, m, s, stride); break;
      case 5: os_column_pass<5, kInv><<<grid, kPassThreads, 0, stream>>>(x, y, pl, m, s, stride); break;
      case 8: os_column_pass<8, kInv><<<grid, kPassThreads, 0, stream>>>(x, y, pl, m, s, stride); break;
      default:
        os_column_generic<kInv><<<grid, kPassThreads, 0, stream>>>(x, y, pl, p, m, s, stride);
    }
    if (int err = (int)cudaGetLastError()) return err;
    x = GridSrc{y.yr, y.yi, y.yr, y.yi, N, N, N};
    n = m;
    s *= p;
  }
  return 0;
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
// [nbands, n1, n2]).  Launch 1 writes the forward scratch fr/fi [X, N];
// launch 2 writes band k of stream s to row k * X + s of the band scratch
// br/bi [nbands * X, N] (the forward scratch itself, in place, for one
// band); launch 3 writes it to output row s * nbands + k.  Past a
// one-column strip, launches 1 and 3 take the device-memory route with
// the column scratch tr/ti [nbands * X, N] (null where a strip fits).
int run_stages(const float* prevr, const float* previ, int prev_stride,
               const float* curr, const float* curi, int cur_stride, int m,
               int n, int X, int nbands, const Plan& pl, const float* gr,
               const float* gi, float* fr, float* fi, float* br, float* bi,
               float* outr, float* outi, int out_stride, int ho, float* tr,
               float* ti, cudaStream_t stream) {
  const int cols = strip_cols(pl.n1, pl.n2);
  if (pl.n2 > kMaxN2 || (cols == 0 && tr == nullptr))
    return (int)cudaErrorInvalidValue;
  int err;
  if (cols == 0) {
    const int N = pl.n1 * pl.n2;
    const GridDst tmp{tr, ti, kScratch}, fwd{fr, fi, kScratch},
        bands{br, bi, kScratch};
    const GridDst twiddled{fr, fi, kTwiddle};
    const GridDst out{outr, outi, kOutput, out_stride, n, ho, X, nbands};
    if ((err = column_passes<false>(
             {prevr, previ, curr, curi, prev_stride, cur_stride, m}, tmp, fwd,
             twiddled, pl, X, stream)))
      return err;
    if ((err = run_rows(fr, fi, br, bi, pl, gr, gi, X * pl.n1, nbands,
                        stream)))
      return err;
    // The first inverse pass writes the column scratch, not its input.
    int radix[32];
    const bool odd = (column_radices(pl.n1, radix) - 1) % 2;
    return column_passes<true>({br, bi, br, bi, N, N, N}, odd ? tmp : bands,
                               odd ? bands : tmp, out, pl, X * nbands,
                               stream);
  }
  const size_t strip = strip_bytes(pl.n1, cols);
  if ((err = set_smem((const void*)os_forward_columns, strip))) return err;
  if ((err = set_smem((const void*)os_inverse_columns, strip))) return err;
  const dim3 threads(cols, kColThreads / cols);
  os_forward_columns<<<dim3(pl.n2 / cols, X), threads, strip, stream>>>(
      prevr, previ, prev_stride, curr, curi, cur_stride, m, pl, fr, fi);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = run_rows(fr, fi, br, bi, pl, gr, gi, X * pl.n1, nbands,
                      stream)))
    return err;
  os_inverse_columns<<<dim3(pl.n2 / cols, X * nbands), threads, strip,
                       stream>>>(br, bi, pl, outr, outi, out_stride, n, ho,
                                 X, nbands);
  return (int)cudaGetLastError();
}

// One response, launch 2 in place on the scratch.
int run_pipeline(const float* prevr, const float* previ, int prev_stride,
                 const float* curr, const float* curi, int cur_stride,
                 int m, int n, int X, const Plan& pl, const float* gr,
                 const float* gi, float* scr_r, float* scr_i, float* outr,
                 float* outi, int out_stride, int ho, float* tr, float* ti,
                 cudaStream_t stream) {
  return run_stages(prevr, previ, prev_stride, curr, curi, cur_stride, m, n,
                    X, 1, pl, gr, gi, scr_r, scr_i, scr_r, scr_i, outr, outi,
                    out_stride, ho, tr, ti, stream);
}

}  // namespace

extern "C" {

// Every entry point takes the geometry's tables (ops/filter.py _tables:
// packed float32 roots and twiddle, int32 radices and their count), the
// row length n2, the column length n1, output rows ho = ceil(n / n2) and
// the column scratch planes tr/ti, as many rows as its largest scratch
// (null where n1 fits a one-column strip).

// One overlap-save step for X complex streams: prev [X, m] and cur [X, n]
// planes (row strides given), grid planes [n1, n2], scratch planes
// [X, N], out planes [X, n] (row stride given).
int rr_overlap_save(const float* prevr, const float* previ, int prev_stride,
                    const float* curr, const float* curi, int cur_stride,
                    int m, int n, int X, const float* tables,
                    const int* radix, int npass, int n2, const float* gr,
                    const float* gi, float* scr_r, float* scr_i, float* outr,
                    float* outi, int out_stride, int n1, int ho, float* tr,
                    float* ti, void* stream) {
  return run_pipeline(prevr, previ, prev_stride, curr, curi, cur_stride, m,
                      n, X, make_plan(tables, radix, npass, n2, n1), gr, gi,
                      scr_r, scr_i, outr, outi, out_stride, ho, tr, ti,
                      (cudaStream_t)stream);
}

// FM demod of b streams (b even) into dout [b, n] and the pair-packed
// transform input zr/zi [b/2, N], then the overlap-save pipeline on it,
// writing y [b, n] (stream 2j from the real, 2j+1 from the imaginary part).
int rr_demod_filter(const float* curr, const float* curi, const float* plr,
                    const float* pli, const float* prevd,
                    const float* last_out, const float* have_prev,
                    const float* fac, float* dout, float* zr, float* zi,
                    int b, int n, int m, const float* tables,
                    const int* radix, int npass, int n2, const float* gr,
                    const float* gi, float* scr_r, float* scr_i, float* y,
                    int n1, int ho, float* tr, float* ti, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = n + m;
  demod_pack<<<dim3((N + 255) / 256, b), 256, 0, st>>>(
      curr, curi, plr, pli, prevd, last_out, have_prev, fac, dout, zr, zi,
      nullptr, nullptr, n, m);
  int err = (int)cudaGetLastError();
  if (err) return err;
  return run_pipeline(zr, zi, N, zr + m, zi + m, N, m, n, b / 2,
                      make_plan(tables, radix, npass, n2, n1), gr, gi, scr_r,
                      scr_i, y, y + n, 2 * n, ho, tr, ti, st);
}

// Channel filter, FM demod and deemphasis filter of b streams (b even), the
// two filters sharing the tables and the history length m: the channel
// filter writes the filtered planes fr/fi [b, n]; the demod prologue reads
// them with the carried filtered sample plr/pli, writes dout [b, n],
// zr/zi [b/2, N] and the last filtered sample flr/fli [b]; the deemphasis
// filter writes y [b, n] from the pair-packed zr/zi.  The scratch planes
// hold [b, N].
int rr_filter_demod_filter(
    const float* prevr, const float* previ, const float* curr,
    const float* curi, const float* plr, const float* pli,
    const float* prevd, const float* last_out, const float* have_prev,
    const float* fac, float* fr, float* fi, float* dout, float* zr,
    float* zi, float* flr, float* fli, int b, int n, int m,
    const float* tables, const int* radix, int npass, int n2, const float* g1r,
    const float* g1i, const float* g2r, const float* g2i, float* scr_r,
    float* scr_i, float* y, int n1, int ho, float* tr, float* ti,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = n + m;
  const Plan pl = make_plan(tables, radix, npass, n2, n1);
  int err = run_pipeline(prevr, previ, m, curr, curi, n, m, n, b, pl, g1r,
                         g1i, scr_r, scr_i, fr, fi, n, ho, tr, ti, st);
  if (err) return err;
  demod_pack<<<dim3((N + 255) / 256, b), 256, 0, st>>>(
      fr, fi, plr, pli, prevd, last_out, have_prev, fac, dout, zr, zi, flr,
      fli, n, m);
  if ((err = (int)cudaGetLastError())) return err;
  return run_pipeline(zr, zi, N, zr + m, zi + m, N, m, n, b / 2, pl, g2r,
                      g2i, scr_r, scr_i, y, y + n, 2 * n, ho, tr, ti, st);
}

// K overlap-save filters of b complex streams sharing one forward
// transform: prev [b, m] and cur [b, n] planes, grid planes [K, n1, n2],
// forward scratch fr/fi [b, N], band scratch br/bi [K * b, N], out planes
// [b, K, n].
int rr_filter_bank(const float* prevr, const float* previ, const float* curr,
                   const float* curi, int m, int n, int b, int nbands,
                   const float* tables, const int* radix, int npass, int n2,
                   const float* gr, const float* gi, float* fr, float* fi,
                   float* br, float* bi, float* outr, float* outi, int n1,
                   int ho, float* tr, float* ti, void* stream) {
  return run_stages(prevr, previ, m, curr, curi, n, m, n, b, nbands,
                    make_plan(tables, radix, npass, n2, n1), gr, gi, fr, fi, br,
                    bi, outr, outi, n, ho, tr, ti, (cudaStream_t)stream);
}

}  // extern "C"
