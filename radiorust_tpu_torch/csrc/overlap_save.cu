// Overlap-save filter by a four-step FFT, with an optional FM-demod
// prologue.
//
// Replaces four TPU kernels of radiorust_tpu/ops/pallas_filter.py:
//   rr_overlap_save  <- fused_overlap_save (:547, body _make_kernel :512 over
//                       _os_pipeline :448)
//   rr_filter_bank   <- fused_filter_bank (:632, body _make_bank_kernel :588)
//   rr_demod_filter_cluster, rr_demod_filter (the stage route)
//                    <- fused_demod_filter (:778, body
//                       _make_demod_filter_kernel :749, _make_demod :706,
//                       _make_pair_filter :728)
//   rr_filter_demod_filter_cluster, rr_filter_demod_filter (stage route)
//                    <- fused_filter_demod_filter (:886, body
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
// samples (carried sample: the last *filtered* sample, which it also
// emits), then the pair-packed deemphasis filter.
//
// Two routes, chosen by the geometry alone (ops/filter.py
// filter_cluster_size for #3, cluster_size for #5 and #6, the latter
// mirrored by cluster_bytes here); neither gives way to the other.
//
// The stage route (#4 always; #3 past the cluster route's longest column,
// n1 = 96; #5 and #6 where the cluster route does not fit): three launches
// over a [X, N] complex scratch (two float planes) that the wrapper
// allocates, each touching device memory once per
// sample; #5 adds the demod_pack launch before them, #6 runs #3's three,
// demod_pack and #5's three over a [b, n] filtered buffer.
//
// What bounds the stage route on an H100: bytes, on paper.  Each launch
// reads and writes about 16 bytes per sample and stream (two float planes
// in, two out); the flops are some 160 per sample over all three launches
// at the receive chain's 120 x 128 transform (column passes 8, 3, 5; row
// passes 4 and 2^5, forward and inverse), about 3 flops per byte where
// the card balances at 20.  A prime column length p runs one generic pass
// of 8p flops per sample (n1 = 761: the dense DFT's cost, no more).  The
// bank reads the forward rows once for its K bands and writes K inverse
// rows.  The dense four-step DFT this replaces cost 8 * (n1 + 256 + ho)
// flops per sample (3584 at n1 = 120) and was bound by FMA issue and
// shared-memory operand loads.  In practice each launch is one short wave
// (32-64 grids of 120 x 128 at the receive chain's batch 64): measured on
// an H100 80GB HBM3 at 700 W, the three launches of #3 take 27.3 us there
// (10.6, 8.6 and 8.2), #5's four 27.0 and #6's seven 55.6, against bounds
// of 3.8, 3.3 and 4.3 us: launch tails, the gaps between launches and the
// scratch round trips through L2 bound them before either roofline.
//
// Launches 1 and 3 stage a strip of C columns of one stream's grid (the
// widest of 32, 16, ..., 1 within n2 whose two strip buffers of n1 rows
// and the column roots fit shared memory: 32 up to n1 = 447, 16 up to 874,
// 8 up to 1704, ..., one column up to 9685 rows, so a long column streams
// narrower strips) with 16-byte cp.async copies (four loads where a chunk
// straddles the prev || cur seam or is misaligned; scalar loads in strips
// under four columns) and run the column FFT as Stockham passes between
// the two buffers: radix 8, 4, 2, 3 and 5 butterflies, one thread per
// butterfly and column, and one generic pass (one thread per output) for
// any other prime.  A column past a one-column strip (n1 > 9685: an odd N
// past 9685, N = 2 x odd past 19370, ...) takes the same passes in device
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
// tensor cores, TF32 or library FFT.
//
// The cluster route of #3: one launch a call, one thread block cluster of
// C = min(4, n2) blocks a stream (grid (C, X)), block r owning the strip
// of W = n2 / C columns r W .. r W + W - 1 of the stream's grid, staged
// from [prev || cur] by 16-byte cp.async copies: no scratch.  It is one
// cluster_filter (below) and the output rows; its arithmetic is the stage
// route's, operation for operation.  A stream a cluster, and not #6's
// stream pair in a cluster of 8: the receive chain's 64 streams make 256
// blocks either way, but a stream a cluster leaves no odd stream to mask
// (path O runs batch 1, F and M pair real streams into X = b / 2).  At
// A's 120 x 128 grid (W = 32) a block takes 63.4 KB, three an SM
// (registers capped for three): cluster launches place blocks on 124 of
// the 132 SMs, and the card holds 92 clusters of 4 at once, so batch 64
// runs in one wave.  Yet one wave of 256 blocks is 16 warps an SM, and
// each block's passes are the stage route's, issue- and latency-bound
// there: measured on an H100 80GB HBM3 at 700 W (tools/filter_split.py
// --crossover, 64 streams of 6144 + 128 n1 - 6144), the one launch is
// faster than the stage route's three on short columns (n1 = 64: 14.5
// against 16.7 us) and not on long ones (A's n1 = 120: 28.1 against
// 28.1; 144: 39.3 against 35.8), the crossover between n1 = 96 (23.2
// against 23.8) and 100 (25.2 against 25.0).  So the wrapper's rule
// takes it up to n1 = 96 rows (ops/filter.py filter_cluster_size); the
// kernel itself runs any geometry whose block share, filter_cluster_bytes
// = 4 * (4 n1 W + 2 n1 + 2 n2), fits.  #4 keeps the stage route, which
// runs its K bands' inverses side by side across the card: a cluster
// form with the bands in turn was a K-fold latency chain a block (74.0
// against 52.4 us at C).
//
// The cluster route of #5 and #6: one launch a call, one thread block
// cluster of C = min(8, n2) blocks per stream pair (grid (C, b / 2)), and
// the pair's grids stay in the cluster's shared memory from the input
// load to the output store: no scratch, no demod_pack, no [b, n] filtered
// buffer.  Block r owns the strip of W = n2 / C columns r W .. r W + W - 1
// of each grid (#6 both streams' complex grids side by side, then the
// packed grid in the buffer they leave free).  The demod runs on load:
// #5 reads x[t] and x[t - 1] of the chunk from device memory (the carried
// sample at t = 0; last_out after a break) and writes d as it packs; #6
// reads the filtered samples t and t - 1 from the blocks owning their
// columns through distributed shared memory (so a history m off whole
// rows and the t - 1 neighbour at a strip's first column, or the row
// before at i2 = 0, need no special case) and emits flr / fli.  Each
// filter (cluster_filter): the column FFTs locally with the strip's
// Stockham passes; cluster.sync(); each warp takes whole rows across the
// cluster (LR lanes a row, as launch 2), gathers them from the owning
// blocks through map_shared_rank with the twiddle, runs the row FFT, the
// response, the inverse and the conjugate twiddle, and writes the row
// back in place; cluster.sync(); the inverse column FFTs locally.  Output
// rows i1 < ho go straight to y (s0 from the real plane, s1 from the
// imaginary).  No block reads another's shared memory past the last
// cluster barrier, so none leaves while its memory is read.  The
// arithmetic is the stage route's, operation for operation (the row
// stages' select-free form gives the same values): at the receive
// chain's geometry the outputs' error against the plain version is the
// stage route's to every printed digit.
//
// What bounds the cluster route: each block's own critical path.  Bytes
// are read and written once (the bounds' 3.3 / 4.3 us at the receive
// chain); the phases are latency- and issue-bound at one to three blocks
// an SM.  Measured on an H100 80GB HBM3 at 700 W at 64 x 6144 + 9216
// (tools/filter_split.py --clocks), a #5 block spends ~16 us: the demod
// on load 4.7 (atan2f 1.7 of it), forward columns 2.9, the row phase
// 3.7, inverse columns 2.6, each cluster barrier ~1.1 (waiting for the
// slowest block), the rest in the table prologue and the output; #5
// takes 21.7 us a call and #6 51.3 (the parent's stage route 26.8 and
// 55.4 in the same run).  Registers are capped at 80 a thread (three
// blocks an SM): at two, the card's GPCs hold 30 clusters of 8 at once,
// so the receive chain's 32 pairs ran in two waves (28 / 66 us); at
// three it holds 45 and they run in one, some SMs carrying three blocks
// (19 against 16 us a block).  Unrolled column passes and prefetched
// row tables spilled at that cap and were slower.
//
// The rule that picks it for #5 and #6: a block's share,
// cluster_bytes(n1, n2, merged) = 4 * ((4 or 8) * n1 * W + 2 * n1 + 2 *
// n2), within the 227 KB a block may use at the portable C <= 8 (at n2 =
// 128, #5 up to n1 = 876 and #6 up to 445; at n2 = 256, #5 up to 443 and
// #6 never); for #3, n1 <= 96.  Each is checked against
// cudaOccupancyMaxActiveClusters once per kernel and size; a launch that
// fails returns its error and the wrapper raises.

#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <utility>

#include "fft.cuh"

namespace {

using namespace rr;
namespace cg = cooperative_groups;

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

// The threads of a column phase: column c of a strip of C columns, and
// row slot ty of ny.  The column launches take their block's (C, ny)
// shape; the cluster kernels lay their 1-D block out by the strip's width.
struct Lanes {
  int C, c, ty, ny;
};

__device__ __forceinline__ Lanes block_lanes() {
  return {(int)blockDim.x, (int)threadIdx.x, (int)threadIdx.y,
          (int)blockDim.y};
}

// One Stockham pass of radix P down the C columns of a strip: butterfly
// (k < s, q < m) reads x[k + s*(q + m*j)], j < P, and writes
// y[k + s*(P*q + r)] = DFT_P[r] * w^(q*r*stride), w the n1 column root.
// Element e of column c sits at e * C + c of each plane.
template <int P, bool kInv>
__device__ void radix_pass(const float* xr, const float* xi, float* yr,
                           float* yi, int m, int s, int stride,
                           const float* wr, const float* wi,
                           const Lanes& ln) {
  const int C = ln.C, c = ln.c;
  for (int b = ln.ty; b < m * s; b += ln.ny) {
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
                             int n1, const float* wr, const float* wi,
                             const Lanes& ln) {
  const int C = ln.C, c = ln.c, step = n1 / p;
  for (int o = ln.ty; o < n1; o += ln.ny) {
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

// The length-n1 FFT down every column of the strip in x (planes re, im
// of n1 x C), with y a second such pair: the plan's Stockham passes, from
// one buffer to the other.  Returns the buffer holding the result (x or
// y), in natural order.  Entered and left with the block synchronised.
template <bool kInv>
__device__ float* column_fft(float* x, float* y, int plane, const Lanes& ln,
                             const Plan& pl, const float* wr,
                             const float* wi) {
  int n = pl.n1, s = 1;
  for (int ps = 0; ps < pl.npass; ++ps) {
    const int p = pl.radix[ps], m = n / p, stride = pl.n1 / n;
    const float *xr = x, *xi = x + plane;
    float *yr = y, *yi = y + plane;
    switch (p) {
      case 2: radix_pass<2, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi, ln); break;
      case 3: radix_pass<3, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi, ln); break;
      case 4: radix_pass<4, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi, ln); break;
      case 5: radix_pass<5, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi, ln); break;
      case 8: radix_pass<8, kInv>(xr, xi, yr, yi, m, s, stride, wr, wi, ln); break;
      default:
        generic_pass<kInv>(xr, xi, yr, yi, p, m, s, stride, pl.n1, wr, wi,
                           ln);
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
                                            int C, int tid, int nt) {
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
  stage_strip(buf, plane, pr, pi, cr, ci, m, n1, n2, c0, C, tid, nt);
  for (int i = tid; i < n1; i += nt) {
    wr[i] = pl.r1r[i];
    wi[i] = pl.r1i[i];
  }
  cp_async_wait_all();
  __syncthreads();
  const float* x = column_fft<false>(buf, buf + 2 * plane, plane,
                                     block_lanes(), pl, wr, wi);
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
// lane's group of LR).  Each lane stage is select-free: p -+ v by one FMA
// with a sign of +-1, then a multiply by the lane's twiddle, 1 on the
// lower lanes (a product by 1 is exact: the values of (p - v) * w on the
// upper lanes and v + p on the lower).
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
    const float sign = upper ? -1.f : 1.f;
    const cf w1 = upper ? w : cf{1.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const cf p = {__shfl_xor_sync(0xffffffffu, v[j].r, h),
                    __shfl_xor_sync(0xffffffffu, v[j].i, h)};
      v[j] = cmul({fmaf(sign, v[j].r, p.r), fmaf(sign, v[j].i, p.i)}, w1);
    }
  }
}

// The inverse of row_fft (unnormalised): from X[V * brev(l) + j] in v[j]
// to x[l + LR j], by radix-2 decimation in time across lanes, h = 1 ..
// LR / 2 (the upper lanes' values times the conjugate twiddle, the lower
// lanes' times 1, then p -+ v), and the inverse radix-V pass.
template <int V, int LR>
__device__ __forceinline__ void row_ifft(cf* v, int l, const float* wr,
                                         const float* wi) {
  constexpr int n2 = V * LR;
#pragma unroll
  for (int h = 1; h < LR; h <<= 1) {
    const bool upper = l & h;
    const cf w = root<true>(wr, wi, (l & (h - 1)) * (n2 / (2 * h)));
    const float sign = upper ? -1.f : 1.f;
    const cf w1 = upper ? w : cf{1.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = cmul(v[j], w1);
      const cf p = {__shfl_xor_sync(0xffffffffu, v[j].r, h),
                    __shfl_xor_sync(0xffffffffu, v[j].i, h)};
      v[j] = {fmaf(sign, v[j].r, p.r), fmaf(sign, v[j].i, p.i)};
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
  stage_strip(buf, plane, sr, si, sr, si, N, n1, n2, c0, C, tid, nt);
  for (int i = tid; i < n1; i += nt) {
    wr[i] = pl.r1r[i];
    wi[i] = pl.r1i[i];
  }
  cp_async_wait_all();
  __syncthreads();
  const float* x = column_fft<true>(buf, buf + 2 * plane, plane,
                                    block_lanes(), pl, wr, wi);
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

// The cluster route of #5 and #6: one launch, one thread block cluster of
// C = min(8, n2) blocks per stream pair, every grid of the pair in the
// cluster's shared memory from the input load to the output store.
// Block r of the cluster owns the strip of W = n2 / C columns c0 = r * W
// .. c0 + W - 1 of each grid: its column FFTs run locally; the row phase
// reads and writes the rows through distributed shared memory.

constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 8;     // #5, #6: the portable cluster size
constexpr int kFilterCluster = 4;  // #3: blocks of a stream's cluster
// Blocks an SM may hold at once: registers capped at 80 a thread, so that
// the receive chain's 64 streams fit the card in one wave: 32 clusters of
// 8 (#5, #6; 30 at two blocks an SM) or 64 of 4 (#3; 62 at two).
constexpr int kClusterMinBlocks = 3;
constexpr int kBatch = 4;       // elements a thread loads before it computes

// Blocks of the cluster at row length n2, at most `most` (ops/filter.py
// cluster_size, filter_cluster_size).
__host__ __device__ constexpr int cluster_blocks(int n2,
                                                 int most = kMaxCluster) {
  return n2 < most ? n2 : most;
}

// Shared bytes of a cluster block (all of them dynamic): the strip's two
// buffers (re and im planes of n1 x W, one grid for #5, the stream pair's
// two for #6) and the n1 column and n2 row roots.
size_t cluster_bytes(int n1, int n2, bool merged) {
  const size_t W = n2 / cluster_blocks(n2);
  return sizeof(float) *
         ((merged ? 8 : 4) * (size_t)n1 * W + 2 * (size_t)n1 + 2 * (size_t)n2);
}

// Shared bytes of a block of #3's cluster: two strip buffers of re and im
// planes of n1 x W at W = n2 / min(4, n2), and the n1 column and n2 row
// roots.
size_t filter_cluster_bytes(int n1, int n2) {
  const size_t W = n2 / cluster_blocks(n2, kFilterCluster);
  return sizeof(float) *
         (4 * (size_t)n1 * W + 2 * (size_t)n1 + 2 * (size_t)n2);
}

struct ClusterArgs {
  const float *prevr, *previ;  // #6: channel filter history [b, m]
  const float *curr, *curi;    // [b, n]: #5 the pre-demod chunk, #6 the raw
  const float *plr, *pli;      // [b] carried last (filtered) sample
  const float *prevd;          // [b, m] demodulated history
  const float *last_out, *have_prev;  // [b]
  const float* fac;            // [b] at fac_stride 1, or one at 0
  const float *g1r, *g1i;      // #6: channel response grid [n1, n2]
  const float *g2r, *g2i;      // the real filter's response grid
  float *dout, *y;             // [b, n]
  float *flr, *fli;            // #6: [b] last filtered sample
  long long* clk;              // development build: phase stamps, or null
  int n, m, ho, fac_stride;
  Plan pl;
};

// A development build (-DRR_OS_CLOCKS, tools/filter_split.py --clocks)
// stamps clock64() at each phase of each block into clk, kMarks a block.
// Marks 16 and 17: %globaltimer (ns, one clock for all SMs) at the
// block's start and end; 18: the SM it ran on.
constexpr int kMarks = 19;
#ifdef RR_OS_CLOCKS
#define OS_STAMP(clk, k, v)                                          \
  do {                                                               \
    if ((clk) != nullptr && threadIdx.x == 0)                        \
      (clk)[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kMarks + \
            (k)] = (v);                                              \
  } while (0)
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}
#define OS_MARK(clk, k) OS_STAMP(clk, k, clock64())
#define OS_TIME(clk, k) OS_STAMP(clk, k, global_ns())
#else
#define OS_MARK(clk, k) \
  do {                  \
  } while (0)
#define OS_TIME(clk, k) OS_MARK(clk, k)
#endif

// Quadrature FM demod of sample i from x and its predecessor p (as
// demod_pack): atan2(Im, Re of x * conj(p)) * fac, or the carried last
// output at i = 0 after a break.
__device__ __forceinline__ float fm_sample(cf x, cf p, int i, float fac,
                                           float have, float last) {
  const float re = x.r * p.r + x.i * p.i;
  const float im = x.i * p.r - x.r * p.i;
  const float v = atan2f(im, re) * fac;
  return i == 0 && have < 0.5f ? last : v;
}

// One overlap-save filter of the grids in the cluster's strips: block r of
// the cluster of C blocks owns the strip of W = n2 / C columns r W .. r W
// + W - 1 of each of its kStreams grids, side by side in x (stream s at
// column s * W of rows of kStreams * W), and y is a second such buffer.
// The forward column FFTs run locally; after a cluster barrier each warp
// takes whole rows (stream, k1) across the cluster, LR lanes a row as
// os_rows, reads lane l's values i2 = l + LR j from the block owning
// column i2 through distributed shared memory with the twiddle, runs the
// row FFT, the response, the inverse row FFT and the conjugate twiddle,
// and writes them back in place; after a second barrier the inverse
// column FFTs run locally.  Returns the buffer (x or y) holding the
// result.  Past the second barrier no block reads another's shared memory.
template <int V, int LR, int C, int kStreams>
__device__ float* cluster_filter(cg::cluster_group& cluster, float* x,
                                 float* y, const Plan& pl,
                                 const float* __restrict__ gr,
                                 const float* __restrict__ gi,
                                 const float* cwr, const float* cwi,
                                 const float* rwr, const float* rwi,
                                 long long* clk, int mark) {
  constexpr int n2 = V * LR, kLog = LR == 32 ? 5 : LR == 16 ? 4 : LR == 8
      ? 3 : LR == 4 ? 2 : LR == 2 ? 1 : 0;
  constexpr int W = n2 / C, cols = kStreams * W;
  constexpr int kWarps = kClusterThreads / 32, kRowsWarp = 32 / LR;
  const int n1 = pl.n1, plane = n1 * cols;
  const Lanes ln = {cols, (int)threadIdx.x % cols, (int)threadIdx.x / cols,
                    kClusterThreads / cols};
  float* f = column_fft<false>(x, y, plane, ln, pl, cwr, cwi);
  OS_MARK(clk, mark);
  cluster.sync();
  OS_MARK(clk, mark + 1);
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane % LR;
  const int k2 = kLog ? V * (int)(__brev(l) >> (32 - kLog)) : 0;
  float* at[V];  // lane l's values: column i2 of the grid in its owner
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i2 = l + LR * j;
    at[j] = (i2 / W == rank ? f : cluster.map_shared_rank(f, i2 / W)) +
            i2 % W;
  }
  const int rows = kStreams * n1;
  for (int first = (rank * kWarps + warp) * kRowsWarp; first < rows;
       first += C * kWarps * kRowsWarp) {
    const int row = first + lane / LR;
    const bool live = row < rows;
    const int k1 = live ? row % n1 : 0;
    const int off = k1 * cols + (live ? row / n1 : 0) * W;
    cf v[V], tw[V], g[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int t = k1 * n2 + l + LR * j;
      tw[j] = {__ldg(pl.twr + t), __ldg(pl.twi + t)};
      g[j] = {__ldg(gr + k1 * n2 + k2 + j), __ldg(gi + k1 * n2 + k2 + j)};
      v[j] = live ? cf{at[j][off], at[j][plane + off]} : cf{0.f, 0.f};
    }
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = live ? cmul(v[j], tw[j]) : v[j];
    row_fft<V, LR>(v, l, rwr, rwi);
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = live ? cmul(v[j], g[j]) : cf{0.f, 0.f};
    row_ifft<V, LR>(v, l, rwr, rwi);
    if (live) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const cf z = cmul(v[j], {tw[j].r, -tw[j].i});
        at[j][off] = z.r;
        at[j][plane + off] = z.i;
      }
    }
  }
  OS_MARK(clk, mark + 2);
  cluster.sync();
  OS_MARK(clk, mark + 3);
  float* r = column_fft<true>(f, f == x ? y : x, plane, ln, pl, cwr, cwi);
  OS_MARK(clk, mark + 4);
  return r;
}

// #5 (kMerged false) or #6 (kMerged true) on stream pair blockIdx.y:
// streams 2j and 2j + 1, packed as the real and imaginary part of the
// real filter's transform.  Each thread loads kBatch elements before it
// computes on them, so their loads are in flight together.
// grid (C, b / 2), cluster (C, 1, 1), block kClusterThreads, shared
// cluster_bytes(n1, n2, kMerged).
template <int V, int LR, bool kMerged>
__global__ void __launch_bounds__(kClusterThreads, kClusterMinBlocks)
    os_cluster(const ClusterArgs a) {
  constexpr int n2 = V * LR, C = cluster_blocks(n2), W = n2 / C;
  constexpr int kRowsPass = kClusterThreads / W;  // strip rows a pass
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  long long* const clk = a.clk;
  OS_TIME(clk, 16);
  OS_MARK(clk, 0);
  const Plan& pl = a.pl;
  const int n1 = pl.n1, n = a.n, m = a.m;
  const int c0 = (int)cluster.block_rank() * W;
  const int pair = blockIdx.y, tid = threadIdx.x;
  const int plane = n1 * W;  // a plane of one grid's strip
  float* cwr = buf + (kMerged ? 8 : 4) * plane;
  float* cwi = cwr + n1;
  float* rwr = cwi + n1;
  float* rwi = rwr + n2;
  for (int i = tid; i < n1; i += kClusterThreads) {
    cwr[i] = pl.r1r[i];
    cwi[i] = pl.r1i[i];
  }
  for (int i = tid; i < n2; i += kClusterThreads) {
    rwr[i] = pl.r2r[i];
    rwi[i] = pl.r2i[i];
  }
  OS_MARK(clk, 15);
  const int s0 = 2 * pair, s1 = s0 + 1;
  const float fac0 = a.fac[s0 * a.fac_stride];
  const float fac1 = a.fac[s1 * a.fac_stride];
  const float have0 = a.have_prev[s0], have1 = a.have_prev[s1];
  const float last0 = a.last_out[s0], last1 = a.last_out[s1];
  const cf carried0 = {a.plr[s0], a.pli[s0]};
  const cf carried1 = {a.plr[s1], a.pli[s1]};
  // The real filter's input, [prevd || demod] of s0 in the real and of s1
  // in the imaginary plane, lands in x (re, im of n1 x W), y beside it.
  float* x = buf;
  const int c = tid % W;
  if constexpr (kMerged) {
    // The channel filter on both streams' complex [prev || cur]: stream
    // s's strip at columns s * W .. of rows of 2W, in planes of 2 * plane,
    // by 16-byte cp.async copies where a strip row has four columns or
    // more (stage4: four loads across the prev || cur seam).
    if constexpr (W >= 4) {
      constexpr int kQuads = W / 4;
      for (int q = tid; q < n1 * 2 * kQuads; q += kClusterThreads) {
        const int i1 = q / (2 * kQuads), s = (q / kQuads) % 2;
        const int cc = 4 * (q % kQuads), t = i1 * n2 + c0 + cc;
        const size_t st = (size_t)(s0 + s);
        float* d = buf + i1 * 2 * W + s * W + cc;
        stage4(d, a.prevr + st * m, a.curr + st * n, t, m);
        stage4(d + 2 * plane, a.previ + st * m, a.curi + st * n, t, m);
      }
      cp_async_wait_all();
    } else {
      for (int e = tid; e < 2 * plane; e += kClusterThreads) {
        const int i1 = e / (2 * W), s = (e / W) % 2;
        const int t = i1 * n2 + c0 + e % W;
        const size_t st = (size_t)(s0 + s);
        buf[e] = t < m ? a.prevr[st * m + t] : a.curr[st * n + t - m];
        buf[2 * plane + e] =
            t < m ? a.previ[st * m + t] : a.curi[st * n + t - m];
      }
    }
    __syncthreads();
    OS_MARK(clk, 1);
    float* f = cluster_filter<V, LR, C, 2>(cluster, buf, buf + 4 * plane,
                                           pl, a.g1r, a.g1i, cwr, cwi, rwr,
                                           rwi, clk, 2);
    cluster.sync();  // every block's filtered strips are whole
    OS_MARK(clk, 7);
    // Filtered sample i of stream s sits at row i / n2, column i % n2 of
    // its grid, in the block owning that column.
    const int rank = (int)cluster.block_rank();
    auto filtered = [&](int s, int i) -> cf {
      const int col = i % n2, owner = col / W;
      const float* o =
          owner == rank ? f : cluster.map_shared_rank(f, owner);
      const int at = (i / n2) * 2 * W + s * W + col % W;
      return {o[at], o[2 * plane + at]};
    };
    x = f == buf ? buf + 4 * plane : buf;  // the free buffer, two grids
    for (int i0 = tid / W; i0 < n1; i0 += kBatch * kRowsPass) {
      cf x0[kBatch], x1[kBatch], p0[kBatch], p1[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = (i0 + u * kRowsPass) * n2 + c0 + c;
        if (i0 + u * kRowsPass < n1 && t >= m) {
          const int i = t - m;
          x0[u] = filtered(0, i);
          x1[u] = filtered(1, i);
          p0[u] = i ? filtered(0, i - 1) : carried0;
          p1[u] = i ? filtered(1, i - 1) : carried1;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i1 = i0 + u * kRowsPass, t = i1 * n2 + c0 + c;
        if (i1 >= n1) break;
        float v0, v1;
        if (t < m) {
          v0 = __ldg(a.prevd + (size_t)s0 * m + t);
          v1 = __ldg(a.prevd + (size_t)s1 * m + t);
        } else {
          const int i = t - m;
          v0 = fm_sample(x0[u], p0[u], i, fac0, have0, last0);
          v1 = fm_sample(x1[u], p1[u], i, fac1, have1, last1);
          a.dout[(size_t)s0 * n + i] = v0;
          a.dout[(size_t)s1 * n + i] = v1;
          if (i == n - 1) {
            a.flr[s0] = x0[u].r;
            a.fli[s0] = x0[u].i;
            a.flr[s1] = x1[u].r;
            a.fli[s1] = x1[u].i;
          }
        }
        x[i1 * W + c] = v0;
        x[plane + i1 * W + c] = v1;
      }
    }
  } else {
    for (int i0 = tid / W; i0 < n1; i0 += kBatch * kRowsPass) {
      cf x0[kBatch], x1[kBatch], p0[kBatch], p1[kBatch];
      float h0[kBatch], h1[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = (i0 + u * kRowsPass) * n2 + c0 + c;
        if (i0 + u * kRowsPass >= n1) break;
        if (t < m) {
          h0[u] = __ldg(a.prevd + (size_t)s0 * m + t);
          h1[u] = __ldg(a.prevd + (size_t)s1 * m + t);
        } else {
          const int i = t - m;
          const size_t r0 = (size_t)s0 * n + i, r1 = (size_t)s1 * n + i;
          x0[u] = {__ldg(a.curr + r0), __ldg(a.curi + r0)};
          x1[u] = {__ldg(a.curr + r1), __ldg(a.curi + r1)};
          p0[u] = i ? cf{__ldg(a.curr + r0 - 1), __ldg(a.curi + r0 - 1)}
                    : carried0;
          p1[u] = i ? cf{__ldg(a.curr + r1 - 1), __ldg(a.curi + r1 - 1)}
                    : carried1;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i1 = i0 + u * kRowsPass, t = i1 * n2 + c0 + c;
        if (i1 >= n1) break;
        float v0, v1;
        if (t < m) {
          v0 = h0[u];
          v1 = h1[u];
        } else {
          const int i = t - m;
          v0 = fm_sample(x0[u], p0[u], i, fac0, have0, last0);
          v1 = fm_sample(x1[u], p1[u], i, fac1, have1, last1);
          a.dout[(size_t)s0 * n + i] = v0;
          a.dout[(size_t)s1 * n + i] = v1;
        }
        x[i1 * W + c] = v0;
        x[plane + i1 * W + c] = v1;
      }
    }
  }
  __syncthreads();
  OS_MARK(clk, 8);
  const float* r = cluster_filter<V, LR, C, 1>(cluster, x, x + 2 * plane,
                                               pl, a.g2r, a.g2i, cwr, cwi, rwr,
                                               rwi, clk, 9);
  // Output rows i1 < ho where t < n: s0 from the real, s1 from the
  // imaginary plane.
  for (int i1 = tid / W; i1 < a.ho; i1 += kRowsPass) {
    const int t = i1 * n2 + c0 + c;
    if (t < n) {
      a.y[(size_t)s0 * n + t] = r[i1 * W + c];
      a.y[(size_t)s1 * n + t] = r[plane + i1 * W + c];
    }
  }
  OS_MARK(clk, 14);
  OS_TIME(clk, 17);
#ifdef RR_OS_CLOCKS
  OS_STAMP(clk, 18, sm_id());
#endif
}

// #3 by the cluster route.
struct FilterArgs {
  const float *prevr, *previ;  // [X, m] at prev_stride
  const float *curr, *curi;    // [X, n] at cur_stride
  const float *gr, *gi;        // response grid [n1, n2]
  float *outr, *outi;          // [X, n] at out_stride
  long long* clk;              // development build: phase stamps, or null
  int prev_stride, cur_stride, out_stride, m, n, ho;
  Plan pl;
};

// Output rows i1 < ho of a strip r (n1 x W planes at column c0) where t =
// i1 n2 + c0 + c < n, to yr / yi.
__device__ __forceinline__ void store_strip(const float* r, int plane,
                                            float* yr, float* yi, int n,
                                            int ho, int n2, int c0, int W) {
  const int c = threadIdx.x % W;
  for (int i1 = threadIdx.x / W; i1 < ho; i1 += kClusterThreads / W) {
    const int t = i1 * n2 + c0 + c;
    if (t < n) {
      yr[t] = r[i1 * W + c];
      yi[t] = r[plane + i1 * W + c];
    }
  }
}

// #3 on stream blockIdx.y: one cluster of C = min(4, n2) blocks a stream,
// block r owning the strip of W = n2 / C columns r W .. r W + W - 1 of the
// stream's [prev || cur] grid, staged by 16-byte cp.async copies
// (stage_strip); cluster_filter, then the output rows.
// grid (C, X), cluster (C, 1, 1), block kClusterThreads, shared
// filter_cluster_bytes(n1, n2).
template <int V, int LR>
__global__ void __launch_bounds__(kClusterThreads, kClusterMinBlocks)
    os_filter_cluster(const FilterArgs a) {
  constexpr int n2 = V * LR, C = cluster_blocks(n2, kFilterCluster);
  constexpr int W = n2 / C;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  long long* const clk = a.clk;
  OS_TIME(clk, 16);
  OS_MARK(clk, 0);
  const Plan& pl = a.pl;
  const int n1 = pl.n1, plane = n1 * W, tid = threadIdx.x;
  const int c0 = (int)cluster.block_rank() * W, s = blockIdx.y;
  float* cwr = buf + 4 * plane;
  float* cwi = cwr + n1;
  float* rwr = cwi + n1;
  float* rwi = rwr + n2;
  stage_strip(buf, plane, a.prevr + (size_t)s * a.prev_stride,
              a.previ + (size_t)s * a.prev_stride,
              a.curr + (size_t)s * a.cur_stride,
              a.curi + (size_t)s * a.cur_stride, a.m, n1, n2, c0, W, tid,
              kClusterThreads);
  for (int i = tid; i < n1; i += kClusterThreads) {
    cwr[i] = pl.r1r[i];
    cwi[i] = pl.r1i[i];
  }
  for (int i = tid; i < n2; i += kClusterThreads) {
    rwr[i] = pl.r2r[i];
    rwi[i] = pl.r2i[i];
  }
  OS_MARK(clk, 15);
  cp_async_wait_all();
  __syncthreads();
  OS_MARK(clk, 1);
  const float* r = cluster_filter<V, LR, C, 1>(
      cluster, buf, buf + 2 * plane, pl, a.gr, a.gi, cwr, cwi, rwr, rwi, clk,
      2);
  const size_t o = (size_t)s * a.out_stride;
  store_strip(r, plane, a.outr + o, a.outi + o, a.n, a.ho, n2, c0, W);
  OS_MARK(clk, 14);
  OS_TIME(clk, 17);
#ifdef RR_OS_CLOCKS
  OS_STAMP(clk, 18, sm_id());
#endif
}

// The cluster's occupancy query, once per kernel and shared size (the
// first call of a geometry runs eagerly, before any graph captures it).
std::mutex occupancy_mu;
std::map<std::pair<const void*, size_t>, int> occupancy_seen;

// One cluster launch of `kernel`: grid (C, rows), cluster (C, 1, 1),
// kClusterThreads threads and `bytes` of dynamic shared memory a block.
// With `clusters` given, only the occupancy query: the clusters of this
// geometry the card holds at once.  A geometry the card holds no cluster
// of returns an error.
template <typename Args>
int launch_clusters(void (*kernel)(Args), const Args& a, int C, size_t bytes,
                    int rows, cudaStream_t stream, int* clusters) {
  const void* fn = (const void*)kernel;
  int err = set_smem(fn, bytes);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, rows, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  {
    std::lock_guard<std::mutex> hold(occupancy_mu);
    int& seen = occupancy_seen[{fn, bytes}];
    if (seen == 0) {
      if ((err = (int)cudaOccupancyMaxActiveClusters(&seen, fn, &cfg)))
        return err;
      if (seen == 0) return (int)cudaErrorInvalidConfiguration;
    }
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int V, int LR, bool kMerged>
int launch_cluster(const ClusterArgs& a, int pairs, cudaStream_t stream,
                   int* clusters) {
  return launch_clusters(os_cluster<V, LR, kMerged>, a,
                         cluster_blocks(V * LR),
                         cluster_bytes(a.pl.n1, V * LR, kMerged), pairs,
                         stream, clusters);
}

template <int V, int LR>
int launch_filter_cluster(const FilterArgs& a, int X, cudaStream_t stream,
                          int* clusters) {
  return launch_clusters(os_filter_cluster<V, LR>, a,
                         cluster_blocks(V * LR, kFilterCluster),
                         filter_cluster_bytes(a.pl.n1, V * LR), X, stream,
                         clusters);
}

#ifdef RR_OS_CLOCKS
long long* clock_out = nullptr;  // where the next launches stamp (or null)
#endif

// The cluster route of #5 / #6 at the plan's row length; an error where
// the geometry is not one it takes (ops/filter.py cluster_size 0).
template <bool kMerged>
int run_cluster(ClusterArgs a, int pairs, cudaStream_t st,
                int* clusters = nullptr) {
#ifdef RR_OS_CLOCKS
  a.clk = clock_out;
#endif
  const Plan& pl = a.pl;
  if (pl.n2 > kMaxN2 || cluster_bytes(pl.n1, pl.n2, kMerged) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  switch (pl.n2) {
    case 1: return launch_cluster<1, 1, kMerged>(a, pairs, st, clusters);
    case 2: return launch_cluster<1, 2, kMerged>(a, pairs, st, clusters);
    case 4: return launch_cluster<1, 4, kMerged>(a, pairs, st, clusters);
    case 8: return launch_cluster<1, 8, kMerged>(a, pairs, st, clusters);
    case 16: return launch_cluster<1, 16, kMerged>(a, pairs, st, clusters);
    case 32: return launch_cluster<1, 32, kMerged>(a, pairs, st, clusters);
    case 64: return launch_cluster<2, 32, kMerged>(a, pairs, st, clusters);
    case 128: return launch_cluster<4, 32, kMerged>(a, pairs, st, clusters);
    case 256: return launch_cluster<8, 32, kMerged>(a, pairs, st, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The cluster route of #3 at the plan's row length; an error where a
// block's share does not fit (ops/filter.py filter_cluster_size takes it
// only up to n1 = 96, well within).
int run_filter_cluster(FilterArgs a, int X, cudaStream_t st,
                       int* clusters = nullptr) {
#ifdef RR_OS_CLOCKS
  a.clk = clock_out;
#endif
  const Plan& pl = a.pl;
  if (pl.n2 > kMaxN2 || filter_cluster_bytes(pl.n1, pl.n2) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  switch (pl.n2) {
    case 1: return launch_filter_cluster<1, 1>(a, X, st, clusters);
    case 2: return launch_filter_cluster<1, 2>(a, X, st, clusters);
    case 4: return launch_filter_cluster<1, 4>(a, X, st, clusters);
    case 8: return launch_filter_cluster<1, 8>(a, X, st, clusters);
    case 16: return launch_filter_cluster<1, 16>(a, X, st, clusters);
    case 32: return launch_filter_cluster<1, 32>(a, X, st, clusters);
    case 64: return launch_filter_cluster<2, 32>(a, X, st, clusters);
    case 128: return launch_filter_cluster<4, 32>(a, X, st, clusters);
    case 256: return launch_filter_cluster<8, 32>(a, X, st, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
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

// #3 by the cluster route: the arguments of rr_overlap_save without its
// scratch (no scr_r/scr_i or column scratch).
int rr_overlap_save_cluster(const float* prevr, const float* previ,
                            int prev_stride, const float* curr,
                            const float* curi, int cur_stride, int m, int n,
                            int X, const float* tables, const int* radix,
                            int npass, int n2, const float* gr,
                            const float* gi, float* outr, float* outi,
                            int out_stride, int n1, int ho, void* stream) {
  FilterArgs a = {};
  a.prevr = prevr;
  a.previ = previ;
  a.curr = curr;
  a.curi = curi;
  a.gr = gr;
  a.gi = gi;
  a.outr = outr;
  a.outi = outi;
  a.prev_stride = prev_stride;
  a.cur_stride = cur_stride;
  a.out_stride = out_stride;
  a.m = m;
  a.n = n;
  a.ho = ho;
  a.pl = make_plan(tables, radix, npass, n2, n1);
  return run_filter_cluster(a, X, (cudaStream_t)stream);
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

// #5 by the cluster route: the arguments of rr_demod_filter without its
// scratch (no zr/zi, scr_r/scr_i or column scratch).
int rr_demod_filter_cluster(const float* curr, const float* curi,
                            const float* plr, const float* pli,
                            const float* prevd, const float* last_out,
                            const float* have_prev, const float* fac,
                            int fac_stride, float* dout, int b, int n, int m,
                            const float* tables, const int* radix, int npass,
                            int n2, const float* gr, const float* gi,
                            float* y, int n1, int ho, void* stream) {
  ClusterArgs a = {};
  a.curr = curr;
  a.curi = curi;
  a.plr = plr;
  a.pli = pli;
  a.prevd = prevd;
  a.last_out = last_out;
  a.have_prev = have_prev;
  a.fac = fac;
  a.fac_stride = fac_stride;
  a.g2r = gr;
  a.g2i = gi;
  a.dout = dout;
  a.y = y;
  a.n = n;
  a.m = m;
  a.ho = ho;
  a.pl = make_plan(tables, radix, npass, n2, n1);
  return run_cluster<false>(a, b / 2, (cudaStream_t)stream);
}

// #6 by the cluster route: the arguments of rr_filter_demod_filter
// without its scratch (no fr/fi, zr/zi, scr_r/scr_i or column scratch).
int rr_filter_demod_filter_cluster(
    const float* prevr, const float* previ, const float* curr,
    const float* curi, const float* plr, const float* pli,
    const float* prevd, const float* last_out, const float* have_prev,
    const float* fac, int fac_stride, float* dout, float* flr, float* fli,
    int b, int n, int m, const float* tables, const int* radix, int npass, int n2,
    const float* g1r, const float* g1i, const float* g2r, const float* g2i,
    float* y, int n1, int ho, void* stream) {
  ClusterArgs a = {};
  a.prevr = prevr;
  a.previ = previ;
  a.curr = curr;
  a.curi = curi;
  a.plr = plr;
  a.pli = pli;
  a.prevd = prevd;
  a.last_out = last_out;
  a.have_prev = have_prev;
  a.fac = fac;
  a.fac_stride = fac_stride;
  a.g1r = g1r;
  a.g1i = g1i;
  a.g2r = g2r;
  a.g2i = g2i;
  a.dout = dout;
  a.y = y;
  a.flr = flr;
  a.fli = fli;
  a.n = n;
  a.m = m;
  a.ho = ho;
  a.pl = make_plan(tables, radix, npass, n2, n1);
  return run_cluster<true>(a, b / 2, (cudaStream_t)stream);
}

// The clusters of a cluster route at (n1, n2) that the card holds at
// once (cudaOccupancyMaxActiveClusters), or a negative CUDA error; kind 0
// is #5's route, 1 #6's and 2 #3's.
int rr_cluster_occupancy(int n1, int n2, int kind) {
  ClusterArgs a = {};
  a.pl.n1 = n1;
  a.pl.n2 = n2;
  FilterArgs f = {};
  f.pl = a.pl;
  int clusters = 0, err;
  switch (kind) {
    case 0: err = run_cluster<false>(a, 1, nullptr, &clusters); break;
    case 1: err = run_cluster<true>(a, 1, nullptr, &clusters); break;
    case 2: err = run_filter_cluster(f, 1, nullptr, &clusters); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  return err ? -err : clusters;
}

#ifdef RR_OS_CLOCKS
// Development build only: the cluster routes' launches from now on stamp
// clock64() at their phases into clk (int64, kMarks a block, block
// blockIdx.y * C + blockIdx.x); null stops it.
int rr_cluster_clocks(long long* clk) {
  clock_out = clk;
  return 0;
}
#endif

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
