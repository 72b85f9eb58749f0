// #2's wide form: the mixer, then p:q FIR decimation, at the plans past
// one block of the polyphase kernel (rr_mix_decimate_wide).
//
// Replaces fused_mix_decimate (radiorust_tpu/ops/pallas_frontend.py:241,
// body _make_kernel :42) at the plans rr_mix_decimate (decimate.cu) does
// not take (ops/frontend.py fits_block): 2.048 MHz -> 240 kHz (p = 128,
// q = 15, Kw = 435), -> 12 kHz (p = 512, q = 3, Kw = 6655, a history of
// 6143 samples), 1.024 MHz -> 200 kHz (p = 128, q = 25), 48 kHz -> 44.1
// kHz (p = 160, q = 147, Kw = 171).  The TPU kernel computes them as one
// banded matrix product on the MXU after the mix.
//
// What it computes, per stream s, over buf = [hist || mix(x)] (hist =
// Kw - p), on two planes (re, im) sharing the taps:
//   y[s, m q + r] = sum_u W[r, u] buf[s, m p + u]
//   new_hist[s]   = buf[s, n : n + hist)
//   mix(x)[k]     = x[k] * (A[k / inner] * B[k mod inner]) * p0[s],
// every product and sum rounded on its own (decimate.cuh mix), so the
// mixed history equals the plain version's bit for bit.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  At batch 64 2.048 MHz
// -> 240 kHz moves 9.7 MB (2.9 us), -> 12 kHz 14.8 MB (4.4 us); the
// useful float32 work, 2 L q operations a window and plane, is half of
// that time or less.  Each window is a dot product of L of Kw taps with
// samples its neighbours share, and each chunk sample is mixed at 18
// rounded operations, so the kernel must not feed its multiplies from
// one shared-memory load apiece, nor mix or stage a sample twice.
//
// What the design does about it:
//   - One span a tile, one period a row.  A block takes tm windows of one
//     stream and stages buf[P0 + e], e < (tm - 1) p + width (P0 = m0 p +
//     ulo: the plan's joint band starts at tap ulo and is width taps
//     long), as rows of p (re, im) pairs at a pitch of `pitch` pairs:
//     position e at row e / p, column e mod p.  Each sample lands once, by
//     cp.async in one flat loop over the block's threads: a complex64 row
//     16 bytes a copy at the source's 16-byte phase (the span shifted by
//     one pair to meet it), 8 bytes elsewhere; float planes 4 bytes.
//   - The tables' entries the tile reads (B whole, A over the span) come
//     into shared memory with the copies.  After the wait each staged
//     chunk sample is mixed once, in place: lane l of a warp takes the
//     samples j0 + l + 32 i, i < 8 (4 on the FMA route), with one
//     multiply-shift division for the run, so a warp's loads and stores
//     fall in distinct banks.
//   - The new history from the span where the stream's last tile staged
//     it (all of it at every plan the paths bind, and the whole of a
//     chunk shorter than the history); the rest, if any, from the sources.
//   - The sums take one of two routes, a rule of the plan
//     (ops/frontend.py mix_wide_route):
//     tensor cores, where the bands are dense enough: the polyphase
//     product Z[k, a q + r] = sum_c S[k, c] W[r, ulo + a p + c] with
//     S[k, c] the span's row k, then y[m, r] = sum_a Z[m + a, a q + r].
//     Z runs on mma.sync m16n8k8 in TF32 with a 3xTF32 split: v = hi +
//     lo, hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi), and lo hi +
//     hi lo + hi hi summed in float32 (single-pass TF32 keeps 10 bits, as
//     the bf16 pass the budget rules out).  The two planes are two row
//     sets sharing each B fragment.  The taps come re-laid once per taps
//     tensor in B-fragment order ([p / 8][nt][32 lanes][2], read by one
//     8-byte load a lane, staged in shared memory with the span; split
//     in registers).  pitch = 4 mod 16 pairs, so a warp's 8-byte
//     A-fragment loads fall in distinct banks.  Warps split m-tiles x
//     k-ranges; their partial Z meet in shared memory in k order
//     (deterministic), and the diagonal sum over a is the epilogue.
//     FMA, where the bands are sparse (48 kHz -> 44.1 kHz: 12 taps of 171
//     a row over 147 phases; a dense product would be ~4% useful): one
//     output a thread or lane group over its band, the bands in shared
//     memory, as #1's wide form (decimate.cuh BandSums, which
//     decimate.cu decimate_wide_kernel runs too).
//
// A development build (-DRR_DECIM_CLOCKS, rr_mix_wide_clocks) stamps each
// block's phases (kMixMarks a block): clock64() at its start, after the
// copies and tables are issued, after the history from the sources, once
// the copies land, after the mix, after the history from the span, after
// the sums (the product), after the shuffles or the reduction of the
// partial Z, after the diagonal sums and stores; %globaltimer at its
// start and end; its SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decimate.cuh"

// The launch's shape (ops/frontend.py mix_wide_config, _MixWideArgs).
struct MixWideArgs {
  const float* taps;   // mma: B fragments [p / 8][nt][32][2]; fma: bands
                       // [U][ls] as decimate.cu WideArgs
  const int* rows;     // fma: [q][3], row r's (lo_r, L_r, band)
  const int* zband;    // [ceil(q / nr)][4]: (ulo, width, u0, un)
  int mma;             // 1: tensor cores; 0: FMA
  int tm;              // windows a tile
  int pitch;           // span row pitch, pairs (FMA: p, one run)
  int xlen;            // positions a span holds: (tm - 1) p + widest band
  int srows;           // mma: rows of the span (16 mt)
  int tab_a;           // entries of table A a block stages
  int threads;
  int mt, ksplit, nt, periods, zpitch;   // mma
  int ls, g, nr, un, ws, nw;             // fma
};

namespace {

constexpr int kMixMarks = 12;   // clock stamps a block (development)
// Chunk samples a lane mixes at once: 8 on the tensor-core route (long
// spans), 4 on the FMA route (a few hundred samples a block).
template <int NT>
constexpr int kMixRun = NT > 0 ? 8 : 4;

#ifdef RR_DECIM_CLOCKS
#define MW_STAMP(clk, k, v)                                               \
  do {                                                                    \
    if ((clk) != nullptr && threadIdx.x == 0)                             \
      (clk)[(((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \
             blockIdx.x) * kMixMarks + (k)] = (v);                        \
  } while (0)
__device__ __forceinline__ long long mw_global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long mw_sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}
#define MW_MARK(clk, k) MW_STAMP(clk, k, clock64())
#define MW_TIME(clk, k) MW_STAMP(clk, k, mw_global_ns())
#define MW_SM(clk, k) MW_STAMP(clk, k, mw_sm_id())
long long* mix_clocks = nullptr;
#else
#define MW_MARK(clk, k) \
  do {                  \
  } while (0)
#define MW_TIME(clk, k) MW_MARK(clk, k)
#define MW_SM(clk, k) MW_MARK(clk, k)
long long* const mix_clocks = nullptr;
#endif

__host__ __device__ __forceinline__ int round4(int floats) {
  return (floats + 3) & ~3;
}

// Floats of each region of the shared memory, in order: the span (and,
// over it once the sums are done, the k-ranges' partial Z), then the
// taps (mma: B's fragments, p / 8 x nt x 64 floats; FMA: the bands),
// table B, table A.  ops/frontend.py _mix_wide_smem mirrors it.
struct Regions {
  int span, taps, tab_b, tab_a;
  __host__ __device__ Regions(const MixWideArgs& w, int p, int inner) {
    const int pairs = w.mma ? w.srows * w.pitch : w.xlen;
    const int z = w.mma ? w.ksplit * 2 * w.srows * w.zpitch : 0;
    span = round4(2 * (pairs + 1) > z ? 2 * (pairs + 1) : z);
    taps = w.mma ? p / 8 * w.nt * 64 : wide_tap_floats(w.un, w.ls);
    tab_b = round4(2 * inner);
    tab_a = round4(2 * w.tab_a);
  }
  __host__ __device__ int total() const {
    return span + taps + tab_b + tab_a;
  }
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo in TF32, each rounded to nearest (ties away).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product into float32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Span position e of a tile: pair e / p * pitch + e mod p (past the
// shift).
__device__ __forceinline__ int at_span(int e, int p, int pitch, uint64_t mp) {
  const int k = divm(e, mp);
  return k * pitch + e - k * p;
}

// Span positions [e0, e1) from the source row src, element s0 + e for
// position e, by cp.async: 16 bytes a pair of positions where the span
// and a complex64 source share their 16-byte phase (a pair across a
// row's end as two 8-byte copies), else 8 bytes a position, or 4 bytes a
// float of float planes.  The parity of a position's pair in the span
// and in the source differ by a constant (pitch and p even, or pitch ==
// p).
__device__ __forceinline__ void copy_span(float2* X, int e0, int e1,
                                          const Row& src, int64_t s0, int p,
                                          int pitch, uint64_t mp, int tid,
                                          int nt) {
  if (e0 >= e1) return;
  if (!src.pairs) {
    for (int e = e0 + tid; e < e1; e += nt) {
      float* d = reinterpret_cast<float*>(X + at_span(e, p, pitch, mp));
      cp_async4(d, src.p0 + (s0 + e) * src.step);
      cp_async4(d + 1, src.p1 + (s0 + e) * src.step);
    }
    return;
  }
  const float2* sp = reinterpret_cast<const float2*>(src.p0) + s0;
  const unsigned dodd =
      (unsigned)(__cvta_generic_to_shared(X + at_span(e0, p, pitch, mp)) >>
                 3) & 1;
  const unsigned sodd = (unsigned)(((uintptr_t)(sp + e0)) >> 3) & 1;
  if (dodd != sodd) {
    for (int e = e0 + tid; e < e1; e += nt)
      cp_async8(X + at_span(e, p, pitch, mp), sp + e);
    return;
  }
  const int head = (int)min((unsigned)(e1 - e0), sodd);
  const int ea = e0 + head, units = (e1 - ea) >> 1;
  if (head && tid == 0) cp_async8(X + at_span(e0, p, pitch, mp), sp + e0);
  for (int u = tid; u < units; u += nt) {
    const int e = ea + 2 * u, k = divm(e, mp), c = e - k * p;
    float2* d = X + k * pitch + c;
    if (c + 1 < p) {
      cp_async16(d, sp + e);
    } else {   // the row's last position and the next row's first
      cp_async8(d, sp + e);
      cp_async8(X + (k + 1) * pitch, sp + e + 1);
    }
  }
  if (((e1 - ea) & 1) && tid == nt - 1)
    cp_async8(X + at_span(e1 - 1, p, pitch, mp), sp + e1 - 1);
}

// A warp's share of the tensor-core route's product: m-tile i = w % mt
// (span rows 16 i .. 16 i + 15) over k-range part = w / mt of the p / 8
// k-steps, [k0, k1).
struct Slice {
  int i, part, k0, k1;
  __device__ Slice(const MixWideArgs& W, int p) {
    const int warp = threadIdx.x >> 5, ks = p >> 3;
    const int per = (ks + W.ksplit - 1) / W.ksplit;
    i = warp % W.mt;
    part = warp / W.mt;
    k0 = min(ks, part * per);
    k1 = min(ks, k0 + per);
  }
};

// The tensor-core route's product over a warp's share: all nt n-tiles of
// Z for its m-tile in registers, both planes' A fragments from one 8-byte
// load of (re, im) pairs, B's fragments from shared memory (Bf).
template <int NT>
__device__ __forceinline__ void product(const float2* X, const float2* Bf,
                                        const MixWideArgs& W,
                                        const Slice& sl, float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pl][j][e] = 0.f;
  const float2* r0 = X + (16 * sl.i + g) * W.pitch + t4;
  const float2* r1 = r0 + 8 * W.pitch;
  const float2* bt = Bf + lane;
#pragma unroll 2
  for (int ks = sl.k0; ks < sl.k1; ++ks) {
    const int c = ks << 3;
    const float2 v0 = r0[c], v1 = r1[c], v2 = r0[c + 4], v3 = r1[c + 4];
    uint32_t ah[2][4], al[2][4];
    split(v0.x, ah[0][0], al[0][0]);
    split(v1.x, ah[0][1], al[0][1]);
    split(v2.x, ah[0][2], al[0][2]);
    split(v3.x, ah[0][3], al[0][3]);
    split(v0.y, ah[1][0], al[1][0]);
    split(v1.y, ah[1][1], al[1][1]);
    split(v2.y, ah[1][2], al[1][2]);
    split(v3.y, ah[1][3], al[1][3]);
    const float2* bk = bt + ks * NT * 32;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b = bk[32 * j];
      uint32_t bh[2], bl[2];
      split(b.x, bh[0], bl[0]);
      split(b.y, bh[1], bl[1]);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        mma_tf32(acc[pl][j], al[pl], bh);
        mma_tf32(acc[pl][j], ah[pl], bl);
        mma_tf32(acc[pl][j], ah[pl], bh);
      }
    }
  }
}

// Each k-range's partial Z to its own slice zb[part][plane][row][zpitch]
// (rows 16 i + g and + 8, columns 8 j + 2 t4 and + 1), the slices summed
// into slice 0 in k order element by element, then y[m, r] = sum_a Z[m
// + a, a q + r].  The caller has made the span free for zb.
template <int NT>
__device__ __forceinline__ void sum_out(const float (&acc)[2][NT][4],
                                        float* zb, const MixWideArgs& W,
                                        const Slice& sl, int q, int mt,
                                        float* y0, float* y1, int64_t y_step,
                                        int64_t y0_at, long long* clk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slice = 2 * W.srows * W.zpitch;
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* z0 = zb + sl.part * slice +
                  (pl * W.srows + 16 * sl.i + g) * W.zpitch + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(z0) =
          make_float2(acc[pl][j][0], acc[pl][j][1]);
      *reinterpret_cast<float2*>(z0 + 8 * W.zpitch) =
          make_float2(acc[pl][j][2], acc[pl][j][3]);
    }
  __syncthreads();
  if (W.ksplit > 1) {
    // Row pr of plane pr / rows a warp at a time, its columns across the
    // lanes.
    const int rows = mt + W.periods - 1, cols = W.periods * q;
    for (int pr = warp; pr < 2 * rows; pr += blockDim.x >> 5) {
      float* z = zb + (pr < rows ? pr : W.srows + pr - rows) * W.zpitch;
      for (int col = lane; col < cols; col += 32) {
        float t = z[col];
        for (int part = 1; part < W.ksplit; ++part) t += z[col + part * slice];
        z[col] = t;
      }
    }
    __syncthreads();
  }
  MW_MARK(clk, 7);
  const bool pairs = y1 == y0 + 1 && y_step == 2;
  for (int o = threadIdx.x; o < mt * q; o += blockDim.x) {
    const int m = o / q, r = o - m * q;
    float v[2];
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const float* z = zb + (pl * W.srows + m) * W.zpitch + r;
      float sum = 0.f;
      for (int a = 0; a < W.periods; ++a) sum += z[a * (W.zpitch + q)];
      v[pl] = sum;
    }
    const int64_t at = y0_at + (int64_t)o * y_step;
    if (pairs) {
      *reinterpret_cast<float2*>(y0 + at) = make_float2(v[0], v[1]);
    } else {
      y0[at] = v[0];
      y1[at] = v[1];
    }
  }
}

// grid (ceil(q / nr), ceil(M / tm), batch), block W.threads; NT > 0: the
// tensor-core route with NT n-tiles, else the FMA route with NW windows a
// thread.  mi = ceil(2^32 / inner), mp = ceil(2^32 / p).
template <int NT, int NW>
__global__ void __launch_bounds__(kWideThreads) mix_decimate_wide_kernel(
    DecimArgs A, MixWideArgs W, uint64_t mi, uint64_t mp, long long* clk) {
  extern __shared__ __align__(16) float smem[];
  MW_TIME(clk, 9);
  MW_MARK(clk, 0);
  const int z = blockIdx.x, tile = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p = A.p, q = A.q, n = A.n, hist = A.hist, inner = A.inner;
  const int M = n / p;
  const int m0 = tile * W.tm, mt = min(W.tm, M - m0);
  const int r0 = z * W.nr, nr = min(W.nr, q - r0);
  const int ulo = __ldg(W.zband + 4 * z), width = __ldg(W.zband + 4 * z + 1);
  const int u0 = __ldg(W.zband + 4 * z + 2);
  const Row h{A.h[0] + s * A.h_row, A.h[1] + s * A.h_row, A.h_step,
              A.h_step == 2 && A.h[1] == A.h[0] + 1};
  const Row x{A.x[0] + s * A.x_row, A.x[1] + s * A.x_row, A.x_step,
              A.x_step == 2 && A.x[1] == A.x[0] + 1};
  const Regions reg(W, p, inner);
  float* T = smem + reg.span;
  float2* Bt = reinterpret_cast<float2*>(T + reg.taps);
  float2* At = reinterpret_cast<float2*>(T + reg.taps + reg.tab_b);

  // The span: buf[P0 + e], e < len, at pair sh + at_span(e): the
  // history's positions, the chunk's, zeros past buf (and, mma, past len
  // over the rows the used Z rows read: they meet zero taps, and must be
  // finite).  A complex64 chunk's pairs land at their source's 16-byte
  // phase.  With it, the taps: B's fragments (mma) or the bands (FMA).
  const int64_t P0 = (int64_t)m0 * p + ulo;
  const int len = width > 0 ? (mt - 1) * p + width : 0;
  const int sh = x.pairs ? (int)((((uintptr_t)x.p0 >> 3) + (P0 - hist)) & 1)
                         : 0;
  float2* X = reinterpret_cast<float2*>(smem) + sh;
  const int ex = (int)min((int64_t)len, max((int64_t)0, hist - P0));
  const int ez = (int)min((int64_t)len, max((int64_t)0, hist + n - P0));
  copy_span(X, 0, ex, h, P0, p, W.pitch, mp, tid, nt);
  copy_span(X, ex, ez, x, P0 - hist, p, W.pitch, mp, tid, nt);
  const int zend = NT > 0 ? (mt + W.periods - 1) * p : len;
  for (int e = ez + tid; e < zend; e += nt)
    X[at_span(e, p, W.pitch, mp)] = make_float2(0.f, 0.f);
  if constexpr (NT > 0) {
    const float4* src = reinterpret_cast<const float4*>(W.taps);
    for (int i = tid; i < reg.taps / 4; i += nt)
      cp_async16(reinterpret_cast<float4*>(T) + i, src + i);
  } else {   // the rows' bands, at the source's 16-byte phase
    T = stage_bands(T, W.taps, u0, __ldg(W.zband + 4 * z + 3), W.ls, tid,
                    nt);
  }
  // The oscillator entries of the span's chunk samples [jlo, jhi): all
  // of B, A from a_lo.
  const int jlo = (int)max((int64_t)0, P0 - hist);
  const int jhi = (int)min((int64_t)n, P0 + len - hist);
  const int a_lo = jlo < jhi ? divm(jlo, mi) : 0;
  const int na = jlo < jhi ? divm(jhi - 1, mi) - a_lo + 1 : 0;
  for (int i = tid; i < inner + na; i += nt) {
    if (i < inner)
      Bt[i] = make_float2(__ldg(A.tab[2] + i * A.tab_step[1]),
                          __ldg(A.tab[3] + i * A.tab_step[1]));
    else
      At[i - inner] =
          make_float2(__ldg(A.tab[0] + (a_lo + i - inner) * A.tab_step[0]),
                      __ldg(A.tab[1] + (a_lo + i - inner) * A.tab_step[0]));
  }
  MW_MARK(clk, 1);
  const float pr = __ldg(A.p0[0] + s * A.p0_step);
  const float pi = __ldg(A.p0[1] + s * A.p0_step);
  // The new history buf[n, n + hist): the stream's last tile (phase block
  // 0) writes it, from the span over [c0, c1), from the sources elsewhere
  // (mixing what comes from the chunk).
  const bool hist_out = tile == gridDim.y - 1 && z == 0;
  const int c0 = (int)min((int64_t)hist, max((int64_t)0, P0 - n));
  const int c1 = (int)max((int64_t)c0, min((int64_t)hist, P0 + len - n));
  float* nh0 = A.nh[0] + s * A.nh_row;
  float* nh1 = A.nh[1] + s * A.nh_row;
  const bool nh_pairs = nh1 == nh0 + 1 && A.nh_step == 2;
  if (hist_out)
    for (int i = tid; i < hist - (c1 - c0); i += nt) {
      const int ih = i < c0 ? i : i + c1 - c0;
      const int64_t j = (int64_t)n + ih;
      const Row& src = j < hist ? h : x;
      const int64_t e = (j < hist ? j : j - hist) * src.step;
      float v0 = __ldg(src.p0 + e), v1 = __ldg(src.p1 + e);
      if (j >= hist) {
        const int k = (int)(j - hist), a = divm(k, mi), b = k - a * inner;
        mix(__ldg(A.tab[0] + a * A.tab_step[0]),
            __ldg(A.tab[1] + a * A.tab_step[0]),
            __ldg(A.tab[2] + b * A.tab_step[1]),
            __ldg(A.tab[3] + b * A.tab_step[1]), pr, pi, v0, v1);
      }
      nh0[ih * A.nh_step] = v0;
      nh1[ih * A.nh_step] = v1;
    }
  MW_MARK(clk, 2);
  float* y0 = A.y[0] + s * A.y_row;
  float* y1 = A.y[1] + s * A.y_row;

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  MW_MARK(clk, 3);
  // The mix, once a staged chunk sample, in place: warp w's lane l takes
  // j = jlo + 32 RUN (w + k warps) + l + 32 it, it < RUN, at span position
  // e = j + hist - P0 (row k, column c); the run's indices first, then
  // its loads, then the arithmetic and the stores.
  constexpr int RUN = kMixRun<NT>;
  for (int jb = jlo + 32 * RUN * (tid >> 5) + (tid & 31); jb < jhi;
       jb += RUN * nt) {
    int a = divm(jb, mi), b = jb - a * inner;
    const int e = (int)(jb + hist - P0);
    int k = divm(e, mp), c = e - k * p;
    int at[RUN], ia[RUN], ib[RUN];
#pragma unroll
    for (int it = 0; it < RUN; ++it) {
      at[it] = k * W.pitch + c;
      ia[it] = a - a_lo;
      ib[it] = b;
      for (b += 32; b >= inner; b -= inner) ++a;
      for (c += 32; c >= p; c -= p) ++k;
    }
    const int live = min(RUN, (jhi - jb + 31) >> 5);
    float2 v[RUN], oa[RUN], ob[RUN];
#pragma unroll
    for (int it = 0; it < RUN; ++it)
      if (it < live) {
        v[it] = X[at[it]];
        oa[it] = At[ia[it]];
        ob[it] = Bt[ib[it]];
      }
#pragma unroll
    for (int it = 0; it < RUN; ++it)
      if (it < live) {
        mix(oa[it].x, oa[it].y, ob[it].x, ob[it].y, pr, pi, v[it].x,
            v[it].y);
        X[at[it]] = v[it];
      }
  }
  __syncthreads();
  MW_MARK(clk, 4);
  if (hist_out)
    for (int i = c0 + tid; i < c1; i += nt) {
      const float2 v = X[at_span((int)(n + i - P0), p, W.pitch, mp)];
      if (nh_pairs) {
        reinterpret_cast<float2*>(nh0)[i] = v;
      } else {
        nh0[i * A.nh_step] = v.x;
        nh1[i * A.nh_step] = v.y;
      }
    }
  MW_MARK(clk, 5);
  if constexpr (NT > 0) {
    const Slice sl(W, p);
    float acc[2][NT][4];
    product<NT>(X, reinterpret_cast<const float2*>(T), W, sl, acc);
    MW_MARK(clk, 6);
    __syncthreads();   // every warp is done with the span: Z goes over it
    sum_out<NT>(acc, smem, W, sl, q, mt, y0, y1, A.y_step,
                (int64_t)m0 * q * A.y_step, clk);
  } else {   // one run at pitch p
    BandSums<2, NW> sums(W, reinterpret_cast<const float*>(X), T, r0, nr,
                         ulo, u0, mt, p);
    MW_MARK(clk, 6);
    sums.reduce(W.g);
    MW_MARK(clk, 7);
    sums.store(y0, y1, A.y_step, m0, mt, q, M);
  }
  MW_MARK(clk, 8);
  MW_TIME(clk, 10);
  MW_SM(clk, 11);
}

template <int NT, int NW>
int launch_mix(const DecimArgs& a, const MixWideArgs& w, dim3 grid,
               size_t smem, uint64_t mi, uint64_t mp, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mix_decimate_wide_kernel<NT, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mix_decimate_wide_kernel<NT, NW><<<grid, w.threads, smem, stream>>>(
      a, w, mi, mp, mix_clocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// #2's wide form (see the head of this file): the mixer arguments of
// rr_mix_decimate (tables, start phasor, inner; two planes), aligned
// (hist = Kw - p, n a whole number of periods); wide the route and shape
// of ops/frontend.py mix_wide_config.  Returns cudaErrorInvalidValue on
// a shape it does not take.
int rr_mix_decimate_wide(const DecimArgs* args, const MixWideArgs* wide,
                         void* stream) {
  const DecimArgs& a = *args;
  const MixWideArgs& w = *wide;
  const int M = a.p > 0 ? a.n / a.p : 0;
  // The multiply-shift divisions are exact below 2^31 / d.
  if (a.nplanes != 2 || M < 1 || a.n % a.p || a.hist < 1 || a.inner < 1 ||
      a.b < 1 || a.b > 65535 || (int64_t)a.n * a.inner >= (1LL << 31) ||
      (int64_t)(w.xlen + a.hist + a.p) * a.p >= (1LL << 31) ||
      !a.tab[0] || !a.tab[1] || !a.tab[2] || !a.tab[3] || !a.p0[0] ||
      !a.p0[1] || !a.x[1] || !a.h[1] || !a.y[1] || !a.nh[1] ||
      w.tm < 1 || w.threads < 32 || w.threads % 32 ||
      w.threads > kWideThreads || w.xlen < 1)
    return (int)cudaErrorInvalidValue;
  // Table A's entries a span of xlen positions reads: at most (xlen - 1)
  // / inner + 2, and no more than the chunk's ceil(n / inner).
  const int in_chunk = (a.n - 1) / a.inner + 1;
  const int in_span = (w.xlen - 1) / a.inner + 2;
  if (w.tab_a < (in_chunk < in_span ? in_chunk : in_span))
    return (int)cudaErrorInvalidValue;
  if (w.mma) {
    // All q phases in one block; the span's rows within 16 mt; Z's
    // columns within nt n-tiles; one warp each m-tile x k-range.
    if (a.p % 8 || w.nt < 1 || w.nt > 8 || w.mt < 1 || w.ksplit < 1 ||
        w.srows != 16 * w.mt || w.tm + w.periods - 1 > w.srows ||
        w.periods * a.q > 8 * w.nt || w.xlen > w.srows * a.p ||
        w.pitch < a.p || w.pitch % 2 || w.zpitch < 8 * w.nt ||
        w.zpitch % 2 || w.threads != 32 * w.mt * w.ksplit || w.nr < a.q)
      return (int)cudaErrorInvalidValue;
  } else {
    const int64_t lanes = (int64_t)w.g * w.nr * w.ws;
    if (w.pitch != a.p || w.g < 1 || w.g > 32 || (w.g & (w.g - 1)) ||
        w.nr < 1 || w.un < 1 || w.ws < 1 || w.nw < 1 || w.nw > kWideNW ||
        w.ls < 1 || lanes > w.threads || w.tm != w.ws * w.nw)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * (size_t)Regions(w, a.p, a.inner).total();
  const int tiles = (M + w.tm - 1) / w.tm;
  if (smem > kSmemMax || tiles > 65535) return (int)cudaErrorInvalidValue;
  const uint64_t mi = ((1ULL << 32) + a.inner - 1) / a.inner;
  const uint64_t mp = ((1ULL << 32) + a.p - 1) / a.p;
  const dim3 grid(w.mma ? 1 : (a.q + w.nr - 1) / w.nr, tiles, a.b);
  cudaStream_t st = (cudaStream_t)stream;
  if (w.mma) switch (w.nt) {
    case 1: return launch_mix<1, 1>(a, w, grid, smem, mi, mp, st);
    case 2: return launch_mix<2, 1>(a, w, grid, smem, mi, mp, st);
    case 3: return launch_mix<3, 1>(a, w, grid, smem, mi, mp, st);
    case 4: return launch_mix<4, 1>(a, w, grid, smem, mi, mp, st);
    case 5: return launch_mix<5, 1>(a, w, grid, smem, mi, mp, st);
    case 6: return launch_mix<6, 1>(a, w, grid, smem, mi, mp, st);
    case 7: return launch_mix<7, 1>(a, w, grid, smem, mi, mp, st);
    default: return launch_mix<8, 1>(a, w, grid, smem, mi, mp, st);
  }
  switch (w.nw) {
    case 1: return launch_mix<0, 1>(a, w, grid, smem, mi, mp, st);
    case 2: return launch_mix<0, 2>(a, w, grid, smem, mi, mp, st);
    case 3: return launch_mix<0, 3>(a, w, grid, smem, mi, mp, st);
    case 4: return launch_mix<0, 4>(a, w, grid, smem, mi, mp, st);
    case 5: return launch_mix<0, 5>(a, w, grid, smem, mi, mp, st);
    case 6: return launch_mix<0, 6>(a, w, grid, smem, mi, mp, st);
    case 7: return launch_mix<0, 7>(a, w, grid, smem, mi, mp, st);
    default: return launch_mix<0, 8>(a, w, grid, smem, mi, mp, st);
  }
}

#ifdef RR_DECIM_CLOCKS
// Development build only: rr_mix_decimate_wide launches from now on stamp
// their phases into clk (int64, kMixMarks a block, block (z-major)
// blockIdx.z, .y, .x); null stops it.
int rr_mix_wide_clocks(long long* clk) {
  mix_clocks = clk;
  return 0;
}
#endif

}  // extern "C"
