// Rational p:q FIR decimation, with an optional complex mixer prologue.
//
// Replaces two TPU kernels of radiorust_tpu/ops/pallas_frontend.py:
//   rr_decimate      <- pallas_decimate      (:181, body _make_decim_kernel :138)
//   rr_mix_decimate  <- fused_mix_decimate   (:241, body _make_kernel :42)
// and, at plans past one block of rr_decimate, #1's wide form
// rr_decimate_wide (decimate_wide_kernel below; #2's wide form,
// rr_mix_decimate_wide, is mix_decimate_wide.cu).
//
// What it computes, per stream s, over buf = [hist || x] (hist = Kw - p):
//   y[s, m*q + r] = sum_{u < Kw} W[r, u] * buf[s, m*p + u]
//   new_hist[s]   = buf[s, n : n + hist]
// on one real plane or two (re, im) sharing the taps.  The mixer form first
// multiplies x by osc[a*inner + b] = A[a] * B[b] and by the per-stream start
// phasor p0, in that order, so the history stays in the mixed domain.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s float32):
//   - the receive chain's head (8:3, Kw 41, two planes, 64 x 24576 in):
//     17.3 MB of device memory, 5.2 us; 125 MFLOP, 1.9 us: bytes;
//   - its tail (8:1, Kw 295, one plane, 64 x 9216 in): 2.8 MB, 0.84 us;
//     43.5 MFLOP, 0.65 us: bytes, barely; path F's 8:1, Kw 77, two planes
//     of 64 x 8192: 4.7 MB, 1.4 us: bytes;
//   - the fuse_deemphasis fold (8:1, Kw 9510, one plane): 1.40 GFLOP,
//     20.9 us of float32 FMA against 2.8 MB: operations.
// Each output costs Kw FMAs on inputs its neighbours share, so the kernel
// must feed the FMA units from registers, not from one shared-memory load
// per FMA, and read device memory about once.
//
// What the design does about it:
//   - Polyphase layout in shared memory.  A tile is TM = 32 R decimation
//     periods of one stream.  Its span of buf is staged de-interleaved by
//     phase, X_c[k] = buf[(m0 + k) p + c], so output m at tap u = a p + c
//     reads X_c[m + a]: no stride-p access.  Each phase row is skewed by
//     one word every R (position k + k / R), so the 32 lanes of a warp, R
//     outputs apart, read 32 distinct banks.
//   - Register-blocked outputs.  Lane t of a warp keeps outputs
//     t R .. t R + R - 1 of one (stream, r) in registers and slides an
//     R-wide window of X_c through registers: one shared load feeds R FMAs
//     per plane, and the two planes share each tap.  The taps are re-laid
//     once on the host to [q][p][apad] (apad = ceil(Kw/p) rounded up to 8,
//     zero padded) and read as warp-uniform float4 broadcasts.
//   - Tap groups.  The (phase, tap) range p * apad is split over G warps
//     of the block (G q warps in all, none idle); their partial sums meet
//     in shared memory, and the outputs leave in order, coalesced.  Long
//     windows (the 9510-tap fold) get many groups, short ones few.
//   - Vector staging.  A block stages its tile a quad of four samples a
//     thread at a time: one 16-byte load per plane of a float plane, or
//     two of a complex64 tensor's (re, im) pairs read in place through its
//     .real / .imag views (element stride 2), else four scalar loads; the
//     taps arrive meanwhile by cp.async.  The mixer runs while
//     staging, with the oscillator's entries read per quad (A once, B as
//     float4) at indices from a multiply-shift division, so the mixed
//     signal never reaches device memory.  The last tile's block writes
//     the new history from the values it staged, so it equals the plain
//     version's bit for bit.
//   - Outputs go to any (row, element) stride: float planes, or the re and
//     im of a complex64 tensor, as one 8-byte store per output; a
//     real-input call writes the zero imaginary part itself.
// Plain float32 FMA; no tensor cores.
//
// The wide form (rr_decimate_wide, rr_decimate_phase): decimate_wide_kernel.
// It replaces pallas_decimate (pallas_frontend.py:181) at the plans the
// polyphase kernel does not take: more than 16 output phases, or a staged
// span and [q][p][apad] taps past shared memory (48 kHz -> 44.1 kHz: p =
// 160, q = 147, Kw = 171, 10 periods a 1600-sample chunk; the upsample
// 48 kHz -> 1.024 MHz: p = 3, q = 64, 256 periods a 768-sample chunk).
// There each kernel row W[r] is a band of nonzero taps [lo_r, lo_r +
// L_r) of Kw: a downsample plan's rows are the prototype at q offsets (L
// = 12 of 171, 233 of 10472), an upsample plan's its q phases (36 of 38).
// It also runs phase mode, a chunk of C samples that is not a whole
// number of periods.  The JAX package computes that with XLA's
// convolution on a slice at a traced offset (radiorust_tpu/ops/
// polyphase.py rational_fir_phase, no Pallas kernel); here the history is
// the last Kw - 1 samples, buf = [hist || x || zeros], and the step's grid
// phase ph = phase[0] (an int32 in device memory: a captured CUDA graph
// replays the step as the phase walks its schedule) puts window w at
// buf[p - 1 - ph + w p ..).  E = ceil(C / p) windows are written; those
// from v = (ph + C) / p on are exact zeros (not yet complete this step).
// The new history is buf[C, C + Kw - 1), which may reach back into the
// old history (a chunk shorter than the window), and the new phase is
// (phase + C) mod p per stream.
//
// What bounds it on an H100: bytes, by a margin that leaves launch and
// latency the real floor.  Path K's tail (384 kHz -> 44.1 kHz in phase
// mode at chunk 6144, 64 streams, L = 285) moves 5.1 MB, 1.5 us, for 54
// MFLOP, 0.8 us; 1.024 MHz -> 44.1 kHz at 16384 moves 15 MB, 4.4 us; path
// I moves 1.6 MB, 0.5 us.  Every output is a dot product of L taps with
// L samples its neighbours share only in part, so what costs is the
// shared-memory loads that feed the FMAs, and each block's latency.
//
// What the design does about it:
//   - One output, one thread (or a lane group).  A block holds nr
//     consecutive phases and tm windows of one stream: thread t takes
//     lane g = t % G of phase r0 + (t / G) % nr and windows ws + j WS
//     (j < NW, kept in registers), so each tap it loads from shared
//     memory feeds NW windows on both planes.  Bands of 128 taps or more
//     are split over a group of G = 8 lanes that meet in one 3-step
//     shuffle; shorter ones run whole in one thread.  Lanes take
//     consecutive phases of one window, so the outputs leave as
//     coalesced 8-byte (re, im) stores.
//   - Only the bands, each once.  The wrapper re-lays the taps once per
//     taps tensor to [U][ls]: the distinct bands, each from tap 0, zero
//     padded (ls = G mod 2 G, so the lanes' tap reads fall in distinct
//     banks), beside each row's (lo_r, L_r, band) and each phase block's
//     joint band (ulo, width) and bands [u0, u0 + un).  A downsample
//     plan's rows are one prototype at q offsets, so U = 1 and a block
//     copies one band; an upsample plan's rows are q phases of it (U =
//     q).  A block copies its bands by cp.async, 16 bytes at a time at
//     the source's own 16-byte phase; the dense W is never read.
//   - One staged span.  A block's windows read buf[start + (m0 + k) p +
//     ulo + i], i < width: one run of (tm - 1) p + width samples where
//     windows overlap (p <= width), else tm runs of width samples at a
//     stride xs >= width of p's parity.  A complex64 input is staged in place as
//     (re, im) pairs by cp.async, 16 bytes where the shared row and the
//     source share a 16-byte phase (the row is shifted by one pair to
//     make them), 8 elsewhere; float planes and real inputs by scalar
//     loads.  The taps' and the span's copies overlap; zeros go past the
//     chunk in phase mode.
//   - Shared memory as the bands need it, above 48 KB by opt-in (K's
//     block: one band of 296 taps and 5 windows of 538 pairs, 22 KB).
//     Phases split over blocks of at most 256 / G rows, windows over
//     tiles of WS NW, so that a call fills the card (wide_config in
//     ops/frontend.py picks the shape; this file checks it).
//   - Every block copies its share of the new history from the sources,
//     bit for bit, while its copies land; one block a stream writes the
//     new phase.
// Plain float32 FMA; no tensor cores (operations do not bound it).
//
// A development build (-DRR_DECIM_CLOCKS, rr_decim_clocks) stamps each
// block's phases (kWideMarks a block): clock64() at its start, after the
// copies are issued, after its share of the history, once the copies
// land, after the sums, the shuffles and the stores; %globaltimer at its
// start and end; its SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decimate.cuh"

// The wide launch's shape (ops/frontend.py wide_config and _WideArgs).
struct WideArgs {
  const float* taps;   // [U][ls]: the distinct bands, from tap 0, padded
  const int* rows;     // [q][3]: row r's (lo_r, L_r, its band in taps)
  const int* zband;    // [ceil(q / nr)][4]: a phase block's joint band
                       // (ulo, width) and its bands [u0, u0 + un)
  int ls, g, nr, un, ws, nw, xs, xlen, threads;
};

namespace {

constexpr int kMaxThreads = 512;

// Samples [0, count) of one source row at (ptr, step), four at a time.
struct Source {
  const float* p0;
  const float* p1;
  int64_t step;
  int mode;   // 0 scalar, 1 float4 of a float plane, 2 float4 of (re, im)
  int count;
};

// Where a staged sample goes: the tile's span of buf, positions
// [J0, J0 + lx p), as p phase rows of ph floats per plane (position J0 +
// k p + c at row c, skewed column k); positions at or past n also go to
// the new history (the stream's last tile only).
struct Span {
  float* xs;
  int J0, p, ph, n;
  uint64_t mp;   // ceil(2^32 / p)
  float* nh0;
  float* nh1;
  int64_t nh_step;
  bool hist_out;
};

struct Mixer {
  const float* ar;
  const float* ai;
  const float* br;
  const float* bi;
  int64_t sa, sb;
  int inner;
  int tmode;     // B read as float4: 1 of planes, 2 of (re, im) pairs
  uint64_t mi;   // ceil(2^32 / inner)
  float pr, pi;
};

template <int R>
__device__ __forceinline__ int skew(int k) {
  return k + k / R;
}


__device__ __forceinline__ void split4(const float4& a, float (&v)[4]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// Two float4 of (re, im) pairs -> four re, four im.
__device__ __forceinline__ void pairs4(const float4& a, const float4& b,
                                       float (&v0)[4], float (&v1)[4]) {
  v0[0] = a.x; v0[1] = a.z; v0[2] = b.x; v0[3] = b.z;
  v1[0] = a.y; v1[1] = a.w; v1[2] = b.y; v1[3] = b.w;
}

template <int NP>
__device__ __forceinline__ void load4(const Source& src, int i, float (&v0)[4],
                                      float (&v1)[4]) {
  if (src.mode == 1) {
    split4(__ldg(reinterpret_cast<const float4*>(src.p0 + i)), v0);
    if (NP == 2) split4(__ldg(reinterpret_cast<const float4*>(src.p1 + i)), v1);
  } else if (src.mode == 2) {
    const float4* at = reinterpret_cast<const float4*>(src.p0 + 2 * i);
    pairs4(__ldg(at), __ldg(at + 1), v0, v1);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = i + e < src.count;
      v0[e] = in ? __ldg(src.p0 + (i + e) * src.step) : 0.f;
      if (NP == 2) v1[e] = in ? __ldg(src.p1 + (i + e) * src.step) : 0.f;
    }
  }
}

// One quad's oscillator entries where it does not wrap B (tmode != 0):
// t = A re, A im, B re [4], B im [4].
__device__ __forceinline__ void load_osc(const Mixer& o, int a, int b,
                                         float (&t)[10]) {
  t[0] = __ldg(o.ar + a * o.sa);
  t[1] = __ldg(o.ai + a * o.sa);
  float4 r4, i4;
  if (o.tmode == 1) {
    r4 = __ldg(reinterpret_cast<const float4*>(o.br + b));
    i4 = __ldg(reinterpret_cast<const float4*>(o.bi + b));
  } else {   // (re, im) pairs of a complex64 table
    const float4* at = reinterpret_cast<const float4*>(o.br + 2 * b);
    const float4 u = __ldg(at), v = __ldg(at + 1);
    r4 = make_float4(u.x, u.z, v.x, v.z);
    i4 = make_float4(u.y, u.w, v.y, v.w);
  }
  t[2] = r4.x; t[3] = r4.y; t[4] = r4.z; t[5] = r4.w;
  t[6] = i4.x; t[7] = i4.y; t[8] = i4.z; t[9] = i4.w;
}


// Samples i0 .. i0 + 3 of a quad (those in [lo, hi)) to buffer positions
// i + off; with mx, mixed first (t: the quad's load_osc entries where
// tmode != 0).
template <int NP, int R>
__device__ __forceinline__ void put_quad(const Span& sp, int i0, int lo, int hi,
                                         int off, const float (&v0)[4],
                                         const float (&v1)[4],
                                         const Mixer* mx, const float (&t)[10]) {
  // Phase row and column of the quad's first position (>= J0 - 3).
  const int jb = i0 + off - sp.J0 + 4 * sp.p;
  int k = divm(jb, sp.mp);
  int c = jb - k * sp.p;
  k -= 4;
  int a = 0, b = 0;
  if (mx) {
    a = divm(i0, mx->mi);
    b = i0 - a * mx->inner;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + e;
    if (i >= lo && i < hi) {
      float x0 = v0[e], x1 = v1[e];
      if (mx && mx->tmode)
        mix(t[0], t[1], t[2 + e], t[6 + e], mx->pr, mx->pi, x0, x1);
      else if (mx)
        mix(__ldg(mx->ar + a * mx->sa), __ldg(mx->ai + a * mx->sa),
            __ldg(mx->br + b * mx->sb), __ldg(mx->bi + b * mx->sb), mx->pr,
            mx->pi, x0, x1);
      float* at = sp.xs + c * sp.ph + skew<R>(k);
      at[0] = x0;
      if (NP == 2) at[sp.p * sp.ph] = x1;
      const int j = i + off;
      if (sp.hist_out && j >= sp.n) {
        sp.nh0[(j - sp.n) * sp.nh_step] = x0;
        if (NP == 2) sp.nh1[(j - sp.n) * sp.nh_step] = x1;
      }
    }
    if (++c == sp.p) { c = 0; ++k; }
    if (mx && ++b == mx->inner) { b = 0; ++a; }
  }
}


// Stages the history samples [hlo, hhi) (at positions i) and the input
// samples [xlo, xhi) (at positions hist + i) of one tile: their quads run
// as one sequence over the block's threads.
template <bool MIX, int NP, int R>
__device__ void stage(const Source& hs, int hlo, int hhi, const Source& xsrc,
                      int xlo, int xhi, int hist, const Mixer& mx,
                      const Span& sp) {
  const int qh0 = hlo >> 2, nhq = hlo < hhi ? ((hhi + 3) >> 2) - qh0 : 0;
  const int qx0 = xlo >> 2, nxq = xlo < xhi ? ((xhi + 3) >> 2) - qx0 : 0;
  for (int w = threadIdx.x; w < nhq + nxq; w += blockDim.x) {
    float v0[4], v1[4], t[10];
    if (w < nhq) {
      load4<NP>(hs, 4 * (qh0 + w), v0, v1);
      put_quad<NP, R>(sp, 4 * (qh0 + w), hlo, hhi, 0, v0, v1, nullptr, t);
    } else {
      const int i0 = 4 * (qx0 + w - nhq);
      load4<NP>(xsrc, i0, v0, v1);
      if (MIX && mx.tmode) {
        const int a = divm(i0, mx.mi);
        load_osc(mx, a, i0 - a * mx.inner, t);
      }
      put_quad<NP, R>(sp, i0, xlo, xhi, hist, v0, v1, MIX ? &mx : nullptr, t);
    }
  }
}

// Tile outputs of warp (g, r): acc[pl][j] = output lane R + j over this
// group's (phase, tap) pairs f in [f_lo, f_hi), R at a time; win[j] holds
// X_c[lane R + a + j] in slot (a + j) % R.
template <int NP, int R>
__device__ __forceinline__ void compute(const float* taps, const float* xs,
                                        int r, int f_lo, int f_hi, int apad,
                                        int p, int ph, int lane,
                                        float (&acc)[NP][R]) {
#pragma unroll
  for (int pl = 0; pl < NP; ++pl)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[pl][j] = 0.f;
  if (f_lo >= f_hi) return;
  int c = f_lo / apad, a0 = f_lo - c * apad;
  const float* wr = taps + r * p * apad;
  const float* xb[NP];
  float win[NP][R];
  for (int f0 = f_lo; f0 < f_hi; f0 += R) {
    if (f0 == f_lo || a0 == 0) {
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
        xb[pl] = xs + (pl * p + c) * ph + (lane + a0 / R) * (R + 1);
#pragma unroll
        for (int j = 0; j < R; ++j) win[pl][j] = xb[pl][j];
      }
    }
    float w[R];
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(wr + f0 + j);
      w[j] = t4.x; w[j + 1] = t4.y; w[j + 2] = t4.z; w[j + 3] = t4.w;
    }
#pragma unroll
    for (int da = 0; da < R; ++da) {
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[pl][j] = fmaf(w[da], win[pl][(j + da) % R], acc[pl][j]);
        win[pl][da] = xb[pl][R + 1 + da];
      }
    }
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) xb[pl] += R + 1;
    a0 += R;
    if (a0 == apad) { a0 = 0; ++c; }
  }
}

// Phase-row length of a tile, ph = 4 mod 8: the staging stores of two
// phase rows land 16 banks apart.
__host__ __device__ __forceinline__ int row_len(int lx, int R) {
  const int ph = lx - 1 + (lx - 1) / R + 1;
  return ph + (12 - ph % 8) % 8;
}

// grid (ceil(M / TM), batch), block 32 * G * q: warp w computes phase r =
// w % q over tap group g = w / q.  Shared: taps [q][p][apad], then NP
// planes of p phase rows of ph floats (reused for the partial sums).
template <bool MIX, int NP, int R>
__global__ void __launch_bounds__(kMaxThreads) decimate_kernel(
    DecimArgs A, int G, int L, int xmode, int hmode, int tmode, uint64_t mp,
    uint64_t mi) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TM = 32 * R;
  const int s = blockIdx.y;
  const int p = A.p, q = A.q, apad = A.apad, n = A.n, hist = A.hist;
  const int M = n / p, m0 = blockIdx.x * TM, mt = min(TM, M - m0);
  const int lx = TM + apad, ph = row_len(lx, R);
  const int ftot = p * apad, ntaps = q * ftot;
  float* taps = smem;
  float* xs = smem + ntaps;
  const int tid = threadIdx.x, nt = blockDim.x;

  // The taps arrive by cp.async while the span is staged.
  for (int i = tid; i < ntaps / 4; i += nt)
    cp_async16(reinterpret_cast<float4*>(taps) + i,
               reinterpret_cast<const float4*>(A.taps) + i);

  // The block's span of buf: positions [J0, J1), p rows of lx samples.
  const int J0 = m0 * p, J1 = J0 + lx * p;
  const bool last = blockIdx.x == gridDim.x - 1;
  const Span sp{xs, J0, p, ph, n, mp, A.nh[0] + s * A.nh_row,
                NP == 2 ? A.nh[1] + s * A.nh_row : nullptr, A.nh_step, last};
  Mixer mx{};
  if (MIX)
    mx = Mixer{A.tab[0], A.tab[1], A.tab[2], A.tab[3], A.tab_step[0],
               A.tab_step[1], A.inner, tmode, mi,
               __ldg(A.p0[0] + s * A.p0_step), __ldg(A.p0[1] + s * A.p0_step)};
  const Source hs{A.h[0] + s * A.h_row,
                  NP == 2 ? A.h[1] + s * A.h_row : nullptr, A.h_step, hmode,
                  hist};
  const Source xsrc{A.x[0] + s * A.x_row,
                    NP == 2 ? A.x[1] + s * A.x_row : nullptr, A.x_step, xmode,
                    n};
  stage<MIX, NP, R>(hs, J0, min(J1, hist), xsrc, max(J0 - hist, 0),
                    min(J1 - hist, n), hist, mx, sp);
  // Past the end of buf (the last tiles): zeros, which meet zero taps or
  // outputs that are not written.
  for (int j = max(J0, hist + n) + tid; j < J1; j += nt) {
    const int jl = j - J0, k = jl / p, c = jl - k * p;
    xs[c * ph + skew<R>(k)] = 0.f;
    if (NP == 2) xs[(p + c) * ph + skew<R>(k)] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int r = warp % q, g = warp / q;
  const int f_lo = g * L, f_hi = min(f_lo + L, ftot);
  float acc[NP][R];
  compute<NP, R>(taps, xs, r, f_lo, f_hi, apad, p, ph, lane, acc);
  __syncthreads();

  // Partial sums [NP][G][q][rs] over the phase rows, then each output is
  // the sum of its G groups, written in output order.
  const int rs = skew<R>(TM - 1) + 1;
  float* red = xs;
#pragma unroll
  for (int pl = 0; pl < NP; ++pl)
#pragma unroll
    for (int j = 0; j < R; ++j)
      red[((pl * G + g) * q + r) * rs + lane * (R + 1) + j] = acc[pl][j];
  __syncthreads();
  float* y0 = A.y[0] + s * A.y_row;
  float* y1 = A.y[1] ? A.y[1] + s * A.y_row : nullptr;
  const bool pairs = y1 == y0 + 1 && A.y_step == 2;
  for (int o = tid; o < mt * q; o += nt) {
    const int m = o / q, rr = o - m * q;
    const int64_t at = (int64_t)(m0 * q + o) * A.y_step;
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      const float* src = red + (pl * G * q + rr) * rs + skew<R>(m);
      for (int gg = 0; gg < G; ++gg) v[pl] += src[gg * q * rs];
    }
    if (pairs) {
      *reinterpret_cast<float2*>(y0 + at) = make_float2(v[0], v[1]);
    } else {
      y0[at] = v[0];
      if (y1) y1[at] = v[1];   // a real input's imaginary part is 0
    }
  }
  if (NP == 1 && A.nh[1] && last) {
    float* z = A.nh[1] + s * A.nh_row;
    for (int i = tid; i < hist; i += nt) z[i * A.nh_step] = 0.f;
  }
}

constexpr int kWideMarks = 10;      // clock stamps a block (development)

#ifdef RR_DECIM_CLOCKS
#define DW_STAMP(clk, k, v)                                               \
  do {                                                                    \
    if ((clk) != nullptr && threadIdx.x == 0)                             \
      (clk)[(((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \
             blockIdx.x) * kWideMarks + (k)] = (v);                       \
  } while (0)
__device__ __forceinline__ long long dw_global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long dw_sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}
#define DW_MARK(clk, k) DW_STAMP(clk, k, clock64())
#define DW_TIME(clk, k) DW_STAMP(clk, k, dw_global_ns())
#define DW_SM(clk, k) DW_STAMP(clk, k, dw_sm_id())
long long* wide_clocks = nullptr;
#else
#define DW_MARK(clk, k) \
  do {                  \
  } while (0)
#define DW_TIME(clk, k) DW_MARK(clk, k)
#define DW_SM(clk, k) DW_MARK(clk, k)
long long* const wide_clocks = nullptr;
#endif

// count complex64 elements src[0, count) to dst[0, count), read in place
// as (re, im) pairs, by the block's threads: 16 bytes at a time where
// source and destination share their 16-byte phase, else 8.
__device__ __forceinline__ void copy_pairs(float2* dst, const float2* src,
                                           int count, int tid, int nt) {
  if (count <= 0) return;
  const int odd = (int)(((uintptr_t)src >> 3) & 1);
  if (odd != (int)((__cvta_generic_to_shared(dst) >> 3) & 1)) {
    for (int i = tid; i < count; i += nt) cp_async8(dst + i, src + i);
    return;
  }
  const int head = min(odd, count), pairs = (count - head) >> 1;
  if (head && tid == 0) cp_async8(dst, src);
  for (int i = tid; i < pairs; i += nt)
    cp_async16(dst + head + 2 * i, src + head + 2 * i);
  if (((count - head) & 1) && tid == nt - 1)
    cp_async8(dst + count - 1, src + count - 1);
}

// count elements of a source from element e0 to X[d0, d0 + count) (NP
// floats a position).
template <int NP>
__device__ __forceinline__ void put(float* X, int d0, const Row& src,
                                    int64_t e0, int count, int tid, int nt) {
  if (NP == 2 && src.pairs) {
    copy_pairs(reinterpret_cast<float2*>(X) + d0,
               reinterpret_cast<const float2*>(src.p0) + e0, count, tid,
               nt);
    return;
  }
  for (int i = tid; i < count; i += nt) {
    const float v0 = __ldg(src.p0 + (e0 + i) * src.step);
    if (NP == 2)
      reinterpret_cast<float2*>(X)[d0 + i] =
          make_float2(v0, __ldg(src.p1 + (e0 + i) * src.step));
    else
      X[d0 + i] = v0;
  }
}

// Positions [J, J + len) of buf = [hist || x || zeros] to X[D, D + len).
template <int NP>
__device__ __forceinline__ void stage_run(float* X, int D, int64_t J,
                                          int len, const Row& h, const Row& x,
                                          int hist, int n, int tid, int nt) {
  const int64_t end = J + len, xa = hist, xb = (int64_t)hist + n;
  int64_t a = J, b = end < xa ? end : xa;
  if (a < b) put<NP>(X, D, h, a, (int)(b - a), tid, nt);
  a = J > xa ? J : xa;
  b = end < xb ? end : xb;
  if (a < b) put<NP>(X, D + (int)(a - J), x, a - hist, (int)(b - a), tid, nt);
  a = J > xb ? J : xb;
  for (int64_t j = a + tid; j < end; j += nt) {
    const int d = D + (int)(j - J);
    if (NP == 2)
      reinterpret_cast<float2*>(X)[d] = make_float2(0.f, 0.f);
    else
      X[d] = 0.f;
  }
}

// grid (ceil(q / nr), ceil(M / tm), batch) with tm = WS NW; block
// W.threads.  Shared: the taps, then the staged span, xlen + 1
// positions of NP floats (one spare for the 16-byte shift).  Phase mode:
// A.hist = Kw - 1, M = ceil(n / p) windows from p - 1 - phase_in[0];
// else A.hist = Kw - p, M = n / p from 0.
template <int NP, int NW>
__global__ void __launch_bounds__(kWideThreads) decimate_wide_kernel(
    DecimArgs A, WideArgs W, int phase_mode, const int* __restrict__ phase_in,
    int* __restrict__ phase_out, long long* clk) {
  extern __shared__ __align__(16) float smem[];
  DW_TIME(clk, 7);
  DW_MARK(clk, 0);
  const int z = blockIdx.x, tile = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p = A.p, q = A.q, n = A.n, hist = A.hist;
  const int M = phase_mode ? (n + p - 1) / p : n / p;
  // Window m reads buf[start + m p + u]; windows from v on are not
  // complete (phase mode).
  const int ph = phase_mode ? __ldg(phase_in) : 0;
  const int64_t start = phase_mode ? p - 1 - ph : 0;
  const int v = phase_mode ? (ph + n) / p : M;
  const int tm = W.ws * W.nw;
  const int m0 = tile * tm, mt = min(tm, M - m0);
  const int r0 = z * W.nr, nr = min(W.nr, q - r0);
  const int ulo = __ldg(W.zband + 4 * z), width = __ldg(W.zband + 4 * z + 1);
  const int u0 = __ldg(W.zband + 4 * z + 2), un = __ldg(W.zband + 4 * z + 3);
  const Row h{A.h[0] + s * A.h_row, NP == 2 ? A.h[1] + s * A.h_row : nullptr,
              A.h_step, NP == 2 && A.h_step == 2 && A.h[1] == A.h[0] + 1};
  const Row x{A.x[0] + s * A.x_row, NP == 2 ? A.x[1] + s * A.x_row : nullptr,
              A.x_step, NP == 2 && A.x_step == 2 && A.x[1] == A.x[0] + 1};

  // The rows' bands, at the source's 16-byte phase: 16 bytes a copy.
  const float* T = stage_bands(smem, W.taps, u0, un, W.ls, tid, nt);
  // The span: one run where windows overlap (xs == p), else one a window.
  // A complex64 chunk's pairs land at their source's 16-byte phase.
  const int64_t P0 = start + (int64_t)m0 * p + ulo;
  const int sh = x.pairs ? (int)((((uintptr_t)x.p0 >> 3) + (P0 - hist)) & 1)
                         : 0;
  float* X = smem + wide_tap_floats(W.un, W.ls) + NP * sh;
  const bool one_run = W.xs == p;
  const int runs = one_run ? 1 : mt;
  const int rlen = one_run ? (mt - 1) * p + width : width;
  if (width > 0)
    for (int k = 0; k < runs; ++k)
      stage_run<NP>(X, k * W.xs, P0 + (int64_t)k * p, rlen, h, x, hist, n,
                    tid, nt);
  DW_MARK(clk, 1);
  // This block's share of the new history buf[n, n + hist), copied from
  // its sources while the copies land: four loads in flight a thread.
  {
    const int nb = gridDim.x * gridDim.y, bi = tile * gridDim.x + z;
    const int per = (hist + nb - 1) / nb;
    const int i1 = min(hist, (bi + 1) * per);
    float* nh0 = A.nh[0] + s * A.nh_row;
    float* nh1 = A.nh[1] ? A.nh[1] + s * A.nh_row : nullptr;
    for (int i0 = bi * per + tid; i0 < i1; i0 += 4 * nt) {
      float v0[4], v1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * nt;
        const int64_t j = (int64_t)n + i;
        const Row& src = j < hist ? h : x;
        const int64_t at = (j < hist ? j : j - hist) * src.step;
        v0[e] = i < i1 ? __ldg(src.p0 + at) : 0.f;
        v1[e] = NP == 2 && i < i1 ? __ldg(src.p1 + at) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * nt;
        if (i < i1) {
          nh0[i * A.nh_step] = v0[e];
          if (nh1) nh1[i * A.nh_step] = v1[e];
        }
      }
    }
    if (phase_mode && bi == 0 && tid == 0)
      phase_out[s] = (phase_in[s] + n) % p;
  }
  DW_MARK(clk, 2);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  DW_MARK(clk, 3);

  // The sums over the bands (decimate.cuh BandSums), the lane groups'
  // shuffles, the stores.
  BandSums<NP, NW> sums(W, X, T, r0, nr, ulo, u0, mt, W.xs);
  DW_MARK(clk, 4);
  sums.reduce(W.g);
  DW_MARK(clk, 5);
  sums.store(A.y[0] + s * A.y_row, A.y[1] ? A.y[1] + s * A.y_row : nullptr,
             A.y_step, m0, mt, q, v);
  DW_MARK(clk, 6);
  DW_TIME(clk, 8);
  DW_SM(clk, 9);
}

// Shared bytes of a wide launch; ops/frontend.py::_wide_smem mirrors it.
size_t wide_smem_bytes(int np, int un, int ls, int xlen) {
  return sizeof(float) *
         ((size_t)wide_tap_floats(un, ls) + (size_t)np * (xlen + 1));
}

template <int NP, int NW>
int launch_wide_nw(const DecimArgs& a, const WideArgs& w, int phase_mode,
                   const int* phase_in, int* phase_out, dim3 grid,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decimate_wide_kernel<NP, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decimate_wide_kernel<NP, NW><<<grid, w.threads, smem, stream>>>(
      a, w, phase_mode, phase_in, phase_out, wide_clocks);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_wide(const DecimArgs& a, const WideArgs& w, int phase_mode,
                const int* phase_in, int* phase_out, cudaStream_t stream) {
  const int M = phase_mode ? (a.n + a.p - 1) / a.p : a.n / a.p;
  const int64_t lanes = (int64_t)w.g * w.nr * w.ws;
  // The shape wide_config gives: lane groups within a warp, every
  // thread's place in the block, the span within its rows.
  if (M < 1 || a.b < 1 || a.b > 65535 || w.g < 1 || w.g > 32 ||
      (w.g & (w.g - 1)) || w.nr < 1 || w.un < 1 || w.ws < 1 || w.nw < 1 ||
      w.nw > kWideNW || w.ls < 1 || w.threads % 32 ||
      w.threads > kWideThreads || lanes > w.threads || w.xs < 0 ||
      (w.xs == a.p ? (int64_t)(w.ws * w.nw - 1) * a.p > w.xlen
                   : (int64_t)w.ws * w.nw * w.xs > w.xlen))
    return (int)cudaErrorInvalidValue;
  if (phase_mode && (!phase_in || !phase_out || a.hist < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes(NP, w.un, w.ls, w.xlen);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int tm = w.ws * w.nw, tiles = (M + tm - 1) / tm;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((a.q + w.nr - 1) / w.nr, tiles, a.b);
  switch (w.nw) {
    case 1: return launch_wide_nw<NP, 1>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    case 2: return launch_wide_nw<NP, 2>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    case 3: return launch_wide_nw<NP, 3>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    case 4: return launch_wide_nw<NP, 4>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    case 5: return launch_wide_nw<NP, 5>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    case 6: return launch_wide_nw<NP, 6>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    case 7: return launch_wide_nw<NP, 7>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
    default: return launch_wide_nw<NP, 8>(a, w, phase_mode, phase_in, phase_out, grid, smem, stream);
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// How a source's quads are read: float4 loads need 16-byte aligned rows
// and a whole number of quads per row.
int load_mode(const float* const* ptr, int np, int64_t row, int64_t step,
              int count) {
  if (row % 4 || count % 4) return 0;
  if (step == 1 && aligned16(ptr[0]) && (np == 1 || aligned16(ptr[1])))
    return 1;
  if (step == 2 && aligned16(ptr[0]) && (np == 1 || ptr[1] == ptr[0] + 1))
    return 2;
  return 0;
}

// Shared bytes of a launch; ops/frontend.py::_smem_bytes mirrors it.
size_t smem_bytes(int np, int p, int q, int apad, int R, int G) {
  const int tm = 32 * R, lx = tm + apad, ph = row_len(lx, R);
  const int rs = tm - 1 + (tm - 1) / R + 1;
  const size_t rows = (size_t)np * p * ph, red = (size_t)np * G * q * rs;
  return sizeof(float) * ((size_t)q * p * apad + (rows > red ? rows : red));
}

template <bool MIX, int NP, int R>
int launch(const DecimArgs& a, int G, cudaStream_t stream) {
  const int M = a.n / a.p, tm = 32 * R;
  const int threads = 32 * G * a.q;
  // The multiply-shift divisions are exact below 2^31 / d.
  if (threads > kMaxThreads || a.apad % 8 ||
      (int64_t)(tm + a.apad + 8) * a.p * a.p >= (1LL << 31) ||
      (MIX && (int64_t)a.n * a.inner >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(NP, a.p, a.q, a.apad, R, G);
  cudaError_t err = cudaFuncSetAttribute(
      decimate_kernel<MIX, NP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = a.p * a.apad / R;
  const int L = (blocks + G - 1) / G * R;
  const int xmode = load_mode(a.x, NP, a.x_row, a.x_step, a.n);
  const int hmode = load_mode(a.h, NP, a.h_row, a.h_step, a.hist);
  // Oscillator B as float4 where no quad wraps it (inner % 4 == 0).
  int tmode = 0;
  if (MIX && a.inner % 4 == 0) {
    const float* const b2[2] = {a.tab[2], a.tab[3]};
    tmode = load_mode(b2, 2, 0, a.tab_step[1], a.inner);
  }
  const uint64_t mp = ((1ULL << 32) + a.p - 1) / a.p;
  const uint64_t mi = MIX ? ((1ULL << 32) + a.inner - 1) / a.inner : 0;
  dim3 grid((M + tm - 1) / tm, a.b);
  decimate_kernel<MIX, NP, R><<<grid, threads, smem, stream>>>(
      a, G, L, xmode, hmode, tmode, mp, mi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r: outputs per thread (4 or 8); g: tap groups.  The wrapper checks the shared-memory size of the launch
// (smem_bytes) before calling.
int rr_decimate(const DecimArgs* args, int r, int g, void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes == 1 && r == 4) return launch<false, 1, 4>(a, g, st);
  if (a.nplanes == 1 && r == 8) return launch<false, 1, 8>(a, g, st);
  if (a.nplanes == 2 && r == 4) return launch<false, 2, 4>(a, g, st);
  if (a.nplanes == 2 && r == 8) return launch<false, 2, 8>(a, g, st);
  return (int)cudaErrorInvalidValue;
}

// A wide plan (see the head of this file) in aligned mode: args->hist =
// Kw - p; wide the band taps and the launch's shape (wide_config).
int rr_decimate_wide(const DecimArgs* args, const WideArgs* wide,
                     void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes == 1)
    return launch_wide<1>(a, *wide, 0, nullptr, nullptr, st);
  if (a.nplanes == 2)
    return launch_wide<2>(a, *wide, 0, nullptr, nullptr, st);
  return (int)cudaErrorInvalidValue;
}

// Phase mode (see the head of this file) on the wide kernel: args->hist is
// Kw - 1, args->n the chunk; phase_in [b] int32 the grid phase (row 0
// places the windows), phase_out [b] int32 the next phase; the shape as
// for rr_decimate_wide with ceil(n / p) windows.
int rr_decimate_phase(const DecimArgs* args, const WideArgs* wide,
                      const int* phase_in, int* phase_out, void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes == 1)
    return launch_wide<1>(a, *wide, 1, phase_in, phase_out, st);
  if (a.nplanes == 2)
    return launch_wide<2>(a, *wide, 1, phase_in, phase_out, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef RR_DECIM_CLOCKS
// Development build only: wide launches from now on stamp their phases
// into clk (int64, kWideMarks a block, block (z-major) blockIdx.z, .y,
// .x); null stops it.
int rr_decim_clocks(long long* clk) {
  wide_clocks = clk;
  return 0;
}
#endif

int rr_mix_decimate(const DecimArgs* args, int r, int g, void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes != 2) return (int)cudaErrorInvalidValue;
  if (r == 4) return launch<true, 2, 4>(a, g, st);
  if (r == 8) return launch<true, 2, 8>(a, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
