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
// Wide plans (rr_decimate_wide).  A plan whose q phases (one warp each)
// pass the block's 16 warps, or whose staged span and [q][p][apad] taps
// pass shared memory, is one of the other kind: a large p against few
// periods per chunk, each phase row holding one or two taps (48 kHz ->
// 44.1 kHz: p = 160, q = 147, Kw = 171, 10 periods a 1600-sample chunk;
// 1.024 MHz -> 44.1 kHz: p = 10240, q = 441, Kw = 10458, 2 periods).
// There the polyphase rows and the register window over periods share
// nothing, and each kernel row W[r] is the prototype filter shifted to
// its own offset: L = Kw - p + 1 nonzero taps of Kw (12 of 171, 219 of
// 10458).  So the wide kernel reads W in its own [q, Kw] layout through
// the L2, each row only over its band of nonzero taps [lo_r, hi_r) (from
// the wrapper, once per taps tensor), and loops the phases over its warps
// in rounds: block (tile of tm periods, stream, phase block of QB rows),
// 8 warps, warp w takes rows w, w + 8, ...  The block stages, per chunk
// of UC taps of its rows' joint band, the tm windows buf[(m0 + m) p + u]
// (both planes, complex64 read in place at element stride 2); the lanes
// of a warp split a row's band, feed each tap to every staged period (up
// to 8 in registers) and meet by shuffles; partial sums over the chunks
// collect in shared memory.  The last tile's first phase block copies the
// new history from the sources, bit for bit.
//
// Phase mode (rr_decimate_phase), a chunk of C samples that is not a whole
// number of periods.  The JAX package computes it with XLA's convolution
// on a slice at a traced offset (radiorust_tpu/ops/polyphase.py
// rational_fir_phase, no Pallas kernel); here it is the wide kernel with
// the offset read on the device.  The history is the last Kw - 1 samples,
// buf = [hist || x || zeros], and the step's grid phase ph = phase[0] (an
// int32 in device memory: a captured CUDA graph replays the step as the
// phase walks its schedule) puts window w at buf[p - 1 - ph + w p ..).
// E = ceil(C / p) windows are written; those from v = (ph + C) / p on are
// exact zeros (not yet complete this step).  The new history is buf[C,
// C + Kw - 1), which may reach back into the old history (a chunk shorter
// than the window), and the new phase (phase + C) mod p per stream.
// Bytes bound it as they bound the wide form (384 kHz -> 44.1 kHz at
// chunk 6144, 64 streams: 5.1 MB, 1.5 us; 0.05 GFLOP, 0.7 us); it is the
// wide form unchanged but for the offset, the zero reads and the masked
// windows, a simple first kernel whose time PERF.md records.

#include <cuda_runtime.h>
#include <stdint.h>

// Element (s, i) of a plane k lives at ptr[k][s * row + i * step] (floats).
struct DecimArgs {
  const float* x[2];
  int64_t x_row, x_step;
  const float* h[2];
  int64_t h_row, h_step;
  float* y[2];
  int64_t y_row, y_step;
  float* nh[2];
  int64_t nh_row, nh_step;
  const float* taps;     // [q][p][apad]
  const float* tab[4];   // mixer only: tables A re, A im, B re, B im
  int64_t tab_step[2];   // of A and of B
  const float* p0[2];    // mixer only: start phasor re, im
  int64_t p0_step;
  int32_t b, n, hist, p, q, apad, inner, nplanes;
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

// floor(x / d) for 0 <= x < 2^31 / d, with m = ceil(2^32 / d) from the
// host: x m / 2^32 is at most x (d - 1) / (d 2^32) < 1 / d above x / d.
__device__ __forceinline__ int divm(int x, uint64_t m) {
  return (int)(((uint64_t)x * m) >> 32);
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

// x * (A * B) * p0 in the TPU kernel's order of operations.  __fmul_rn /
// __fadd_rn: no FMA contraction, the rounding of the reference's separate
// multiplies and adds.
__device__ __forceinline__ void mix(float ar, float ai, float br, float bi,
                                    float pr, float pi, float& v0, float& v1) {
  const float oscr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  const float osci = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
  const float mr0 = __fsub_rn(__fmul_rn(v0, oscr), __fmul_rn(v1, osci));
  const float mi0 = __fadd_rn(__fmul_rn(v0, osci), __fmul_rn(v1, oscr));
  v0 = __fsub_rn(__fmul_rn(mr0, pr), __fmul_rn(mi0, pi));
  v1 = __fadd_rn(__fmul_rn(mr0, pi), __fmul_rn(mi0, pr));
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

template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
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

constexpr int kWideThreads = 256;   // 8 warps: rows in rounds of 8
constexpr int kWideOut = 8;         // periods a lane keeps in registers
constexpr int kWideStatic = 64;     // static shared bytes kept free

// grid (ceil(M / tm), batch, ceil(q / QB)), block kWideThreads.  Shared:
// S [NP][tm][UC] staged windows, then red [NP][QB][tm] partial sums.
// band [q][2]: row r's nonzero taps [lo, hi) (lo = Kw, hi = 0 for a zero
// row).  A.taps: W [q][Kw], row-major.  PHASE: phase mode (see the head of
// this file), A.hist = Kw - 1, M = ceil(n / p) windows from the offset
// p - 1 - phase_in[0]; else aligned, A.hist = Kw - p, M = n / p from 0.
template <int NP, bool PHASE>
__global__ void __launch_bounds__(kWideThreads) decimate_wide_kernel(
    DecimArgs A, const int* __restrict__ band, int tm, int QB, int UC,
    const int* __restrict__ phase_in, int* __restrict__ phase_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ulo_s, uhi_s;
  const int p = A.p, q = A.q, n = A.n, hist = A.hist;
  const int kw = PHASE ? hist + 1 : hist + p;
  const int M = PHASE ? (n + p - 1) / p : n / p, s = blockIdx.y;
  // Window m reads buf[start + m p + u]; windows from v on are not
  // complete.
  const int ph = PHASE ? __ldg(phase_in) : 0;
  const int64_t start = PHASE ? p - 1 - ph : 0;
  const int v = PHASE ? (ph + n) / p : M;
  const int m0 = blockIdx.x * tm, mt = min(tm, M - m0);
  const int r0 = blockIdx.z * QB, nr = min(QB, q - r0);
  float* S = smem;
  float* red = smem + NP * tm * UC;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  if (tid == 0) {
    ulo_s = kw;
    uhi_s = 0;
  }
  for (int i = tid; i < NP * QB * tm; i += nt) red[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < nr; i += nt) {
    atomicMin(&ulo_s, __ldg(band + 2 * (r0 + i)));
    atomicMax(&uhi_s, __ldg(band + 2 * (r0 + i) + 1));
  }
  __syncthreads();
  const int ulo = ulo_s, uhi = uhi_s;
  const float* h0 = A.h[0] + s * A.h_row;
  const float* h1 = NP == 2 ? A.h[1] + s * A.h_row : nullptr;
  const float* x0 = A.x[0] + s * A.x_row;
  const float* x1 = NP == 2 ? A.x[1] + s * A.x_row : nullptr;
  for (int U0 = ulo; U0 < uhi; U0 += UC) {
    const int uc = min(UC, uhi - U0);
    // S[pl][m][u - U0] = buf[start + (m0 + m) p + u]: inside [hist || x]
    // but for the incomplete windows of phase mode, which read zeros.
    for (int i = tid; i < mt * uc; i += nt) {
      const int m = i / uc, du = i - m * uc;
      const int64_t j = start + (int64_t)(m0 + m) * p + U0 + du;
      float v0 = 0.f, v1 = 0.f;
      if (j < hist) {
        v0 = __ldg(h0 + j * A.h_step);
        if (NP == 2) v1 = __ldg(h1 + j * A.h_step);
      } else if (!PHASE || j < (int64_t)hist + n) {
        v0 = __ldg(x0 + (j - hist) * A.x_step);
        if (NP == 2) v1 = __ldg(x1 + (j - hist) * A.x_step);
      }
      S[m * UC + du] = v0;
      if (NP == 2) S[(tm + m) * UC + du] = v1;
    }
    __syncthreads();
    for (int rr = warp; rr < nr; rr += nw) {
      const int r = r0 + rr;
      const int lo = max(__ldg(band + 2 * r), U0);
      const int hi = min(__ldg(band + 2 * r + 1), U0 + uc);
      if (lo >= hi) continue;   // warp-uniform
      const float* w = A.taps + (int64_t)r * kw;
      for (int mb = 0; mb < mt; mb += kWideOut) {
        float acc[NP][kWideOut];
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
          for (int j = 0; j < kWideOut; ++j) acc[pl][j] = 0.f;
        for (int u = lo + lane; u < hi; u += 32) {
          const float wu = __ldg(w + u);
          const float* sp = S + (u - U0) + mb * UC;
#pragma unroll
          for (int j = 0; j < kWideOut; ++j) {
            if (mb + j < mt) {
              acc[0][j] = fmaf(wu, sp[j * UC], acc[0][j]);
              if (NP == 2) acc[1][j] = fmaf(wu, sp[(tm + j) * UC], acc[1][j]);
            }
          }
        }
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
          for (int j = 0; j < kWideOut; ++j)
#pragma unroll
            for (int off = 16; off >= 1; off >>= 1)
              acc[pl][j] += __shfl_xor_sync(0xffffffffu, acc[pl][j], off);
        if (lane == 0) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl)
#pragma unroll
            for (int j = 0; j < kWideOut; ++j)
              if (mb + j < mt) red[(pl * QB + rr) * tm + mb + j] += acc[pl][j];
        }
      }
    }
    __syncthreads();   // the next chunk's staging overwrites S
  }
  float* y0 = A.y[0] + s * A.y_row;
  float* y1 = A.y[1] ? A.y[1] + s * A.y_row : nullptr;
  const bool pairs = y1 == y0 + 1 && A.y_step == 2;
  for (int i = tid; i < nr * mt; i += nt) {
    const int m = i / nr, rr = i - m * nr;
    const int64_t at = ((int64_t)(m0 + m) * q + r0 + rr) * A.y_step;
    const bool done = m0 + m < v;   // phase mode: later windows are zeros
    const float v0 = done ? red[rr * tm + m] : 0.f;
    const float v1 = NP == 2 && done ? red[(QB + rr) * tm + m] : 0.f;
    if (pairs) {
      *reinterpret_cast<float2*>(y0 + at) = make_float2(v0, v1);
    } else {
      y0[at] = v0;
      if (y1) y1[at] = v1;   // a real input's imaginary part is 0
    }
  }
  // New history buf[n, n + hist), copied from its sources.
  if (blockIdx.x == gridDim.x - 1 && blockIdx.z == 0) {
    float* nh0 = A.nh[0] + s * A.nh_row;
    float* nh1 = A.nh[1] ? A.nh[1] + s * A.nh_row : nullptr;
    for (int i = tid; i < hist; i += nt) {
      const int64_t j = (int64_t)n + i;
      float v0, v1 = 0.f;
      if (j < hist) {
        v0 = __ldg(h0 + j * A.h_step);
        if (NP == 2) v1 = __ldg(h1 + j * A.h_step);
      } else {
        v0 = __ldg(x0 + (j - hist) * A.x_step);
        if (NP == 2) v1 = __ldg(x1 + (j - hist) * A.x_step);
      }
      nh0[i * A.nh_step] = v0;
      if (nh1) nh1[i * A.nh_step] = v1;
    }
    if (PHASE && tid == 0) phase_out[s] = (phase_in[s] + n) % p;
  }
}

// Shared bytes of a wide launch; ops/frontend.py::wide_config mirrors it.
size_t wide_smem_bytes(int np, int tm, int qb, int uc) {
  return sizeof(float) * ((size_t)np * tm * uc + (size_t)np * qb * tm);
}

template <int NP, bool PHASE>
int launch_wide(const DecimArgs& a, const int* band, int tm, int qb, int uc,
                const int* phase_in, int* phase_out, cudaStream_t stream) {
  const int M = PHASE ? (a.n + a.p - 1) / a.p : a.n / a.p;
  if (tm < 1 || qb < 1 || uc < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (PHASE && (!phase_in || !phase_out || a.hist < 1))
    return (int)cudaErrorInvalidValue;
  // Dynamic and static shared memory together within 48 KB (no opt-in).
  const size_t smem = wide_smem_bytes(NP, tm, qb, uc);
  if (smem + kWideStatic > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((M + tm - 1) / tm, a.b, (a.q + qb - 1) / qb);
  decimate_wide_kernel<NP, PHASE><<<grid, kWideThreads, smem, stream>>>(
      a, band, tm, qb, uc, phase_in, phase_out);
  return (int)cudaGetLastError();
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

// A wide plan (see the head of this file): args->taps is W [q][Kw]
// row-major, band [q][2] each row's nonzero taps; tm periods a tile, qb
// phases a block, uc staged taps a chunk (shared bytes wide_smem_bytes,
// at most 48 KB).
int rr_decimate_wide(const DecimArgs* args, const int* band, int tm, int qb,
                     int uc, void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes == 1)
    return launch_wide<1, false>(a, band, tm, qb, uc, nullptr, nullptr, st);
  if (a.nplanes == 2)
    return launch_wide<2, false>(a, band, tm, qb, uc, nullptr, nullptr, st);
  return (int)cudaErrorInvalidValue;
}

// Phase mode (see the head of this file) on the wide kernel: args->hist is
// Kw - 1, args->n the chunk; phase_in [b] int32 the grid phase (row 0
// places the windows), phase_out [b] int32 the next phase; tm, qb, uc as
// for rr_decimate_wide with ceil(n / p) windows in place of n / p periods.
int rr_decimate_phase(const DecimArgs* args, const int* band,
                      const int* phase_in, int* phase_out, int tm, int qb,
                      int uc, void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes == 1)
    return launch_wide<1, true>(a, band, tm, qb, uc, phase_in, phase_out, st);
  if (a.nplanes == 2)
    return launch_wide<2, true>(a, band, tm, qb, uc, phase_in, phase_out, st);
  return (int)cudaErrorInvalidValue;
}

int rr_mix_decimate(const DecimArgs* args, int r, int g, void* stream) {
  const DecimArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.nplanes != 2) return (int)cudaErrorInvalidValue;
  if (r == 4) return launch<true, 2, 4>(a, g, st);
  if (r == 8) return launch<true, 2, 8>(a, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
