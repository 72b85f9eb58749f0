// What the decimation kernels share: the arguments of every entry of #1
// and #2 (DecimArgs, mirrored by ops/frontend.py _Args), the wide
// blocks' limits, the multiply-shift division, the mixer's rounded
// arithmetic, the cp.async copies, a source row of buf = [hist || x] and
// the wide forms' bands: their size, their staging and the FMA sums over
// them.  Included by decimate.cu (#1's forms, #2's polyphase form) and
// mix_decimate_wide.cu (#2's wide form).

#pragma once

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

constexpr int kWideThreads = 256;   // the most threads of a wide block
constexpr int kWideNW = 8;          // the most windows a thread keeps
constexpr size_t kSmemMax = 232448; // 227 KB, a block's most on an H100

// floor(x / d) for 0 <= x < 2^31 / d, with m = ceil(2^32 / d) from the
// host: x m / 2^32 is at most x (d - 1) / (d 2^32) < 1 / d above x / d.
__device__ __forceinline__ int divm(int x, uint64_t m) {
  return (int)(((uint64_t)x * m) >> 32);
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

template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// One source of buf (the history or the chunk) of one stream: plane k
// of element e at p[k][e * step]; pairs: a complex64 row read in place.
struct Row {
  const float* p0;
  const float* p1;
  int64_t step;
  bool pairs;
};

// Floats of a wide block's taps: un bands of ls, shifted by up to 3 to
// the source's 16-byte phase, rounded up to a 16-byte boundary.
__host__ __device__ __forceinline__ int wide_tap_floats(int un, int ls) {
  return (un * ls + 3 + 3) & ~3;
}

// The bands [u0, u0 + un) of ls taps each from taps to shared memory at
// base, at the source's 16-byte phase: 16 bytes a copy.  Returns where
// band u0 lands (base plus 0 to 3 floats).
__device__ __forceinline__ float* stage_bands(float* base, const float* taps,
                                              int u0, int un, int ls, int tid,
                                              int nt) {
  const int64_t t0 = (int64_t)u0 * ls;
  const int ta = (int)(t0 & 3);
  float* T = base + ta;
  const float* src = taps + t0;
  const int count = un * ls;
  const int head = min((4 - ta) & 3, count), nv = (count - head) >> 2;
  for (int i = tid; i < head; i += nt) cp_async4(T + i, src + i);
  for (int i = tid; i < nv; i += nt)
    cp_async16(T + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * nv + tid; i < count; i += nt)
    cp_async4(T + i, src + i);
  return T;
}

// The wide forms' FMA sums over the bands (#1's wide form, #2's on its
// FMA route; W a WideArgs or a MixWideArgs): lane g of a group of W.g,
// phase r = r0 + rr, windows k = ws + j W.ws (j < NW in registers) of the
// tile's mt.  Window k reads X[k xs + lo_r - ulo + u] (NP floats a
// position) against row r's band T[(band - u0) W.ls + u].  The
// constructor leaves each lane's partial sums in acc, reduce() sums each
// group's across its lanes, store() writes them from lane 0.
template <int NP, int NW>
struct BandSums {
  int g, r, ws, wstep;
  bool live;
  float acc[NW][NP];

  template <class WA>
  __device__ __forceinline__ BandSums(const WA& W, const float* X,
                                      const float* T, int r0, int nr, int ulo,
                                      int u0, int mt, int xs) {
    const int tid = threadIdx.x, G = W.g;
    g = tid % G;
    const int rr = (tid / G) % W.nr;
    ws = tid / (G * W.nr);
    wstep = W.ws;
    r = r0 + rr;
    live = rr < nr && ws < W.ws && ws < mt;
    int off = 0, len = 0, band = u0;
    if (live) {
      off = __ldg(W.rows + 3 * r) - ulo;
      len = __ldg(W.rows + 3 * r + 1);
      band = __ldg(W.rows + 3 * r + 2);
    }
    int xo[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      xo[j] = min(ws + j * W.ws, mt - 1) * xs + off;
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) acc[j][pl] = 0.f;
    const float* tr = T + (band - u0) * W.ls;
#pragma unroll 4
    for (int u = g; u < len; u += G) {
      const float w = tr[u];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (NP == 2) {
          const float2 xv = reinterpret_cast<const float2*>(X)[xo[j] + u];
          acc[j][0] = fmaf(w, xv.x, acc[j][0]);
          acc[j][1] = fmaf(w, xv.y, acc[j][1]);
        } else {
          acc[j][0] = fmaf(w, X[xo[j] + u], acc[j][0]);
        }
      }
    }
  }

  // Each lane group of G: every lane ends with the group's sums.
  __device__ __forceinline__ void reduce(int G) {
    for (int o = G >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
          acc[j][pl] += __shfl_xor_sync(0xffffffffu, acc[j][pl], o);
  }

  // Window m = m0 + k to y[m q + r] (zeros from window v on: phase mode);
  // y1 null: the first plane only.
  __device__ __forceinline__ void store(float* y0, float* y1, int64_t y_step,
                                        int m0, int mt, int q, int v) const {
    const bool pairs = y1 == y0 + 1 && y_step == 2;
    if (live && g == 0) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int k = ws + j * wstep;
        if (k < mt) {
          const int m = m0 + k;
          const bool done = m < v;
          const float v0 = done ? acc[j][0] : 0.f;
          const float v1 = NP == 2 && done ? acc[j][NP - 1] : 0.f;
          const int64_t at = ((int64_t)m * q + r) * y_step;
          if (pairs) {
            *reinterpret_cast<float2*>(y0 + at) = make_float2(v0, v1);
          } else {
            y0[at] = v0;
            if (y1) y1[at] = v1;   // a real input's imaginary part is 0
          }
        }
      }
    }
  }
};

}  // namespace
