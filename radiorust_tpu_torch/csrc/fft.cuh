// Complex float arithmetic and the small DFT butterflies shared by the
// overlap-save stages (overlap_save.cu) and the channelizer's 64-point
// transform (pfb_demod.cu).
#pragma once

#include <cuda_runtime.h>

namespace rr {

struct cf {
  float r, i;
};
__device__ __forceinline__ cf operator+(cf a, cf b) {
  return {a.r + b.r, a.i + b.i};
}
__device__ __forceinline__ cf operator-(cf a, cf b) {
  return {a.r - b.r, a.i - b.i};
}
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {fmaf(a.r, b.r, -a.i * b.i), fmaf(a.r, b.i, a.i * b.r)};
}
__device__ __forceinline__ cf scale(cf a, float s) {
  return {a.r * s, a.i * s};
}
// Root j of a table, conjugated for the inverse.
template <bool kInv>
__device__ __forceinline__ cf root(const float* wr, const float* wi, int j) {
  return {wr[j], kInv ? -wi[j] : wi[j]};
}
// x times the quarter root: -i forward, +i inverse.
template <bool kInv>
__device__ __forceinline__ cf quarter(cf x) {
  return kInv ? cf{-x.i, x.r} : cf{x.i, -x.r};
}

// DFT_p of a[0..p) in place, p in {2, 3, 4, 5, 8}; the inverse with the
// conjugate roots (unnormalised).
template <bool kInv>
__device__ __forceinline__ void dft4(cf& a0, cf& a1, cf& a2, cf& a3) {
  const cf t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3;
  const cf t3 = quarter<kInv>(a1 - a3);
  a0 = t0 + t2;
  a1 = t1 + t3;
  a2 = t0 - t2;
  a3 = t1 - t3;
}

template <int P, bool kInv>
__device__ __forceinline__ void butterfly(cf* a) {
  if constexpr (P == 2) {
    const cf t = a[0] - a[1];
    a[0] = a[0] + a[1];
    a[1] = t;
  } else if constexpr (P == 3) {
    const float s3 = 0.866025403784438646763723170752936183f;
    const cf t = a[1] + a[2];
    const cf u = a[0] - scale(t, 0.5f);
    const cf v = quarter<kInv>(scale(a[1] - a[2], s3));
    a[0] = a[0] + t;
    a[1] = u + v;
    a[2] = u - v;
  } else if constexpr (P == 4) {
    dft4<kInv>(a[0], a[1], a[2], a[3]);
  } else if constexpr (P == 5) {
    const float c1 = 0.309016994374947424102293417182819059f;
    const float c2 = -0.809016994374947424102293417182819059f;
    const float s1 = 0.951056516295153572116439333379382143f;
    const float s2 = 0.587785252292473129168705954639072769f;
    const cf t1 = a[1] + a[4], t2 = a[2] + a[3];
    const cf d1 = a[1] - a[4], d2 = a[2] - a[3];
    const cf u1 = a[0] + scale(t1, c1) + scale(t2, c2);
    const cf u2 = a[0] + scale(t1, c2) + scale(t2, c1);
    const cf v1 = quarter<kInv>(scale(d1, s1) + scale(d2, s2));
    const cf v2 = quarter<kInv>(scale(d1, s2) - scale(d2, s1));
    a[0] = a[0] + t1 + t2;
    a[1] = u1 + v1;
    a[4] = u1 - v1;
    a[2] = u2 + v2;
    a[3] = u2 - v2;
  } else {
    static_assert(P == 8, "specialised radices are 2, 3, 4, 5 and 8");
    const float h = 0.707106781186547524400844362104849039f;
    cf e[4] = {a[0], a[2], a[4], a[6]};
    cf o[4] = {a[1], a[3], a[5], a[7]};
    dft4<kInv>(e[0], e[1], e[2], e[3]);
    dft4<kInv>(o[0], o[1], o[2], o[3]);
    // o[r] times the eighth root to the r: (1 -+ i) h, -+i, (-1 -+ i) h.
    o[1] = kInv ? cf{h * (o[1].r - o[1].i), h * (o[1].r + o[1].i)}
                : cf{h * (o[1].r + o[1].i), h * (o[1].i - o[1].r)};
    o[2] = quarter<kInv>(o[2]);
    o[3] = kInv ? cf{-h * (o[3].r + o[3].i), h * (o[3].r - o[3].i)}
                : cf{h * (o[3].i - o[3].r), -h * (o[3].r + o[3].i)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = e[r] + o[r];
      a[r + 4] = e[r] - o[r];
    }
  }
}

}  // namespace rr
