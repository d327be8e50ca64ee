// Lattice and pair arithmetic shared by the pair kernels of pbf.cu and
// splat.cu. They walk the 27 neighbour cells of a dense cell grid and must
// decide the in-radius test d2 < h^2 exactly as their plain PyTorch versions
// do, so the shift and the squared norm live here once; so do the PBF pair
// terms, which the three generations of PBF kernels in pbf.cu (v3, v2, v1)
// share.
#pragma once

#include <cuda_runtime.h>

namespace fnx {

constexpr int MAX_M = 128;   // slots per cell row: at most four warps a block
constexpr int SELF_J = 13;   // the (0, 0, 0) neighbour offset

// The offset of neighbour j along one axis, times h (exactly -h, 0 or h);
// neighbour j sits at cell offset (j/9 - 1, (j/3)%3 - 1, j%3 - 1).
__device__ __forceinline__ float shift(int j, int axis, float h) {
  const int o = axis == 0 ? j / 9 : (axis == 1 ? (j / 3) % 3 : j % 3);
  return (float)(o - 1) * h;
}

// |d|^2 of a pair difference, each step rounded to nearest with no FMA.
__device__ __forceinline__ float norm2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Threads for a row of M slots: whole warps.
inline int threads_for(int M) { return (M + 31) / 32 * 32; }

// The solver constants of the PBF pair passes (sim/pbf_cuda.PairConsts).
struct PairConsts {
  float h, h2, eps, c6, s45, inv_p0, relax, k_p, e_p, inv_denom;
  int int_pow;  // e_p as a repeat count where it is a small positive integer, else 0
};

struct Pair {
  float d2, w, cg;
};

// The pair terms of fluidnexus_tpu/sim/pbf_pallas.py:_pair_wcg_cols for a
// centre slot and a shifted neighbour slot:
//   d2 = |x_i - x_s|^2 by direct subtraction, no FMA (so d2 <= h^2 is decided
//        bit for bit as the plain version decides it); 0 for the self pair;
//   w  = c6 (h^2 - d2)^3 where d2 < h^2;
//   inv = rsqrt(d2 + eps), rlen = (d2 + eps) inv,
//   cg = -s45 (h - rlen)^2 inv where rlen < h, 0 for the self pair.
__device__ __forceinline__ Pair pair_terms(float xc, float yc, float zc, float xs, float ys,
                                           float zs, bool self, const PairConsts& k) {
  Pair p;
  const float dx = __fsub_rn(xc, xs), dy = __fsub_rn(yc, ys), dz = __fsub_rn(zc, zs);
  p.d2 = self ? 0.0f : norm2_rn(dx, dy, dz);
  const float t2 = k.h2 - p.d2;
  p.w = p.d2 < k.h2 ? k.c6 * t2 * t2 * t2 : 0.0f;
  const float de = p.d2 + k.eps;
  const float inv = rsqrtf(de);
  const float rlen = de * inv;
  const float hr = k.h - rlen;
  p.cg = (rlen < k.h && !self) ? -k.s45 * hr * hr * inv : 0.0f;
  return p;
}

// Phase 2's terms of a pair with centre lambda lc and neighbour lambda ls:
//   corr = -k_p (w / w(dq))^e_p over non-self pairs (0 for the self pair),
//   b    = (lc + ls + corr) cg,
//   ns   = 1 for a non-self pair with d2 <= h^2.
struct Pair2 {
  float b, corr, ns;
};

__device__ __forceinline__ Pair2 phase2_terms(const Pair& p, bool self, float lc, float ls,
                                              const PairConsts& k) {
  Pair2 q;
  const float wd = (self ? 0.0f : p.w) * k.inv_denom;
  float pw;
  if (k.int_pow > 0) {
    pw = wd;
    for (int e = 1; e < k.int_pow; ++e) pw *= wd;
  } else {
    pw = powf(wd, k.e_p);
  }
  q.corr = -k.k_p * pw;
  q.b = (lc + ls + q.corr) * p.cg;
  q.ns = (p.d2 <= k.h2 && !self) ? 1.0f : 0.0f;
  return q;
}

}  // namespace fnx
