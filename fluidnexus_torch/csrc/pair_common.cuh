// Lattice and pair arithmetic shared by the pair kernels of pbf.cu and
// splat.cu. They walk the 27 neighbour cells of a dense cell grid and must
// decide the in-radius test d2 < h^2 exactly as their plain PyTorch versions
// do, so the shift and the squared norm live here once; so do the PBF pair
// terms, which the three generations of PBF kernels in pbf.cu (v3, v2, v1)
// share.
#pragma once

#include <cuda_runtime.h>

namespace fnx {

constexpr int MAX_M = 128;   // slots per cell row of a grid: at most four warps a block
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

// ---------------------------------------------------------------------------
// A centre row's neighbourhood, staged for a pair loop. A group of L lanes of
// one warp owns the centre row (8, 16 or 32 in the kernels that use it). The
// live slots of its 27 neighbour rows, in neighbour order and then slot
// order, form one list of n_tot entries: slot s of neighbour j is entry
// pre_j + s, pre_j the live slots of the neighbours before j. load_nbr_table
// reads the 27 neighbours' handles and then their counts and bases from a
// source (Src, below), each with every load of the group in flight at once
// (two round trips in all, not two for each neighbour; one where the handles
// need no load), and keeps bases, counts and list offsets in shared memory.
// stage_chunk copies the entries [c0, c0 + CH) into shared memory as float4
// (x + shift, y + shift, z + shift, w), w a fourth per-slot plane or 0
// (Extra), and where asked a second float4 list (v0, v1, v2, 0) of a
// per-slot 3-vector, entry by entry across the group's lanes with their loads
// in flight; the shift is added once (exact: 0 or +-h, as the per-neighbour
// staging of the other kernels adds it). Shifts and counts follow shift() and
// the front-compacted rows, so a pair loop over the list sees the pairs, in
// the order, of a walk over the 27 rows. Entries past the group's list, up to
// `fill`, hold far ones (FAR, w = 0, and a second list's entry 0): a pair
// with one is out of radius (its d2 overflows to inf, so h^2 - d2 is -inf),
// and a pair loop that selects its terms on d2 < h^2 (never multiplies one by
// a 0/1 factor) stays finite, so a warp can run one trip count for all its
// groups with no test of the list's end.
// ---------------------------------------------------------------------------
constexpr float FAR = 1e30f;
constexpr int GROUP_LANES = 16;                           // lanes that own a centre row
constexpr int GROUP_CPL = 32 / GROUP_LANES;               // centre slots a lane may hold: a pass covers 32
constexpr int GROUP_WARPS = 2;                            // warps a block
constexpr int GROUP_ROWS = GROUP_WARPS * 32 / GROUP_LANES;  // rows a block
static_assert(GROUP_LANES * GROUP_CPL == 32, "a pass covers 32 centre slots");

struct NbrTable {
  int nb[27];   // the neighbours' bases (Src::base of their handles)
  int n[27];    // their live slots, 0 where there is none
  int pre[27];  // their first entry in the list
};

// What stage_chunk stages beside the shifted coordinates: nothing (w = 0; no
// load spent on a plane the pair loop ignores), the fourth plane w, w and a
// second list of the per-slot 3-vector v3 ((C+1, M, 3), interleaved), or the
// second list alone (w = 0).
enum Extra { NO_W, W_PLANE, W_VEC3, VEC3 };
__host__ __device__ constexpr bool loads_w(Extra X) { return X == W_PLANE || X == W_VEC3; }
__host__ __device__ constexpr bool loads_vec3(Extra X) { return X == W_VEC3 || X == VEC3; }

// The sources a group's list is staged from. Each names neighbour j of a row
// by a handle, gives the live count behind it and the base that load reads
// its slot s at (the handle itself where that needs no load).
// PlaneSource, the default, is every kernel's but phases 1 and 2 v1's and
// the splat's query side: the handle is the neighbour's row, read from nbr
// (C where there is none), and slot s lies at h * M + s of the (C+1, M)
// planes x, y, z (w, v3 where the Extra loads them), whose counts are cnt.
struct PlaneSource {
  static constexpr bool GATHERED = false;
  const int* nbr;
  const int* cnt;
  const float *x, *y, *z, *w, *v3;
  int C, M;

  __device__ __forceinline__ int handle(int row, int j, bool active) const {
    return active ? nbr[(size_t)row * 27 + j] : C;
  }
  __device__ __forceinline__ int count(int h) const { return h < C ? cnt[h] : 0; }
  __device__ __forceinline__ int base(int h) const { return h; }
  __device__ __forceinline__ bool is_self(int h, int row) const { return h == row; }
  template <Extra X>
  __device__ __forceinline__ void load(int h, int s, float4& v, float4& u) const {
    const size_t at = (size_t)h * M + s;
    v = make_float4(x[at], y[at], z[at], loads_w(X) ? w[at] : 0.0f);
    if constexpr (loads_vec3(X)) u = make_float4(v3[3 * at], v3[3 * at + 1], v3[3 * at + 2], 0.0f);
  }
};

// GatheredSource, phases 1 and 2 v1's: the neighbour rows copied for each
// row before the launch (sim/pbf_cuda.gather_v1, as the JAX package's v1 tick
// gathers them): coordinates xng (C, 27, 3, M), a fourth plane lng (C, 27, M;
// phase 2's lambdas, null in phase 1) and counts ncnt (C, 27). The handle of
// neighbour j of row r is r * 27 + j, which needs no load, so the table takes
// one trip; rows C and past have none (-1).
// Neighbour 13 of a row is the row itself, whatever its copy holds.
struct GatheredSource {
  static constexpr bool GATHERED = true;
  const int* ncnt;
  const float *xng, *lng;
  int M;

  __device__ __forceinline__ int handle(int row, int j, bool active) const {
    return active ? row * 27 + j : -1;
  }
  __device__ __forceinline__ int count(int h) const { return h >= 0 ? ncnt[h] : 0; }
  __device__ __forceinline__ int base(int h) const { return h; }
  __device__ __forceinline__ bool is_self(int h, int) const { return h >= 0; }
  template <Extra X>
  __device__ __forceinline__ void load(int h, int s, float4& v, float4&) const {
    static_assert(!loads_vec3(X), "the gathered rows carry no 3-vector");
    const float* p = xng + (size_t)h * 3 * M + s;
    v = make_float4(p[0], p[M], p[2 * M], loads_w(X) ? lng[(size_t)h * M + s] : 0.0f);
  }
};

// ListSource, the splat's query side (ops/neighbors.QueryList): one list of
// points sorted by cell, row h's points at entries start[h] .. start[h] +
// cnt[h] - 1, any number of them. The handle is the neighbour's row, read
// from nbr (C where there is none), and its base its first entry, start[h],
// loaded beside its count, so a staged entry costs the (N,) planes' loads
// alone: x, y, z and, where the Extra loads them, w and v3 ((N, 3)).
struct ListSource {
  static constexpr bool GATHERED = false;
  const int* nbr;
  const int* start;
  const int* cnt;
  const float *x, *y, *z, *w, *v3;
  int C;

  __device__ __forceinline__ int handle(int row, int j, bool active) const {
    return active ? nbr[(size_t)row * 27 + j] : C;
  }
  __device__ __forceinline__ int count(int h) const { return h < C ? cnt[h] : 0; }
  __device__ __forceinline__ int base(int h) const { return h < C ? start[h] : 0; }
  template <Extra X>
  __device__ __forceinline__ void load(int b, int s, float4& v, float4& u) const {
    const size_t at = (size_t)b + s;
    v = make_float4(x[at], y[at], z[at], loads_w(X) ? w[at] : 0.0f);
    if constexpr (loads_vec3(X)) u = make_float4(v3[3 * at], v3[3 * at + 1], v3[3 * at + 2], 0.0f);
  }
};

// Fills tab for centre row `row` (no neighbour where !active) and returns n_tot
// to every lane of the group; sub is the lane's place in its group, and lane
// sub reads the neighbours sub * PER .. sub * PER + PER - 1, so a scan across
// the group gives each its list offset. Every lane of the warp calls it.
template <int L, class Src>
__device__ __forceinline__ int load_nbr_table(NbrTable& tab, const Src& src, int row, int sub,
                                              bool active) {
  constexpr int PER = (27 + L - 1) / L;
  int nb[PER], n[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = sub * PER + q;
    nb[q] = src.handle(row, j, active && j < 27);
  }
  int mine = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    n[q] = src.count(nb[q]);
    nb[q] = src.base(nb[q]);
    mine += n[q];
  }
  int incl = mine;  // inclusive scan over the group's lanes
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o, L);
    if (sub >= o) incl += t;
  }
  int pre = incl - mine;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = sub * PER + q;
    if (j < 27) {
      tab.nb[j] = nb[q];
      tab.n[j] = n[q];
      tab.pre[j] = pre;
    }
    pre += n[q];
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, incl, L - 1, L);
}

// Entries [c0, min(c0 + CH, n_tot)) of the group's list into dst (and dst2
// for W_VEC3 and VEC3), then far entries up to dst[fill - 1] (fill <= CH).
// Lane sub takes the entries c0 + sub + L m: for each it finds the neighbour
// j (the last whose pre_j <= e, a five-step search of the table), loads its
// slot's planes (slot e - pre_j at base nb_j) with every load of ROUND
// entries in flight, adds the shift
// and stores the float4s. Every lane of the warp calls it.
template <int L, int CH, int ROUND, Extra X = W_PLANE, class Src>
__device__ __forceinline__ void stage_chunk(float4* dst, const NbrTable& tab, int c0, int n_tot,
                                            int fill, const Src& src, float h, int sub,
                                            float4* dst2 = nullptr) {
  const int c1 = min(c0 + CH, n_tot);
  for (int e0 = c0 + sub; e0 < c0 + fill; e0 += L * ROUND) {
    float4 v[ROUND], u[ROUND];
    int jj[ROUND];
#pragma unroll
    for (int m = 0; m < ROUND; ++m) {
      const int e = e0 + L * m;
      jj[m] = -1;
      if (e < c1) {
        int j = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (j + step < 27 && tab.pre[j + step] <= e) j += step;
        src.template load<X>(tab.nb[j], e - tab.pre[j], v[m], u[m]);
        jj[m] = j;
      }
    }
#pragma unroll
    for (int m = 0; m < ROUND; ++m) {
      const int e = e0 + L * m;
      if (jj[m] >= 0) {
        dst[e - c0] = make_float4(__fadd_rn(v[m].x, shift(jj[m], 0, h)),
                                  __fadd_rn(v[m].y, shift(jj[m], 1, h)),
                                  __fadd_rn(v[m].z, shift(jj[m], 2, h)), v[m].w);
        if constexpr (loads_vec3(X)) dst2[e - c0] = u[m];
      } else if (e < c0 + fill) {
        dst[e - c0] = make_float4(FAR, FAR, FAR, 0.0f);
        if constexpr (loads_vec3(X)) dst2[e - c0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  __syncwarp();
}

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
