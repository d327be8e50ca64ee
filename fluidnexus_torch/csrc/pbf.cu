// Position-based-fluid density kernels for Hopper (sm_90a): the two pair
// passes of one Jacobi projection over the dense cell grid, in the three
// generations of the JAX package (v3 in the grid-reuse tick, v2 in the
// per-iteration rebuild, v1 behind its backend switch), and the gas loss's
// density and its adjoint. Plain C interface, loaded with ctypes by
// fluidnexus_torch/sim/pbf_cuda.py, which also holds each kernel's plain
// PyTorch version.
//
// Layout shared by the kernels (fluidnexus_torch/ops/neighbors.DenseGrid):
//   C compacted cell rows and the empty row C, M <= MAX_M slots per row;
//   x, y, z (C+1, M) f32: cell-relative slot coordinates, one plane per axis;
//   cnt (C+1,) i32: live slots per row, front-compacted (slot s of a row is
//     live iff s < cnt[row]); cnt[C] = 0;
//   nbr (C, 27) i32: the row of each of the 27 neighbour cells, C where there
//     is none; neighbour j sits at cell offset (j/9 - 1, (j/3)%3 - 1, j%3 - 1).
//   Every per-slot input and output is a (C+1, M) plane, or (C+1, M, 3) for a
//   vector.
// The v1 kernels read their neighbour rows from tensors gathered before the
// launch (sim/pbf_cuda.gather_v1): xng (C, 27, 3, M) the neighbour rows'
// coordinates, lng (C, 27, M) their lambdas, ncnt (C, 27) their live counts.
// Every kernel gives a row to a group of lanes over one staged neighbourhood
// list (the row groups, below); phases 1 and 2 v1 stage their lists from the
// gathered rows (pair_common.cuh's GatheredSource), the others from the
// planes through nbr. Phase 1 v1 keeps, as a checking mode of its entry, the
// one-block-a-row walk it had before (phase1_walk_kernel: one block per row,
// one thread per centre slot), whose sums in its order every row group's
// phase 1 must keep bit for bit. Dead slots and rows are masked by the
// counts, so no sentinel coordinates are needed. The pair terms are fnx::pair_terms and
// fnx::phase2_terms (pair_common.cuh), the same device functions in every
// generation.


#include <cuda_runtime.h>

#include <initializer_list>
#include <type_traits>

#include "pair_common.cuh"

namespace {

using fnx::MAX_M;
using fnx::norm2_rn;
using fnx::Pair;
using fnx::Pair2;
using fnx::PairConsts;
using fnx::shift;
using fnx::pair_terms;
using fnx::phase2_terms;
using fnx::threads_for;

constexpr unsigned FULL_MASK = 0xffffffffu;

// ---------------------------------------------------------------------------
// Where a block finds the neighbour rows of its cell. A Row gives the live
// count, the unshifted coordinate rows and the lambda row of neighbour j.
// ---------------------------------------------------------------------------
struct Row {
  int n;
  const float *x, *y, *z, *lam;
  bool self_row;  // the centre cell itself
};

// The walk's rows: the pre-gathered ones. Offset 13 of an occupied cell is the
// cell.
struct GatheredRows {
  const int* ncnt;
  const float* xng;
  const float* lng;
  int M;

  __device__ __forceinline__ Row open(int cell, int j) const {
    const size_t r = (size_t)cell * 27 + j;
    const float* base = xng + r * 3 * M;
    return Row{ncnt[r], base, base + M, base + 2 * M, lng ? lng + r * M : nullptr,
               j == fnx::SELF_J};
  }
};

// Stages neighbour j's live slots, shifted by its offset, in shared memory
// (one coalesced read per row instead of one per centre slot); the lambda row
// too where the pass needs it. Returns the row's live count; 0 (the same for
// the whole block) where there is nothing to walk.
template <class Rows>
__device__ __forceinline__ Row stage(const Rows& rows, int cell, int j, int i, float h, float* sx,
                                     float* sy, float* sz, float* sl) {
  const Row r = rows.open(cell, j);
  if (r.n == 0) return r;
  __syncthreads();  // the previous row is consumed
  if (i < r.n) {
    sx[i] = __fadd_rn(r.x[i], shift(j, 0, h));
    sy[i] = __fadd_rn(r.y[i], shift(j, 1, h));
    sz[i] = __fadd_rn(r.z[i], shift(j, 2, h));
    if (sl) sl[i] = r.lam[i];
  }
  __syncthreads();
  return r;
}

// Phase 1's sums for one centre slot over every live slot of its 27
// neighbour rows: the raw poly6 sum (self included), the spiky sums
// sum cg, sum cg^2 d2, sum cg x_s and the in-radius count (self included).
struct Sums1 {
  float wa, cga, c2a, nla, bx, by, bz;
};

template <class Rows>
__device__ __forceinline__ Sums1 phase1_walk(const Rows& rows, int cell, int i, bool live, float xc,
                                             float yc, float zc, const PairConsts& k, float* sx,
                                             float* sy, float* sz) {
  Sums1 a{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < 27; ++j) {
    const Row r = stage(rows, cell, j, i, k.h, sx, sy, sz, nullptr);
    if (r.n == 0 || !live) continue;
    for (int s = 0; s < r.n; ++s) {
      const Pair p = pair_terms(xc, yc, zc, sx[s], sy[s], sz[s], r.self_row && s == i, k);
      a.wa += p.w;
      a.cga += p.cg;
      a.c2a += p.cg * p.cg * p.d2;
      a.nla += p.d2 <= k.h2 ? 1.0f : 0.0f;
      a.bx += p.cg * sx[s];
      a.by += p.cg * sy[s];
      a.bz += p.cg * sz[s];
    }
  }
  return a;
}
// ---------------------------------------------------------------------------
// Phase 1 v1's checking mode (fnx_pbf_phase1_v1 with walk = 1): the raw sums
// of phase 1 v1 (below) by the one-block-a-row walk, each neighbour row
// staged in shared memory in turn (stage), one thread a centre slot
// (phase1_walk), the self pair taken by index. It adds each slot's terms in
// the order the row groups keep, so every row group's phase 1 must match it
// bit for bit; it is the one order that shows a self pair taken by d2 = 0
// (phase 1's outputs see that only through their rounding). No stage runs
// it. A row's live count is its own copy's, ncnt[row, 13]; row C has none
// and walks nothing. Dead slots and empty rows write 0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) phase1_walk_kernel(
    const int* __restrict__ ncnt, const float* __restrict__ xng, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, float* __restrict__ pi_raw,
    float* __restrict__ sg, float* __restrict__ c2d2, float* __restrict__ nlen, int C, int M,
    PairConsts k) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M];
  const GatheredRows rows{ncnt, xng, nullptr, M};
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cell < C ? ncnt[(size_t)cell * 27 + fnx::SELF_J] : 0;
  const bool live = i < n_c;
  const float xc = live ? x[at] : 0.0f, yc = live ? y[at] : 0.0f, zc = live ? z[at] : 0.0f;
  Sums1 a{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (n_c > 0) a = phase1_walk(rows, cell, i, live, xc, yc, zc, k, sx, sy, sz);
  if (i >= M) return;
  pi_raw[at] = live ? a.wa : 0.0f;
  sg[3 * at] = live ? a.cga * xc - a.bx : 0.0f;
  sg[3 * at + 1] = live ? a.cga * yc - a.by : 0.0f;
  sg[3 * at + 2] = live ? a.cga * zc - a.bz : 0.0f;
  c2d2[at] = live ? a.c2a : 0.0f;
  nlen[at] = live ? a.nla : 0.0f;
}


// ---------------------------------------------------------------------------
// The gas loss's density and its adjoint, and every PBF pass: pair walks
// over a grid's 27 neighbours, at ~7-9 live slots a row on their
// main paths. A walk of one block per row that waits on each neighbour's id,
// count and slots in turn is bound by those ~80 dependent trips to memory,
// not by its operations, and a lane per centre slot leaves most of a warp
// idle. These kernels take one design instead: a group of lanes owns a row
// (in the density and its adjoint GROUP_LANES = 16, two rows a warp; in the
// PBF passes 8 or 16, below), so a row's few live slots fill its group; the
// group reads the 27 neighbours' handles and counts in at most two trips
// (load_nbr_table) and stages the row's whole neighbourhood as one list of
// shifted coordinates, many entries a lane with their loads in flight
// (stage_chunk, in chunks, which also bounds it at M = MAX_M); then the pair
// loop runs over the list with no barrier and no branch: a pair out of
// radius, or with a far entry past the list, adds nothing, which leaves the
// sums' bits as they are, so the compiler can overlap the iterations. A lane
// holds one centre slot, or more where a row of the warp has more live slots
// than its group has lanes; a row of more than a pass covers takes more
// passes. Each slot's sum runs in neighbour order, then slot order, with the
// arithmetic of a walk over the rows, so it adds the same terms in the same
// order.
// ---------------------------------------------------------------------------
using fnx::GROUP_CPL;
using fnx::GROUP_LANES;
using fnx::GROUP_ROWS;
using fnx::GROUP_WARPS;
constexpr int DENS_CHUNK = 384;  // list entries a row stages at once
constexpr int DENS_ROUND = 16;   // entries a lane stages with its loads in flight (the adjoint)
// the density stages a whole chunk in one round of loads: with three planes
// an entry the registers allow it, and a list of up to DENS_CHUNK entries
// (~270 at most on the main path) then costs one trip, not two
constexpr int DENS_FWD_ROUND = DENS_CHUNK / GROUP_LANES;

size_t density_smem() { return (size_t)GROUP_ROWS * DENS_CHUNK * sizeof(float4); }

// ---------------------------------------------------------------------------
// Gas-loss density. Replaces the Pallas kernel
// fluidnexus_tpu/sim/pbf_pallas.py:_density_kernel_v2 (wrapper
// density_slots_v2). Per live slot: pi = sum over every live slot s of the 27
// neighbour cells, itself included, of c6 (h^2 - d2)^3 where d2 < h^2; the
// self pair has d2 = 0 and adds c6 h^6. Dead slots and row C write 0.
//
// Bound on the H100: 9 f32 operations per live candidate pair (the shifted
// difference, d2 and the test) and 5 more per pair in radius, against one
// read of three coordinate planes and one written plane: bound by operations,
// and in practice by the latency of the walk (the design above). Points of
// this kernel:
// - The list carries three planes: stage_chunk's NO_W form loads no fourth
//   plane (staging x again as one would cost a load a staged entry, an L1 hit,
//   for nothing) and leaves the float4's w at 0; the entry stays one 16-byte
//   shared load in the pair loop.
// - The self pair needs no test: its entry is neighbour 13's own slot with
//   shift 0, so each difference is x - x = 0 exactly and d2 = 0.
// - d2 is formed without FMA, as in phases 1 and 2, so the kernel and its
//   plain version take the same pairs; the power is c6 t2 t2 times t2 added
//   by one FMA, as the walk over rows compiled `pi += c6 t2 t2 t2` (nvcc
//   contracts the last product into the sum), and the select keeps the sum
//   where d2 >= h^2 (a far entry's t2 is -inf, so its terms must never reach
//   the sum, not even times 0).
// ---------------------------------------------------------------------------
template <int NC>
__device__ __forceinline__ void density_sweep(const float4* list, int kn, const float (&xc)[GROUP_CPL],
                                              const float (&yc)[GROUP_CPL],
                                              const float (&zc)[GROUP_CPL], float (&wa)[GROUP_CPL],
                                              float h2, float c6) {
#pragma unroll 16
  for (int k = 0; k < kn; ++k) {
    const float4 s = list[k];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float d2 = norm2_rn(__fsub_rn(xc[c], s.x), __fsub_rn(yc[c], s.y), __fsub_rn(zc[c], s.z));
      const float t2 = h2 - d2;
      wa[c] = d2 < h2 ? fmaf(c6 * t2 * t2, t2, wa[c]) : wa[c];
    }
  }
}

__global__ void __launch_bounds__(GROUP_WARPS * 32) density_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, float* __restrict__ pi, int C, int M,
    float h, float h2, float c6) {
  extern __shared__ float4 dens_lists[];  // [GROUP_ROWS][DENS_CHUNK]
  __shared__ fnx::NbrTable tabs[GROUP_ROWS];
  const int grp = threadIdx.x / GROUP_LANES;
  const int sub = threadIdx.x % GROUP_LANES;
  const int row = blockIdx.x * GROUP_ROWS + grp;
  float4* list = dens_lists + grp * DENS_CHUNK;
  const fnx::PlaneSource src{nbr, cnt, x, y, z, nullptr, nullptr, C, M};
  const int n_c = row <= C ? cnt[row] : 0;
  const int n_tot = fnx::load_nbr_table<GROUP_LANES>(tabs[grp], src, row, sub, row < C);
  if (row <= C)
    for (int i = n_c + sub; i < M; i += GROUP_LANES) pi[(size_t)row * M + i] = 0.0f;  // dead slots
  const int passes = __reduce_max_sync(FULL_MASK, (unsigned)(n_c + 31) / 32);
  const int list_max = __reduce_max_sync(FULL_MASK, n_c > 0 ? (unsigned)n_tot : 0u);
  for (int pass = 0; pass < passes; ++pass) {
    const int left = n_c - pass * 32;  // this row's live centre slots from the pass on
    // centre slots a lane of the warp holds in this pass, at most
    const int cpl = __reduce_max_sync(FULL_MASK, left > GROUP_LANES ? (unsigned)GROUP_CPL : 1u);
    bool live[GROUP_CPL];
    float xc[GROUP_CPL], yc[GROUP_CPL], zc[GROUP_CPL], wa[GROUP_CPL];
#pragma unroll
    for (int c = 0; c < GROUP_CPL; ++c) {
      const int i = sub + c * GROUP_LANES;
      const size_t at = (size_t)row * M + pass * 32 + i;
      live[c] = i < left;
      xc[c] = live[c] ? x[at] : 0.0f;
      yc[c] = live[c] ? y[at] : 0.0f;
      zc[c] = live[c] ? z[at] : 0.0f;
      wa[c] = 0.0f;
    }
    for (int c0 = 0; c0 < list_max; c0 += DENS_CHUNK) {
      const int kn = min(DENS_CHUNK, list_max - c0);  // the warp's trip count
      fnx::stage_chunk<GROUP_LANES, DENS_CHUNK, DENS_FWD_ROUND, fnx::NO_W>(
          list, tabs[grp], c0, left > 0 ? n_tot : 0, kn, src, h, sub);
      if (cpl == 1)
        density_sweep<1>(list, kn, xc, yc, zc, wa, h2, c6);
      else
        density_sweep<GROUP_CPL>(list, kn, xc, yc, zc, wa, h2, c6);
      __syncwarp();  // the chunk is consumed before the next one is staged
    }
#pragma unroll
    for (int c = 0; c < GROUP_CPL; ++c)
      if (live[c]) pi[(size_t)row * M + pass * 32 + sub + c * GROUP_LANES] = wa[c];
  }
}

// ---------------------------------------------------------------------------
// Adjoint of the gas-loss density. Replaces the Pallas kernel
// fluidnexus_tpu/sim/pbf_pallas.py:_density_bwd_kernel_v2 (wrapper
// density_bwd_slots_v2). With g the cotangent of pi per slot:
//   dL/dx_i = sum_s (g_i + g_s) W'(d2) 2 (x_i - x_s),  W'(d2) = -3 c6 (h^2 - d2)^2
// over the pairs in radius; the symmetric (g_i + g_s) folds the s -> i
// contributions into the one pass. Each pair adds b (x_i - x_s) directly
// (the Pallas kernel forms (sum b) x_i - sum b x_s), so the self pair adds
// exactly 0. g is read at live slots only. dx is (C+1, M, 3); dead slots and
// row C write 0.
//
// Bound on the H100: 9 f32 operations per live candidate pair and 12 more per
// pair in radius, against one read of four planes and one write of three:
// bound by operations, and in practice by the latency of the walk. The list
// carries g as its fourth plane.
// ---------------------------------------------------------------------------

// The pair loop over kn staged entries for the first NC centre slots a lane
// holds: no branch, so the compiler can overlap the iterations. b = 0 (out
// of radius, a far entry, a dead centre's garbage never written) adds
// 0 * e, which leaves a sum's bits as they are; 2 c3 folds the pair's
// factor 2 in exactly (a power of two).
template <int NC>
__device__ __forceinline__ void dbw_sweep(const float4* list, int kn, const float (&xc)[GROUP_CPL],
                                          const float (&yc)[GROUP_CPL], const float (&zc)[GROUP_CPL],
                                          const float (&gc)[GROUP_CPL], float (&a0)[GROUP_CPL],
                                          float (&a1)[GROUP_CPL], float (&a2)[GROUP_CPL], float h2,
                                          float c3x2) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 s = list[k];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float ex = __fsub_rn(xc[c], s.x), ey = __fsub_rn(yc[c], s.y), ez = __fsub_rn(zc[c], s.z);
      const float d2 = norm2_rn(ex, ey, ez);
      const float t2 = h2 - d2;
      const float b = d2 < h2 ? (gc[c] + s.w) * (c3x2 * t2 * t2) : 0.0f;
      a0[c] += b * ex;
      a1[c] += b * ey;
      a2[c] += b * ez;
    }
  }
}

__global__ void __launch_bounds__(GROUP_WARPS * 32) density_bwd_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ g,
    float* __restrict__ dx, int C, int M, float h, float h2, float c6) {
  extern __shared__ float4 dens_lists[];  // [GROUP_ROWS][DENS_CHUNK]
  __shared__ fnx::NbrTable tabs[GROUP_ROWS];
  const int grp = threadIdx.x / GROUP_LANES;
  const int sub = threadIdx.x % GROUP_LANES;
  const int row = blockIdx.x * GROUP_ROWS + grp;
  float4* list = dens_lists + grp * DENS_CHUNK;
  // the table does not wait on the row's own count: an empty row's list is
  // read and never used
  const fnx::PlaneSource src{nbr, cnt, x, y, z, g, nullptr, C, M};
  const int n_c = row <= C ? cnt[row] : 0;
  const int n_tot = fnx::load_nbr_table<GROUP_LANES>(tabs[grp], src, row, sub, row < C);
  if (row <= C) {
    for (int i = n_c + sub; i < M; i += GROUP_LANES) {  // dead slots
      const size_t at = (size_t)row * M + i;
      dx[3 * at] = 0.0f;
      dx[3 * at + 1] = 0.0f;
      dx[3 * at + 2] = 0.0f;
    }
  }
  const int passes = __reduce_max_sync(FULL_MASK, (unsigned)(n_c + 31) / 32);
  const int list_max = __reduce_max_sync(FULL_MASK, n_c > 0 ? (unsigned)n_tot : 0u);
  const float c3x2 = 2.0f * (-3.0f * c6);
  for (int pass = 0; pass < passes; ++pass) {
    const int left = n_c - pass * 32;  // this row's live centre slots from the pass on
    // centre slots a lane of the warp holds in this pass, at most
    const int cpl = __reduce_max_sync(FULL_MASK, left > GROUP_LANES ? (unsigned)GROUP_CPL : 1u);
    bool live[GROUP_CPL];
    float xc[GROUP_CPL], yc[GROUP_CPL], zc[GROUP_CPL], gc[GROUP_CPL];
    float a0[GROUP_CPL], a1[GROUP_CPL], a2[GROUP_CPL];
#pragma unroll
    for (int c = 0; c < GROUP_CPL; ++c) {
      const int i = sub + c * GROUP_LANES;
      const size_t at = (size_t)row * M + pass * 32 + i;
      live[c] = i < left;
      xc[c] = live[c] ? x[at] : 0.0f;
      yc[c] = live[c] ? y[at] : 0.0f;
      zc[c] = live[c] ? z[at] : 0.0f;
      gc[c] = live[c] ? g[at] : 0.0f;
      a0[c] = a1[c] = a2[c] = 0.0f;
    }
    for (int c0 = 0; c0 < list_max; c0 += DENS_CHUNK) {
      const int kn = min(DENS_CHUNK, list_max - c0);  // the warp's trip count
      fnx::stage_chunk<GROUP_LANES, DENS_CHUNK, DENS_ROUND>(list, tabs[grp], c0, left > 0 ? n_tot : 0,
                                                            kn, src, h, sub);
      if (cpl == 1)
        dbw_sweep<1>(list, kn, xc, yc, zc, gc, a0, a1, a2, h2, c3x2);
      else
        dbw_sweep<GROUP_CPL>(list, kn, xc, yc, zc, gc, a0, a1, a2, h2, c3x2);
      __syncwarp();  // the chunk is consumed before the next one is staged
    }
#pragma unroll
    for (int c = 0; c < GROUP_CPL; ++c) {
      if (!live[c]) continue;
      const size_t at = (size_t)row * M + pass * 32 + sub + c * GROUP_LANES;
      dx[3 * at] = a0[c];
      dx[3 * at + 1] = a1[c];
      dx[3 * at + 2] = a2[c];
    }
  }
}

// ---------------------------------------------------------------------------
// The PBF passes on row groups: phases 1 and 2 of the grid-reuse tick (v3),
// of the per-iteration rebuild (v2) and of the v1 projection, the design
// above with these points in common:
// - A group of L lanes owns a row, 64 / L rows a block, and a lane holds up
//   to CPL centre slots, so a pass covers L * CPL slots and a row of more
//   takes passes. Each kernel name has its own (L, CPL), fixed at compile
//   time: phases 1 and 2 v3 and phase 2 (v2, v1) take (8, 2) (ROW_LANES,
//   ROW_CPL), for the hidden grid's rows of ~7 live slots (at most 8 on phase
//   B's first tick; 16-lane groups read 0.0316 ms against 0.0237 for phase 2
//   v3 on the H100), and phase 2's partial sums need that tree. Phases 1 v2
//   and v1 run on the rigid tick's rebuilt grid, whose rows hold 8.7 live
//   slots on average and up to 20: they take (P1V2_LANES, P1V2_CPL) (below).
// - Within a pass, a warp's lanes hold one centre slot, or CPL where a row of
//   the warp has more live slots than its group has lanes (pass_cpl).
// - The pair loops call pair_terms (and phase2_terms) unchanged, and each sum
//   adds what a one-block-a-row walk over the rows (phase1_walk_kernel, and
//   phase 2's walk, which these kernels replaced) added, in its order, so
//   every slot keeps that walk's bits.
// - The self pair is found by index, never by d2 = 0: the centre's own entry
//   is neighbour 13's (the row itself: the planes' nbr names the row, and a
//   gathered row's neighbour 13 is its own copy) at its slot, pre[13] + slot.
//   Two live particles at the same coordinates in one row are a non-self
//   pair with d2 = 0 and cg != 0.
// - A dead centre slot's registers hold 0, a point inside the cell, so it
//   pairs with real entries: nothing of its sums is written or summed.
// - Empty rows and row C are written by 16-byte stores where the entry finds
//   M % 4 == 0 and every plane aligned.
// ---------------------------------------------------------------------------
constexpr int ROW_LANES = 8;  // lanes that own a row (phases 1 and 2 v3, phase 2 v2 and v1)
constexpr int ROW_CPL = 2;    // centre slots a lane may hold there: a pass covers 16

// A group's row, its place in the group, the row's live slots and list
// length, the warp's passes and longest list, and the list entry of slot 0's
// self pair. The row's live count comes from cnt, or, for the gathered rows,
// from its own copy, neighbour 13 (so row C, which has no copies, reads
// none). Every lane of the warp calls it.
struct RowGroup {
  int sub, row, n_c, n_tot, passes, list_max, self0;
};

template <int L, int CPL, class Src>
__device__ __forceinline__ RowGroup open_row(fnx::NbrTable& tab, const Src& src,
                                             const int* __restrict__ cnt, int C) {
  RowGroup g;
  g.sub = threadIdx.x % L;
  g.row = blockIdx.x * (GROUP_WARPS * 32 / L) + threadIdx.x / L;
  if constexpr (!Src::GATHERED) g.n_c = g.row <= C ? cnt[g.row] : 0;
  g.n_tot = fnx::load_nbr_table<L>(tab, src, g.row, g.sub, g.row < C);
  if constexpr (Src::GATHERED) g.n_c = g.row <= C ? tab.n[fnx::SELF_J] : 0;
  g.passes = __reduce_max_sync(FULL_MASK, (unsigned)(g.n_c + L * CPL - 1) / (L * CPL));
  g.list_max = __reduce_max_sync(FULL_MASK, g.n_c > 0 ? (unsigned)g.n_tot : 0u);
  g.self0 = g.row < C && src.is_self(tab.nb[fnx::SELF_J], g.row) ? tab.pre[fnx::SELF_J]
                                                                  : -(1 << 30);
  return g;
}

// Centre slots a lane of the warp holds in a pass, at most, where this
// group's row has `left` live slots from the pass on.
template <int L, int CPL>
__device__ __forceinline__ int pass_cpl(int left) {
  return __reduce_max_sync(FULL_MASK, left > L ? (unsigned)CPL : 1u);
}

// Stores 0 over the floats [i0, i1) of the span at p, lane sub of a row's
// group of L, by 16-byte stores where vec (then i0 = 0, and p and i1 are
// multiples of 4 floats).
template <int L>
__device__ __forceinline__ void zero_span(float* p, int i0, int i1, int sub, bool vec) {
  if (vec) {
    for (int i = sub; i < i1 / 4; i += L)
      reinterpret_cast<float4*>(p)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int i = i0 + sub; i < i1; i += L) p[i] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Phase 1, v3, v2 and v1. Replaces the Pallas kernels
// fluidnexus_tpu/sim/pbf_pallas.py:_phase1_kernel_v3 (wrapper
// phase1_slots_v3), :_phase1_kernel_v2 (wrapper phase1_slots_v2) and
// :_phase1_kernel (wrapper phase1_slots, which reads the neighbour rows from
// a tensor gathered before the launch, as v1 does here: GatheredSource). Per
// live slot the sums over its pairs: the raw poly6 sum pi_raw (self
// included), the in-radius count nl (self included), sum cg, sum cg^2 d2 and
// sum cg x_s. What a launch writes (P1Out):
// - LAMBDA (v3): pi_raw, nl and lambda, computed here from the spiky sums:
//   sg = (sum cg) x_i - sum cg x_s,  p_ratio = pi_raw / imass / p0,
//   lambda = -(p_ratio - 1) / (sum cg^2 d2 / p0^2 + |sg|^2 / p0^2 + relax).
// - RAW (v2, v1): pi_raw, sg (C+1, M, 3) interleaved, c2d2 = sum cg^2 d2
//   and nlen = nl, with lambda left to the caller (sim/pbf_dense._project_core,
//   as fluidnexus_tpu/sim/pbf_dense.py:155-160 does); it reads no imass.
//   Each output is the expression phase1_walk_kernel writes (nvcc contracts
//   sg's a.cga * xc - a.bx alike in both), so v2, v1 and the walk agree bit
//   for bit.
// Dead slots, empty rows and row C write 0, so the global sums are plain sums.
//
// Bound on the H100: ~30 f32 operations per live candidate pair against one
// read of the coordinate planes (and imass) and one write of three planes
// (six for RAW): bound by operations, and in practice by the latency of the
// walk. The row groups above, with these points:
// - The list carries three planes (stage_chunk's NO_W form, w = 0): phase 1
//   reads nothing of a neighbour slot but its coordinates.
// - A far entry past the group's list has d2 = inf and cg = 0, so the walk's
//   c2a += cg^2 d2 would add 0 * inf = NaN there: that term is selected on
//   the pair being in reach (cg != 0). The walk's terms out of reach are +0,
//   so the select keeps its bits; nvcc contracted that sum into
//   fma(cg * cg, d2, c2a), written out here. w is selected on d2 < h^2 inside
//   pair_terms and nl on d2 <= h^2, and cg x_s is 0 * 1e30 = 0.
// - d2 is formed by norm2_rn with no FMA, so nl agrees with the plain version
//   pair for pair.
// - No sum runs across slots, so how the slots are dealt to lanes leaves
//   every slot's bits as they are; only the time depends on it.
// - v3 (phase B: 513 blocks, one wave at up to four an SM, rows of at most 8
//   live slots) is bound by its loop's own latency, not by occupancy: the
//   loop is unrolled 8 (4 % faster than 4 on the H100, at the same 128
//   registers; 16 no faster); staging a chunk in one round of 32 entries a
//   lane took 211 registers and gained nothing beside it, and 16 lanes a row
//   read 15 % slower (twice the warps, twice the instructions).
// - v2 runs on the rigid tick's rebuilt grid: 2 817 live rows of 8.7 live
//   slots on average and 20 at most, 1 274 over 8, where 8 lanes a row give
//   619 of 705 warps two centre slots a lane. Timed there against the
//   parent's walk (0.057 ms) on the H100: 8 lanes x 2 slots 0.056 ms, 8 x 3
//   0.050, 32 x 1 0.041, 16 x 1 0.042 (rows over 16 take a second pass), 16
//   x 2 0.037 (P1V2_LANES, P1V2_CPL: two rows a warp, one pass for every
//   row up to 32, 128 registers, so 1 025 blocks stay one wave at eight an
//   SM; 8 x 3 took 168, six an SM, which one wave of 513 still fits).
// - v2 also skips, warp-uniformly, an entry that no lane's centre slot is
//   within reach of (P1V2_SKIP): only ~17 % of the rigid grid's candidate
//   pairs are in radius. Past d2 = h^2 (1 + 1e-5) every term of a pair is
//   exactly +0 (w and nl by their tests; rlen, with rsqrtf's 2 ulp, stays
//   above h, so cg = 0), and adding +0 to a sum that is never -0 leaves its
//   bits, so the skip keeps the walk's sums. 0.037 -> 0.031 ms at the rigid
//   inputs, 0.025 -> 0.023 at phase B's first tick. v3 keeps its branch-free
//   loop.
// - v1 is v2's configuration over the gathered rows (GatheredSource: the
//   table in one trip, the row's own count and self entry from its copy,
//   neighbour 13, so row C, which has no copy, reads none); its sums are
//   v2's, entry for entry, so it writes v2's bits. It replaced the walk,
//   which its entry keeps as a checking mode (phase1_walk_kernel).
// ---------------------------------------------------------------------------
constexpr int P1_CHUNK = 256;  // list entries a row stages at once
constexpr int P1_ROUND = 16;   // entries a lane stages with its loads in flight
constexpr int P1V2_LANES = 16;    // phase 1 v2: lanes that own a row,
constexpr int P1V2_CPL = 2;       // the centre slots a lane may hold (a pass covers 32),
constexpr bool P1V2_SKIP = true;  // and the skip of entries out of every lane's reach
constexpr float P1_REACH = 1.00001f;  // of h^2: past it a pair's terms are all +0

template <int L>
size_t phase1_smem() { return (size_t)(GROUP_WARPS * 32 / L) * P1_CHUNK * sizeof(float4); }

enum P1Out { LAMBDA, RAW };

// Phase 1's sums for one centre slot (Sums1) and what the slot's pass needs:
// its coordinates and the list entry of its self pair.
struct Cen1 {
  float x, y, z;
  int self_e;
  Sums1 a;
};

// The pair loop over kn staged entries (the list's entries c0 ..) for the
// first NC centre slots a lane holds: no branch, so the compiler can overlap
// the iterations; with SKIP, one warp-uniform branch an entry (above).
template <int NC, int CPL, bool SKIP>
__device__ __forceinline__ void phase1_sweep(const float4* list, int c0, int kn, Cen1 (&c)[CPL],
                                             const PairConsts& k) {
#pragma unroll 8
  for (int e = 0; e < kn; ++e) {
    const float4 s = list[e];
    if constexpr (SKIP) {  // no lane of the warp within reach: every term is +0
      bool near = false;
#pragma unroll
      for (int i = 0; i < NC; ++i)
        near |= norm2_rn(__fsub_rn(c[i].x, s.x), __fsub_rn(c[i].y, s.y),
                         __fsub_rn(c[i].z, s.z)) <= k.h2 * P1_REACH;
      if (!__any_sync(FULL_MASK, near)) continue;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      Cen1& ci = c[i];
      const Pair p = pair_terms(ci.x, ci.y, ci.z, s.x, s.y, s.z, c0 + e == ci.self_e, k);
      ci.a.wa += p.w;
      ci.a.cga += p.cg;
      ci.a.c2a = p.cg != 0.0f ? fmaf(p.cg * p.cg, p.d2, ci.a.c2a) : ci.a.c2a;
      ci.a.nla += p.d2 <= k.h2 ? 1.0f : 0.0f;
      ci.a.bx += p.cg * s.x;
      ci.a.by += p.cg * s.y;
      ci.a.bz += p.cg * s.z;
    }
  }
}

// The body of the three kernels. src: where the list is staged from (the
// planes through nbr, whose counts are cnt, or v1's gathered rows, with cnt
// unused). LAMBDA: o0 lam, o1 pi_raw, o2 nl (o3 unused). RAW: o0 pi_raw, o1
// sg, o2 c2d2, o3 nlen (imass unused).
template <int L, int CPL, bool SKIP, P1Out OUT, class Src>
__device__ __forceinline__ void phase1_rows(
    const Src& src, const int* __restrict__ cnt, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ imass,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
    float* __restrict__ o3, int C, int M, const PairConsts& k, bool vec) {
  constexpr int PASS = L * CPL;  // centre slots a pass covers
  extern __shared__ float4 p1_lists[];  // [64 / L][P1_CHUNK]
  __shared__ fnx::NbrTable tabs[GROUP_WARPS * 32 / L];
  const int grp = threadIdx.x / L;
  float4* list = p1_lists + grp * P1_CHUNK;
  const fnx::NbrTable& tab = tabs[grp];
  const RowGroup g = open_row<L, CPL>(tabs[grp], src, cnt, C);
  if (g.row <= C) {  // dead slots, or the row's every slot
    const size_t o = (size_t)g.row * M;
    const bool all4 = g.n_c == 0 && vec;
    zero_span<L>(o0 + o, g.n_c, M, g.sub, all4);
    zero_span<L>(o2 + o, g.n_c, M, g.sub, all4);
    if constexpr (OUT == LAMBDA) {
      zero_span<L>(o1 + o, g.n_c, M, g.sub, all4);
    } else {
      zero_span<L>(o1 + 3 * o, 3 * g.n_c, 3 * M, g.sub, all4);
      zero_span<L>(o3 + o, g.n_c, M, g.sub, all4);
    }
  }
  for (int pass = 0; pass < g.passes; ++pass) {
    const int left = g.n_c - pass * PASS;  // this row's live centre slots from the pass on
    const int cpl = pass_cpl<L, CPL>(left);
    bool live[CPL];
    Cen1 c[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int s = g.sub + i * L;
      const size_t at = (size_t)g.row * M + pass * PASS + s;
      live[i] = s < left;
      c[i].x = live[i] ? x[at] : 0.0f;
      c[i].y = live[i] ? y[at] : 0.0f;
      c[i].z = live[i] ? z[at] : 0.0f;
      c[i].self_e = g.self0 + pass * PASS + s;
      c[i].a = Sums1{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    }
    for (int c0 = 0; c0 < g.list_max; c0 += P1_CHUNK) {
      const int kn = min(P1_CHUNK, g.list_max - c0);  // the warp's trip count
      fnx::stage_chunk<L, P1_CHUNK, P1_ROUND, fnx::NO_W>(list, tab, c0, left > 0 ? g.n_tot : 0,
                                                          kn, src, k.h, g.sub);
      if (cpl == 1)
        phase1_sweep<1, CPL, SKIP>(list, c0, kn, c, k);
      else
        phase1_sweep<CPL, CPL, SKIP>(list, c0, kn, c, k);
      __syncwarp();  // the chunk is consumed before the next one is staged
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (!live[i]) continue;
      const size_t at = (size_t)g.row * M + pass * PASS + g.sub + i * L;
      const Sums1& a = c[i].a;
      const float xc = c[i].x, yc = c[i].y, zc = c[i].z;
      if constexpr (OUT == LAMBDA) {
        const float sg0 = a.cga * xc - a.bx, sg1 = a.cga * yc - a.by, sg2 = a.cga * zc - a.bz;
        const float ip2 = k.inv_p0 * k.inv_p0;
        const float gr_dot = (sg0 * sg0 + sg1 * sg1 + sg2 * sg2) * ip2;
        const float p_ratio = a.wa / imass[at] * k.inv_p0;
        o0[at] = -(p_ratio - 1.0f) / (a.c2a * ip2 + gr_dot + k.relax);
        o1[at] = a.wa;
        o2[at] = a.nla;
      } else {
        o0[at] = a.wa;
        o1[3 * at] = a.cga * xc - a.bx;
        o1[3 * at + 1] = a.cga * yc - a.by;
        o1[3 * at + 2] = a.cga * zc - a.bz;
        o2[at] = a.c2a;
        o3[at] = a.nla;
      }
    }
  }
}

// Phase 1 v3 (LAMBDA), v2 (RAW) and v1 (RAW from the gathered rows): one
// body under three kernel names.
__global__ void __launch_bounds__(GROUP_WARPS * 32) phase1_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ imass,
    float* __restrict__ lam, float* __restrict__ pi_raw, float* __restrict__ nl, int C, int M,
    PairConsts k, bool vec) {
  phase1_rows<ROW_LANES, ROW_CPL, false, LAMBDA>(
      fnx::PlaneSource{nbr, cnt, x, y, z, nullptr, nullptr, C, M}, cnt, x, y, z, imass, lam,
      pi_raw, nl, nullptr, C, M, k, vec);
}

__global__ void __launch_bounds__(GROUP_WARPS * 32) phase1_v2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, float* __restrict__ pi_raw,
    float* __restrict__ sg, float* __restrict__ c2d2, float* __restrict__ nlen, int C, int M,
    PairConsts k, bool vec) {
  phase1_rows<P1V2_LANES, P1V2_CPL, P1V2_SKIP, RAW>(
      fnx::PlaneSource{nbr, cnt, x, y, z, nullptr, nullptr, C, M}, cnt, x, y, z, nullptr, pi_raw,
      sg, c2d2, nlen, C, M, k, vec);
}

__global__ void __launch_bounds__(GROUP_WARPS * 32) phase1_v1_kernel(
    const int* __restrict__ ncnt, const float* __restrict__ xng, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, float* __restrict__ pi_raw,
    float* __restrict__ sg, float* __restrict__ c2d2, float* __restrict__ nlen, int C, int M,
    PairConsts k, bool vec) {
  phase1_rows<P1V2_LANES, P1V2_CPL, P1V2_SKIP, RAW>(
      fnx::GatheredSource{ncnt, xng, nullptr, M}, nullptr, x, y, z, nullptr, pi_raw, sg, c2d2,
      nlen, C, M, k, vec);
}

// ---------------------------------------------------------------------------
// Phase 2, v3, v2 and v1. Replaces the Pallas kernels
// fluidnexus_tpu/sim/pbf_pallas.py:_phase2_kernel_v3 (wrapper phase2_slots_v3),
// :_phase2_kernel_v2 (wrapper phase2_slots_v2) and :_phase2_kernel (wrapper
// phase2_slots, which reads the neighbour rows from tensors gathered before
// the launch, as v1 does here: GatheredSource). Per live slot, over its
// non-self pairs: corr = -k_p (w / w(dq))^e_p, b = (lambda_i + lambda_s +
// corr) cg, and the raw delta dsum = (sum b) x_i - sum b x_s. What a launch
// writes (P2Out):
// - UPDATE (v3): the UPDATED coordinates x_new = x_i + dsum / p0 /
//   max(nc_i, 1e-20), nc = nl + counts; dead slots, empty rows and row C keep
//   their input coordinates.
// - DSUM (v2, v1): dsum, (C+1, M, 3) interleaved, with the 1/p0/max(nc, eps)
//   scaling left to the caller (fluidnexus_tpu/sim/pbf_dense.py:210); 0 at
//   dead slots, empty rows and row C. It reads no nc.
// Each row also writes its partial sums of corr and of the non-self
// in-radius count: part[row] = (s_corr, s_ns), which the caller adds up (no
// float atomics).
//
// Bound on the H100: ~35 f32 operations per live candidate pair against one
// read of four planes (five with nc; v1 reads its list's entries from the
// gathered copies) and one write of three: bound by operations, and in
// practice by the latency of the walk. The row groups above, with these
// points:
// - Lambda is the list's fourth plane. A chunk holds P2_CHUNK = 256 entries,
//   less than a whole neighbourhood at M = 32 (27 x 32): at the 168
//   registers a thread the loop takes, the registers allow six blocks an SM,
//   and chunks of 27 x 32 (55 KB a block) would allow four (read ~10 %
//   slower); phase B's lists hold 165 entries on average, 216 at most.
// - The power's repeat count int_pow is made a constant where the launch has
//   one (IP: 4 at PBFParams.e_p 4, three products; 0, powf, at a non-integer
//   e_p), so the unrolled loop holds no loop of its own; any other int_pow
//   runs the runtime loop (IP = -1).
// - The row's partials are reduced in the tree of the one-block-a-row walk
//   these kernels replaced, whose warps each summed 32 slots by shuffles at
//   offsets 16, 8, 4, 2, 1 and then added the warps' sums in order from 0:
//   slot s + 16 added to slot s (here the odd pass's slot to the even
//   pass's), then s + 8 to s (a lane's second slot to its first), then
//   offsets 4, 2, 1 across the group, and the warps' sums added in order
//   from 0, so s_corr and s_ns keep their bits. A dead slot adds 0. That
//   tree fixes (L, CPL) at (8, 2).
// - v1's table is its gathered counts, one trip (no nbr), and its list is
//   staged from the gathered copies: the row's own count and self entry come
//   from its neighbour 13, so row C, which has no copy, reads none of them.
// ---------------------------------------------------------------------------
constexpr int P2_CHUNK = 256;  // list entries a row stages at once
constexpr int P2_ROUND = 16;   // entries a lane stages with its loads in flight
constexpr int ROW_PASS = ROW_LANES * ROW_CPL;  // centre slots a pass covers: 16
static_assert(2 * ROW_PASS == 32, "two passes make the 32 slots of the partials' tree");

size_t phase2_smem() { return (size_t)(GROUP_WARPS * 32 / ROW_LANES) * P2_CHUNK * sizeof(float4); }

enum P2Out { UPDATE, DSUM };

// Phase 2's sums for one centre slot with lambda lc: sum b, sum b x_s, and
// over the non-self pairs in radius sum corr and their count.
struct Sums2 {
  float ba, cra, nsa, bx, by, bz;
};

// A centre slot of a pass: its coordinates and lambda, the list entry of its
// self pair, and its sums.
struct Cen2 {
  float x, y, z, l;
  int self_e;
  Sums2 a;
};

// The pair loop over kn staged entries (the list's entries c0 ..) for the
// first NC centre slots a lane holds: no branch, so the compiler can overlap
// the iterations.
template <int NC, int IP>
__device__ __forceinline__ void phase2_sweep(const float4* list, int c0, int kn,
                                             Cen2 (&c)[ROW_CPL], const PairConsts& k0) {
  PairConsts k = k0;
  if (IP >= 0) k.int_pow = IP;
#pragma unroll 4
  for (int e = 0; e < kn; ++e) {
    const float4 s = list[e];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      Cen2& ci = c[i];
      const bool self = c0 + e == ci.self_e;
      const Pair p = pair_terms(ci.x, ci.y, ci.z, s.x, s.y, s.z, self, k);
      const Pair2 q = phase2_terms(p, self, ci.l, s.w, k);
      ci.a.ba += q.b;
      ci.a.cra += q.corr * q.ns;
      ci.a.nsa += q.ns;
      ci.a.bx += q.b * s.x;
      ci.a.by += q.b * s.y;
      ci.a.bz += q.b * s.z;
    }
  }
}

// The body of the three kernels. src: where the list is staged from (the
// planes through nbr, whose counts are cnt, or v1's gathered rows, with cnt
// unused). xo, yo, zo: the updated planes (UPDATE); xo alone, dsum (DSUM),
// with nc, yo and zo unused.
template <int IP, P2Out OUT, class Src>
__device__ __forceinline__ void phase2_rows(
    const Src& src, const int* __restrict__ cnt, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ lam,
    const float* __restrict__ nc, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, float* __restrict__ part, int C, int M, const PairConsts& k,
    bool vec) {
  extern __shared__ float4 p2_lists[];  // [64 / ROW_LANES][P2_CHUNK]
  __shared__ fnx::NbrTable tabs[GROUP_WARPS * 32 / ROW_LANES];
  const int grp = threadIdx.x / ROW_LANES;
  float4* list = p2_lists + grp * P2_CHUNK;
  const fnx::NbrTable& tab = tabs[grp];
  const RowGroup g = open_row<ROW_LANES, ROW_CPL>(tabs[grp], src, cnt, C);
  const int row = g.row, n_c = g.n_c, sub = g.sub;
  if (row <= C) {  // the slots the pair loop does not write
    if constexpr (OUT == UPDATE) {  // keep their coordinates
      if (n_c == 0 && vec) {  // the row's every slot, 16 bytes a load and a store
        const size_t o = (size_t)row * M / 4;
        for (int i = sub; i < M / 4; i += ROW_LANES) {
          reinterpret_cast<float4*>(xo)[o + i] = reinterpret_cast<const float4*>(x)[o + i];
          reinterpret_cast<float4*>(yo)[o + i] = reinterpret_cast<const float4*>(y)[o + i];
          reinterpret_cast<float4*>(zo)[o + i] = reinterpret_cast<const float4*>(z)[o + i];
        }
      } else {
        for (int i = n_c + sub; i < M; i += ROW_LANES) {  // dead slots, or the row's every slot
          const size_t at = (size_t)row * M + i;
          xo[at] = x[at];
          yo[at] = y[at];
          zo[at] = z[at];
        }
      }
    } else {  // read 0: the row's floats from 3 n_c on
      zero_span<ROW_LANES>(xo + (size_t)row * M * 3, 3 * n_c, 3 * M, sub, n_c == 0 && vec);
    }
    if (n_c == 0 && sub == 0) part[2 * row] = part[2 * row + 1] = 0.0f;
  }
  float s_corr = 0.0f, s_ns = 0.0f;  // the row's partial sums, pass by pass
  float hold_cr[ROW_CPL], hold_ns[ROW_CPL];  // an even pass's sums, for the odd pass after it
  for (int pass = 0; pass < g.passes; ++pass) {
    const int left = n_c - pass * ROW_PASS;  // this row's live centre slots from the pass on
    const int cpl = pass_cpl<ROW_LANES, ROW_CPL>(left);
    bool live[ROW_CPL];
    Cen2 c[ROW_CPL];
#pragma unroll
    for (int i = 0; i < ROW_CPL; ++i) {
      const int s = sub + i * ROW_LANES;
      const size_t at = (size_t)row * M + pass * ROW_PASS + s;
      live[i] = s < left;
      c[i].x = live[i] ? x[at] : 0.0f;
      c[i].y = live[i] ? y[at] : 0.0f;
      c[i].z = live[i] ? z[at] : 0.0f;
      c[i].l = live[i] ? lam[at] : 0.0f;
      c[i].self_e = g.self0 + pass * ROW_PASS + s;
      c[i].a = Sums2{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    }
    for (int c0 = 0; c0 < g.list_max; c0 += P2_CHUNK) {
      const int kn = min(P2_CHUNK, g.list_max - c0);  // the warp's trip count
      fnx::stage_chunk<ROW_LANES, P2_CHUNK, P2_ROUND>(list, tab, c0, left > 0 ? g.n_tot : 0, kn,
                                                      src, k.h, sub);
      if (cpl == 1)
        phase2_sweep<1, IP>(list, c0, kn, c, k);
      else
        phase2_sweep<ROW_CPL, IP>(list, c0, kn, c, k);
      __syncwarp();  // the chunk is consumed before the next one is staged
    }
#pragma unroll
    for (int i = 0; i < ROW_CPL; ++i) {
      if (!live[i]) continue;
      const size_t at = (size_t)row * M + pass * ROW_PASS + sub + i * ROW_LANES;
      const Sums2& a = c[i].a;
      if constexpr (OUT == UPDATE) {
        const float scale = k.inv_p0 / fmaxf(nc[at], 1e-20f);
        xo[at] = c[i].x + (a.ba * c[i].x - a.bx) * scale;
        yo[at] = c[i].y + (a.ba * c[i].y - a.by) * scale;
        zo[at] = c[i].z + (a.ba * c[i].z - a.bz) * scale;
      } else {
        xo[3 * at] = a.ba * c[i].x - a.bx;
        xo[3 * at + 1] = a.ba * c[i].y - a.by;
        xo[3 * at + 2] = a.ba * c[i].z - a.bz;
      }
    }
    // the row's partials in the walk's tree (above): an even pass's sums wait
    // for the odd pass after it, or for 0 where the warp has no such pass
    const bool odd = pass % 2 == 1;
#pragma unroll
    for (int i = 0; i < ROW_CPL; ++i) {
      const float cr_i = live[i] ? c[i].a.cra : 0.0f, ns_i = live[i] ? c[i].a.nsa : 0.0f;
      hold_cr[i] = odd ? hold_cr[i] + cr_i : cr_i;
      hold_ns[i] = odd ? hold_ns[i] + ns_i : ns_i;
    }
    if (!odd && pass < g.passes - 1) continue;
    if (!odd) {
#pragma unroll
      for (int i = 0; i < ROW_CPL; ++i) {
        hold_cr[i] += 0.0f;
        hold_ns[i] += 0.0f;
      }
    }
    float cr = hold_cr[0] + hold_cr[1];
    float ns = hold_ns[0] + hold_ns[1];
#pragma unroll
    for (int off = ROW_LANES / 2; off > 0; off >>= 1) {
      cr += __shfl_down_sync(FULL_MASK, cr, off, ROW_LANES);
      ns += __shfl_down_sync(FULL_MASK, ns, off, ROW_LANES);
    }
    s_corr += cr;
    s_ns += ns;
  }
  if (n_c > 0 && sub == 0) {
    part[2 * row] = s_corr;
    part[2 * row + 1] = s_ns;
  }
}

// Phase 2 v3 (UPDATE), v2 (DSUM) and v1 (DSUM from the gathered rows): one
// body under three kernel names.
template <int IP>
__global__ void __launch_bounds__(GROUP_WARPS * 32) phase2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ lam,
    const float* __restrict__ nc, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, float* __restrict__ part, int C, int M, PairConsts k, bool vec) {
  phase2_rows<IP, UPDATE>(fnx::PlaneSource{nbr, cnt, x, y, z, lam, nullptr, C, M}, cnt, x, y, z,
                          lam, nc, xo, yo, zo, part, C, M, k, vec);
}

template <int IP>
__global__ void __launch_bounds__(GROUP_WARPS * 32) phase2_v2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ lam,
    float* __restrict__ dsum, float* __restrict__ part, int C, int M, PairConsts k, bool vec) {
  phase2_rows<IP, DSUM>(fnx::PlaneSource{nbr, cnt, x, y, z, lam, nullptr, C, M}, cnt, x, y, z,
                        lam, nullptr, dsum, nullptr, nullptr, part, C, M, k, vec);
}

template <int IP>
__global__ void __launch_bounds__(GROUP_WARPS * 32) phase2_v1_kernel(
    const int* __restrict__ ncnt, const float* __restrict__ xng, const float* __restrict__ lng,
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
    const float* __restrict__ lam, float* __restrict__ dsum, float* __restrict__ part, int C,
    int M, PairConsts k, bool vec) {
  phase2_rows<IP, DSUM>(fnx::GatheredSource{ncnt, xng, lng, M}, nullptr, x, y, z, lam, nullptr,
                        dsum, nullptr, nullptr, part, C, M, k, vec);
}

// Launches a row-group kernel over rows 0..C at 64 / L rows a block with smem
// bytes of dynamic shared memory; returns the CUDA error code.
template <int L, class... P, class... A>
int launch_rows(void (*kernel)(P...), int C, size_t smem, cudaStream_t stream, A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C / (GROUP_WARPS * 32 / L) + 1, GROUP_WARPS * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Calls launch with the power's repeat count made a constant where it is 4 or
// 0 (phase 2's IP), as std::integral_constant<int, IP>.
template <class F>
int with_int_pow(int int_pow, F launch) {
  if (int_pow == 4) return launch(std::integral_constant<int, 4>{});
  if (int_pow == 0) return launch(std::integral_constant<int, 0>{});
  return launch(std::integral_constant<int, -1>{});
}

// Every plane's rows start on 16 bytes: M % 4 == 0 and each plane aligned.
bool rows_aligned(int M, std::initializer_list<const void*> planes) {
  if (M % 4 != 0) return false;
  for (const void* p : planes)
    if ((size_t)p % sizeof(float4) != 0) return false;
  return true;
}

PairConsts consts(float h, float h2, float eps, float c6, float s45, float inv_p0, float relax,
                  float k_p, float e_p, int int_pow, float inv_denom) {
  return PairConsts{h, h2, eps, c6, s45, inv_p0, relax, k_p, e_p, inv_denom, int_pow};
}

bool bad_shape(int C, int M) { return C < 0 || M <= 0 || M > MAX_M; }

}  // namespace

extern "C" {

int fnx_pbf_max_m() { return MAX_M; }

int fnx_pbf_phase1(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                   const float* imass, float* lam, float* pi_raw, float* nl, int C, int M, float h,
                   float h2, float eps, float c6, float s45, float inv_p0, float relax, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  return launch_rows<ROW_LANES>(phase1_kernel, C, phase1_smem<ROW_LANES>(), (cudaStream_t)stream,
                                cnt, nbr, x, y, z, imass, lam, pi_raw, nl, C, M,
                                consts(h, h2, eps, c6, s45, inv_p0, relax, 0.0f, 0.0f, 0, 0.0f),
                                rows_aligned(M, {lam, pi_raw, nl}));
}

int fnx_pbf_phase2(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                   const float* lam, const float* nc, float* xo, float* yo, float* zo, float* part,
                   int C, int M, float h, float h2, float eps, float c6, float s45, float k_p,
                   float e_p, int int_pow, float inv_denom, float inv_p0, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  const PairConsts k = consts(h, h2, eps, c6, s45, inv_p0, 0.0f, k_p, e_p, int_pow, inv_denom);
  const bool vec = rows_aligned(M, {x, y, z, xo, yo, zo});
  return with_int_pow(int_pow, [&](auto ip) {
    return launch_rows<ROW_LANES>(phase2_kernel<decltype(ip)::value>, C, phase2_smem(),
                                  (cudaStream_t)stream, cnt, nbr, x, y, z, lam, nc, xo, yo, zo,
                                  part, C, M, k, vec);
  });
}

int fnx_pbf_phase1_v2(const int* cnt, const int* nbr, const float* x, const float* y,
                      const float* z, float* pi_raw, float* sg, float* c2d2, float* nlen, int C,
                      int M, float h, float h2, float eps, float c6, float s45, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  return launch_rows<P1V2_LANES>(phase1_v2_kernel, C, phase1_smem<P1V2_LANES>(),
                                 (cudaStream_t)stream, cnt, nbr, x, y, z, pi_raw, sg, c2d2, nlen,
                                 C, M, consts(h, h2, eps, c6, s45, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0.0f),
                                 rows_aligned(M, {pi_raw, sg, c2d2, nlen}));
}

int fnx_pbf_phase2_v2(const int* cnt, const int* nbr, const float* x, const float* y,
                      const float* z, const float* lam, float* dsum, float* part, int C, int M,
                      float h, float h2, float eps, float c6, float s45, float k_p, float e_p,
                      int int_pow, float inv_denom, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  const PairConsts k = consts(h, h2, eps, c6, s45, 0.0f, 0.0f, k_p, e_p, int_pow, inv_denom);
  const bool vec = rows_aligned(M, {dsum});
  return with_int_pow(int_pow, [&](auto ip) {
    return launch_rows<ROW_LANES>(phase2_v2_kernel<decltype(ip)::value>, C, phase2_smem(),
                                  (cudaStream_t)stream, cnt, nbr, x, y, z, lam, dsum, part, C, M,
                                  k, vec);
  });
}

// walk = 1 launches the checking mode, the one-block-a-row walk
// (phase1_walk_kernel), in place of the row groups. A gathered row's live
// count is its own copy's, ncnt[row, 13], in either mode.
int fnx_pbf_phase1_v1(const int* ncnt, const float* xng, const float* x, const float* y,
                      const float* z, float* pi_raw, float* sg, float* c2d2, float* nlen, int C,
                      int M, float h, float h2, float eps, float c6, float s45, int walk,
                      void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  const PairConsts k = consts(h, h2, eps, c6, s45, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0.0f);
  if (walk) {
    phase1_walk_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
        ncnt, xng, x, y, z, pi_raw, sg, c2d2, nlen, C, M, k);
    return (int)cudaGetLastError();
  }
  return launch_rows<P1V2_LANES>(phase1_v1_kernel, C, phase1_smem<P1V2_LANES>(),
                                 (cudaStream_t)stream, ncnt, xng, x, y, z, pi_raw, sg, c2d2, nlen,
                                 C, M, k, rows_aligned(M, {pi_raw, sg, c2d2, nlen}));
}

// A gathered row's live count is its own copy's, ncnt[row, 13].
int fnx_pbf_phase2_v1(const int* ncnt, const float* xng, const float* lng,
                      const float* x, const float* y, const float* z, const float* lam,
                      float* dsum, float* part, int C, int M, float h, float h2, float eps,
                      float c6, float s45, float k_p, float e_p, int int_pow, float inv_denom,
                      void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  const PairConsts k = consts(h, h2, eps, c6, s45, 0.0f, 0.0f, k_p, e_p, int_pow, inv_denom);
  const bool vec = rows_aligned(M, {dsum});
  return with_int_pow(int_pow, [&](auto ip) {
    return launch_rows<ROW_LANES>(phase2_v1_kernel<decltype(ip)::value>, C, phase2_smem(),
                                  (cudaStream_t)stream, ncnt, xng, lng, x, y, z, lam, dsum, part,
                                  C, M, k, vec);
  });
}

int fnx_pbf_density(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                    float* pi, int C, int M, float h, float h2, float c6, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  const size_t smem = density_smem();
  cudaError_t err = cudaFuncSetAttribute(density_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  density_kernel<<<C / GROUP_ROWS + 1, GROUP_WARPS * 32, smem, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, pi, C, M, h, h2, c6);
  return (int)cudaGetLastError();
}

int fnx_pbf_density_bwd(const int* cnt, const int* nbr, const float* x, const float* y,
                        const float* z, const float* g, float* dx, int C, int M, float h, float h2,
                        float c6, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  const size_t smem = density_smem();
  cudaError_t err = cudaFuncSetAttribute(density_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  density_bwd_kernel<<<C / GROUP_ROWS + 1, GROUP_WARPS * 32, smem, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, g, dx, C, M, h, h2, c6);
  return (int)cudaGetLastError();
}

}  // extern "C"
