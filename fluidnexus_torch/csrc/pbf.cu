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
// One block per row, one thread per centre slot; dead slots and rows are
// masked by the counts, so no sentinel coordinates are needed. The pair terms
// are fnx::pair_terms and fnx::phase2_terms (pair_common.cuh), the same
// device functions in every generation.

#include <cuda_runtime.h>

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

// v3 and v2: through nbr into the (C+1, M) planes.
struct TableRows {
  const int* cnt;
  const int* nbr;
  const float *x, *y, *z, *lam;
  int C, M;

  __device__ __forceinline__ Row open(int cell, int j) const {
    const int nb = nbr[cell * 27 + j];
    if (nb >= C) return Row{0, nullptr, nullptr, nullptr, nullptr, false};
    const size_t o = (size_t)nb * M;
    return Row{cnt[nb], x + o, y + o, z + o, lam ? lam + o : nullptr, nb == cell};
  }
};

// v1: from the pre-gathered rows. Offset 13 of an occupied cell is the cell.
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

// Phase 2's sums for one centre slot with lambda lc: sum b, sum b x_s, and
// over the non-self pairs in radius sum corr and their count.
struct Sums2 {
  float ba, cra, nsa, bx, by, bz;
};

template <class Rows>
__device__ __forceinline__ Sums2 phase2_walk(const Rows& rows, int cell, int i, bool live, float xc,
                                             float yc, float zc, float lc, const PairConsts& k,
                                             float* sx, float* sy, float* sz, float* sl) {
  Sums2 a{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < 27; ++j) {
    const Row r = stage(rows, cell, j, i, k.h, sx, sy, sz, sl);
    if (r.n == 0 || !live) continue;
    for (int s = 0; s < r.n; ++s) {
      const bool self = r.self_row && s == i;
      const Pair p = pair_terms(xc, yc, zc, sx[s], sy[s], sz[s], self, k);
      const Pair2 q = phase2_terms(p, self, lc, sl[s], k);
      a.ba += q.b;
      a.cra += q.corr * q.ns;
      a.nsa += q.ns;
      a.bx += q.b * sx[s];
      a.by += q.b * sy[s];
      a.bz += q.b * sz[s];
    }
  }
  return a;
}

// The row's partial sums of corr and of the non-self in-radius count over
// its live slots (dead threads hold 0), by warp shuffles and one pass over
// the block's warps: part[row] = (s_corr, s_ns). The caller adds the rows
// up, so the global sums need no float atomics and are the same every run.
__device__ __forceinline__ void row_partials(float cra, float nsa, int i, int cell, float* part) {
  __shared__ float red[2][MAX_M / 32];
  for (int off = 16; off > 0; off >>= 1) {
    cra += __shfl_down_sync(FULL_MASK, cra, off);
    nsa += __shfl_down_sync(FULL_MASK, nsa, off);
  }
  if (i % 32 == 0) {
    red[0][i / 32] = cra;
    red[1][i / 32] = nsa;
  }
  __syncthreads();
  if (i == 0) {
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    part[2 * cell] = a;
    part[2 * cell + 1] = b;
  }
}

// ---------------------------------------------------------------------------
// Phase 1, v3. Replaces the Pallas kernel
// fluidnexus_tpu/sim/pbf_pallas.py:_phase1_kernel_v3 (wrapper phase1_slots_v3).
// Per live slot: the raw poly6 sum pi_raw (self included), the in-radius count
// nl (self included), and lambda, computed here from the spiky sums:
//   sg = (sum cg) x_i - sum cg x_s,  p_ratio = pi_raw / imass / p0,
//   lambda = -(p_ratio - 1) / (sum cg^2 d2 / p0^2 + |sg|^2 / p0^2 + relax).
// Dead slots and row C write 0.
//
// Bound on the H100: ~30 f32 operations per live candidate pair (a live
// centre slot and a live slot of one of its 27 neighbour cells), against one
// read of the coordinate planes and imass and one write of three planes: it
// is bound by operations. The design stages each neighbour row, shifted by
// its offset, in shared memory once per block (one coalesced read per row
// instead of one per centre slot), keeps every per-slot sum in registers, and
// walks only the live slots of live rows, so empty rows exit at once.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) phase1_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ imass,
    float* __restrict__ lam, float* __restrict__ pi_raw, float* __restrict__ nl, int C, int M,
    PairConsts k) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M];
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cnt[cell];
  if (n_c == 0) {  // an empty row, row C among them
    if (i < M) lam[at] = pi_raw[at] = nl[at] = 0.0f;
    return;
  }
  const bool live = i < n_c;
  const float xc = live ? x[at] : 0.0f, yc = live ? y[at] : 0.0f, zc = live ? z[at] : 0.0f;
  const Sums1 a = phase1_walk(TableRows{cnt, nbr, x, y, z, nullptr, C, M}, cell, i, live, xc, yc,
                              zc, k, sx, sy, sz);
  if (i >= M) return;
  if (!live) {
    lam[at] = pi_raw[at] = nl[at] = 0.0f;
    return;
  }
  const float sg0 = a.cga * xc - a.bx, sg1 = a.cga * yc - a.by, sg2 = a.cga * zc - a.bz;
  const float ip2 = k.inv_p0 * k.inv_p0;
  const float gr_dot = (sg0 * sg0 + sg1 * sg1 + sg2 * sg2) * ip2;
  const float p_ratio = a.wa / imass[at] * k.inv_p0;
  lam[at] = -(p_ratio - 1.0f) / (a.c2a * ip2 + gr_dot + k.relax);
  pi_raw[at] = a.wa;
  nl[at] = a.nla;
}

// ---------------------------------------------------------------------------
// Phase 2, v3. Replaces the Pallas kernel
// fluidnexus_tpu/sim/pbf_pallas.py:_phase2_kernel_v3 (wrapper phase2_slots_v3).
// Per live slot, over its non-self pairs:
//   corr = -k_p (w / w(dq))^e_p, b = (lambda_i + lambda_s + corr) cg,
//   x_new = x_i + ((sum b) x_i - sum b x_s) / p0 / max(nc_i, 1e-20),
// where nc = nl + counts. It writes the UPDATED coordinates, not the deltas;
// dead slots and empty rows keep their input coordinates. Each row also
// writes its partial sums of corr and of the non-self in-radius count
// (row_partials).
//
// Bound on the H100: as phase 1, ~35 f32 operations per live candidate pair
// against one read of four planes and one write of three: bound by
// operations. Same design as phase 1; lambda is staged beside the shifted
// coordinates.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) phase2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ lam,
    const float* __restrict__ nc, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, float* __restrict__ part, int C, int M, PairConsts k) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M], sl[MAX_M];
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cnt[cell];
  if (n_c == 0) {
    if (i < M) {
      xo[at] = x[at];
      yo[at] = y[at];
      zo[at] = z[at];
    }
    if (i == 0) part[2 * cell] = part[2 * cell + 1] = 0.0f;
    return;
  }
  const bool live = i < n_c;
  const float xc = live ? x[at] : 0.0f, yc = live ? y[at] : 0.0f, zc = live ? z[at] : 0.0f;
  const float lc = live ? lam[at] : 0.0f;
  const Sums2 a = phase2_walk(TableRows{cnt, nbr, x, y, z, lam, C, M}, cell, i, live, xc, yc, zc,
                              lc, k, sx, sy, sz, sl);
  if (i < M) {
    if (live) {
      const float scale = k.inv_p0 / fmaxf(nc[at], 1e-20f);
      xo[at] = xc + (a.ba * xc - a.bx) * scale;
      yo[at] = yc + (a.ba * yc - a.by) * scale;
      zo[at] = zc + (a.ba * zc - a.bz) * scale;
    } else {
      xo[at] = x[at];
      yo[at] = y[at];
      zo[at] = z[at];
    }
  }
  row_partials(a.cra, a.nsa, i, cell, part);
}

// ---------------------------------------------------------------------------
// Phase 1, v2 and v1: the raw sums, with lambda left to the caller
// (sim/pbf_dense._project_core, as fluidnexus_tpu/sim/pbf_dense.py:155-160
// does). Per live slot: pi_raw = sum w, sg = (sum cg) x_i - sum cg x_s
// (C+1, M, 3), c2d2 = sum cg^2 d2, nlen = the in-radius count (self
// included). Dead slots and empty rows write 0, so the global sums are the
// plain sums of pi_raw and nlen.
// ---------------------------------------------------------------------------
template <class Rows>
__device__ __forceinline__ void phase1_raw(const Rows& rows, const int* cnt, const float* x,
                                           const float* y, const float* z, float* pi_raw,
                                           float* sg, float* c2d2, float* nlen, int M,
                                           const PairConsts& k) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M];
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cnt[cell];
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

// Replaces the Pallas kernel fluidnexus_tpu/sim/pbf_pallas.py:_phase1_kernel_v2
// (wrapper phase1_slots_v2), which reads its neighbour rows through nbr from
// coordinate planes resident in VMEM; here through nbr from device memory.
// Bound on the H100: 9 f32 operations per live candidate pair and 24 more per
// pair in radius, against one read of three planes and one write of six:
// bound by operations. Design as phase 1 v3 (phase1_walk).
__global__ void __launch_bounds__(MAX_M) phase1_v2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, float* __restrict__ pi_raw,
    float* __restrict__ sg, float* __restrict__ c2d2, float* __restrict__ nlen, int C, int M,
    PairConsts k) {
  phase1_raw(TableRows{cnt, nbr, x, y, z, nullptr, C, M}, cnt, x, y, z, pi_raw, sg, c2d2, nlen, M,
             k);
}

// Replaces the Pallas kernel fluidnexus_tpu/sim/pbf_pallas.py:_phase1_kernel
// (wrapper phase1_slots), which reads its neighbour rows from a (C, 81, M)
// tensor gathered before the launch; here from the gathered (C, 27, 3, M)
// rows and (C, 27) counts. Bound on the H100: the operations of v2 against
// one read of the occupied rows' gathered blocks (27 x 3 x M floats each):
// by bytes where those blocks outweigh the arithmetic. Same walk as v2.
__global__ void __launch_bounds__(MAX_M) phase1_v1_kernel(
    const int* __restrict__ cnt, const int* __restrict__ ncnt, const float* __restrict__ xng,
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
    float* __restrict__ pi_raw, float* __restrict__ sg, float* __restrict__ c2d2,
    float* __restrict__ nlen, int M, PairConsts k) {
  phase1_raw(GatheredRows{ncnt, xng, nullptr, M}, cnt, x, y, z, pi_raw, sg, c2d2, nlen, M, k);
}

// ---------------------------------------------------------------------------
// Phase 2, v2 and v1: the raw position-delta sums, with the 1/p0/max(nc, eps)
// scaling left to the caller (fluidnexus_tpu/sim/pbf_dense.py:210). Per live
// slot dsum = (sum b) x_i - sum b x_s (C+1, M, 3), 0 at dead slots and empty
// rows; each row's partial sums of corr and of the non-self in-radius count
// (row_partials).
// ---------------------------------------------------------------------------
template <class Rows>
__device__ __forceinline__ void phase2_raw(const Rows& rows, const int* cnt, const float* x,
                                           const float* y, const float* z, const float* lam,
                                           float* dsum, float* part, int M,
                                           const PairConsts& k) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M], sl[MAX_M];
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cnt[cell];
  if (n_c == 0) {
    if (i < M) dsum[3 * at] = dsum[3 * at + 1] = dsum[3 * at + 2] = 0.0f;
    if (i == 0) part[2 * cell] = part[2 * cell + 1] = 0.0f;
    return;
  }
  const bool live = i < n_c;
  const float xc = live ? x[at] : 0.0f, yc = live ? y[at] : 0.0f, zc = live ? z[at] : 0.0f;
  const float lc = live ? lam[at] : 0.0f;
  const Sums2 a = phase2_walk(rows, cell, i, live, xc, yc, zc, lc, k, sx, sy, sz, sl);
  if (i < M) {
    dsum[3 * at] = live ? a.ba * xc - a.bx : 0.0f;
    dsum[3 * at + 1] = live ? a.ba * yc - a.by : 0.0f;
    dsum[3 * at + 2] = live ? a.ba * zc - a.bz : 0.0f;
  }
  row_partials(a.cra, a.nsa, i, cell, part);
}

// Replaces the Pallas kernel fluidnexus_tpu/sim/pbf_pallas.py:_phase2_kernel_v2
// (wrapper phase2_slots_v2). Bound on the H100: 9 f32 operations per live
// candidate pair and 25 + e_p per pair in radius, against one read of four
// planes and one write of three: bound by operations. Design as phase 2 v3.
__global__ void __launch_bounds__(MAX_M) phase2_v2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ lam,
    float* __restrict__ dsum, float* __restrict__ part, int C, int M, PairConsts k) {
  phase2_raw(TableRows{cnt, nbr, x, y, z, lam, C, M}, cnt, x, y, z, lam, dsum, part, M, k);
}

// Replaces the Pallas kernel fluidnexus_tpu/sim/pbf_pallas.py:_phase2_kernel
// (wrapper phase2_slots), which reads the neighbour lambdas from a (C, 27, M)
// tensor gathered before the launch, as this kernel does (lng). Bound on the
// H100: the operations of v2 against one read of the occupied rows' gathered
// coordinate and lambda blocks. Same walk as v2.
__global__ void __launch_bounds__(MAX_M) phase2_v1_kernel(
    const int* __restrict__ cnt, const int* __restrict__ ncnt, const float* __restrict__ xng,
    const float* __restrict__ lng, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ lam, float* __restrict__ dsum,
    float* __restrict__ part, int M, PairConsts k) {
  phase2_raw(GatheredRows{ncnt, xng, lng, M}, cnt, x, y, z, lam, dsum, part, M, k);
}

// ---------------------------------------------------------------------------
// Gas-loss density. Replaces the Pallas kernel
// fluidnexus_tpu/sim/pbf_pallas.py:_density_kernel_v2 (wrapper
// density_slots_v2). Per live slot: pi = sum over every live slot s of the 27
// neighbour cells, itself included, of c6 (h^2 - d2)^3 where d2 < h^2; the
// self pair has d2 = 0 and adds c6 h^6. Dead slots and row C write 0.
//
// Bound on the H100: 9 f32 operations per live candidate pair (the shifted
// difference, d2 and the test) and 5 more per pair in radius, against one
// read of three coordinate planes and one written plane: bound by operations.
// Same design as phase 1 (one block per row, one thread per centre slot,
// each neighbour row staged once in shared memory), with one accumulator.
// d2 is formed without FMA, as in phases 1 and 2, so the kernel and its plain
// version take the same pairs; the power (h^2 - d2)^3 is left to the
// compiler: it goes to 0 at d2 = h^2, so a flip at the threshold moves pi by
// nothing measurable.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) density_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, float* __restrict__ pi, int C, int M,
    float h, float h2, float c6) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M];
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cnt[cell];
  if (n_c == 0) {
    if (i < M) pi[at] = 0.0f;
    return;
  }
  const bool live = i < n_c;
  const float xc = live ? x[at] : 0.0f, yc = live ? y[at] : 0.0f, zc = live ? z[at] : 0.0f;
  float wa = 0.0f;
  for (int j = 0; j < 27; ++j) {
    const int nb = nbr[cell * 27 + j];
    if (nb >= C) continue;
    const int n_s = cnt[nb];
    if (n_s == 0) continue;
    __syncthreads();
    if (i < n_s) {
      const size_t src = (size_t)nb * M + i;
      sx[i] = __fadd_rn(x[src], shift(j, 0, h));
      sy[i] = __fadd_rn(y[src], shift(j, 1, h));
      sz[i] = __fadd_rn(z[src], shift(j, 2, h));
    }
    __syncthreads();
    if (!live) continue;
    const bool self_row = nb == cell;
    for (int s = 0; s < n_s; ++s) {
      const float d2 = (self_row && s == i)
                           ? 0.0f
                           : norm2_rn(__fsub_rn(xc, sx[s]), __fsub_rn(yc, sy[s]), __fsub_rn(zc, sz[s]));
      if (d2 < h2) {
        const float t2 = h2 - d2;
        wa += c6 * t2 * t2 * t2;
      }
    }
  }
  if (i < M) pi[at] = live ? wa : 0.0f;
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
// bound by operations. Same design as the forward; g is staged beside the
// shifted coordinates.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) density_bwd_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ g,
    float* __restrict__ dx, int C, int M, float h, float h2, float c6) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M], sg[MAX_M];
  const int cell = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)cell * M + i;
  const int n_c = cnt[cell];
  const bool live = i < n_c;
  const float xc = live ? x[at] : 0.0f, yc = live ? y[at] : 0.0f, zc = live ? z[at] : 0.0f;
  const float gc = live ? g[at] : 0.0f;
  const float c3 = -3.0f * c6;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int j = 0; j < 27 && n_c > 0; ++j) {
    const int nb = nbr[cell * 27 + j];
    if (nb >= C) continue;
    const int n_s = cnt[nb];
    if (n_s == 0) continue;
    __syncthreads();
    if (i < n_s) {
      const size_t src = (size_t)nb * M + i;
      sx[i] = __fadd_rn(x[src], shift(j, 0, h));
      sy[i] = __fadd_rn(y[src], shift(j, 1, h));
      sz[i] = __fadd_rn(z[src], shift(j, 2, h));
      sg[i] = g[src];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < n_s; ++s) {
      const float ex = __fsub_rn(xc, sx[s]), ey = __fsub_rn(yc, sy[s]), ez = __fsub_rn(zc, sz[s]);
      const float d2 = norm2_rn(ex, ey, ez);
      if (d2 < h2) {
        const float t2 = h2 - d2;
        const float b = (gc + sg[s]) * (c3 * t2 * t2) * 2.0f;
        a0 += b * ex;
        a1 += b * ey;
        a2 += b * ez;
      }
    }
  }
  if (i < M) {
    dx[3 * at] = live ? a0 : 0.0f;
    dx[3 * at + 1] = live ? a1 : 0.0f;
    dx[3 * at + 2] = live ? a2 : 0.0f;
  }
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
  phase1_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, imass, lam, pi_raw, nl, C, M,
      consts(h, h2, eps, c6, s45, inv_p0, relax, 0.0f, 0.0f, 0, 0.0f));
  return (int)cudaGetLastError();
}

int fnx_pbf_phase2(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                   const float* lam, const float* nc, float* xo, float* yo, float* zo, float* part,
                   int C, int M, float h, float h2, float eps, float c6, float s45, float k_p,
                   float e_p, int int_pow, float inv_denom, float inv_p0, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  phase2_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, lam, nc, xo, yo, zo, part, C, M,
      consts(h, h2, eps, c6, s45, inv_p0, 0.0f, k_p, e_p, int_pow, inv_denom));
  return (int)cudaGetLastError();
}

int fnx_pbf_phase1_v2(const int* cnt, const int* nbr, const float* x, const float* y,
                      const float* z, float* pi_raw, float* sg, float* c2d2, float* nlen, int C,
                      int M, float h, float h2, float eps, float c6, float s45, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  phase1_v2_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, pi_raw, sg, c2d2, nlen, C, M,
      consts(h, h2, eps, c6, s45, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0.0f));
  return (int)cudaGetLastError();
}

int fnx_pbf_phase2_v2(const int* cnt, const int* nbr, const float* x, const float* y,
                      const float* z, const float* lam, float* dsum, float* part, int C, int M,
                      float h, float h2, float eps, float c6, float s45, float k_p, float e_p,
                      int int_pow, float inv_denom, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  phase2_v2_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, lam, dsum, part, C, M,
      consts(h, h2, eps, c6, s45, 0.0f, 0.0f, k_p, e_p, int_pow, inv_denom));
  return (int)cudaGetLastError();
}

int fnx_pbf_phase1_v1(const int* cnt, const int* ncnt, const float* xng, const float* x,
                      const float* y, const float* z, float* pi_raw, float* sg, float* c2d2,
                      float* nlen, int C, int M, float h, float h2, float eps, float c6, float s45,
                      void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  phase1_v1_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, ncnt, xng, x, y, z, pi_raw, sg, c2d2, nlen, M,
      consts(h, h2, eps, c6, s45, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0.0f));
  return (int)cudaGetLastError();
}

int fnx_pbf_phase2_v1(const int* cnt, const int* ncnt, const float* xng, const float* lng,
                      const float* x, const float* y, const float* z, const float* lam,
                      float* dsum, float* part, int C, int M, float h, float h2, float eps,
                      float c6, float s45, float k_p, float e_p, int int_pow, float inv_denom,
                      void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  phase2_v1_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, ncnt, xng, lng, x, y, z, lam, dsum, part, M,
      consts(h, h2, eps, c6, s45, 0.0f, 0.0f, k_p, e_p, int_pow, inv_denom));
  return (int)cudaGetLastError();
}

int fnx_pbf_density(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                    float* pi, int C, int M, float h, float h2, float c6, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  density_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(cnt, nbr, x, y, z, pi, C, M, h,
                                                                     h2, c6);
  return (int)cudaGetLastError();
}

int fnx_pbf_density_bwd(const int* cnt, const int* nbr, const float* x, const float* y,
                        const float* z, const float* g, float* dx, int C, int M, float h, float h2,
                        float c6, void* stream) {
  if (bad_shape(C, M)) return (int)cudaErrorInvalidValue;
  density_bwd_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(cnt, nbr, x, y, z, g, dx,
                                                                         C, M, h, h2, c6);
  return (int)cudaGetLastError();
}

}  // extern "C"
