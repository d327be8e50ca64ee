// Position-based-fluid density kernels for Hopper (sm_90a): the two pair
// passes of one Jacobi projection over the dense cell grid, and the gas
// loss's density and its adjoint. Plain C interface, loaded with ctypes by
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
//   Every per-slot input and output is a (C+1, M) plane.
// One block per row, one thread per centre slot; dead slots and rows are
// masked by cnt, so no sentinel coordinates are needed.
//
// Pair math, that of fluidnexus_tpu/sim/pbf_pallas.py:_pair_wcg_cols, for a
// centre slot i and a live slot s of neighbour cell j:
//   d2 = |x_i - (x_s + o_j h)|^2 by direct subtraction, each step rounded to
//        nearest with no fused multiply-add, so the in-radius test d2 <= h^2
//        is decided bit for bit as the plain version decides it;
//   w  = c6 (h^2 - d2)^3 where d2 < h^2;
//   inv = rsqrt(d2 + eps), rlen = (d2 + eps) inv,
//   cg = -s45 (h - rlen)^2 inv where rlen < h;
//   the self pair (the same row and slot) has d2 = 0 and cg = 0.

#include <cuda_runtime.h>

#include "pair_common.cuh"

namespace {

using fnx::MAX_M;
using fnx::norm2_rn;
using fnx::shift;
using fnx::threads_for;

constexpr unsigned FULL_MASK = 0xffffffffu;

struct Pair {
  float d2, w, cg;
};

__device__ __forceinline__ Pair pair_terms(float xc, float yc, float zc, float xs, float ys, float zs,
                                           bool self, float h, float h2, float eps, float c6,
                                           float s45) {
  Pair p;
  const float dx = __fsub_rn(xc, xs), dy = __fsub_rn(yc, ys), dz = __fsub_rn(zc, zs);
  p.d2 = self ? 0.0f : norm2_rn(dx, dy, dz);
  const float t2 = h2 - p.d2;
  p.w = p.d2 < h2 ? c6 * t2 * t2 * t2 : 0.0f;
  const float de = p.d2 + eps;
  const float inv = rsqrtf(de);
  const float rlen = de * inv;
  const float hr = h - rlen;
  p.cg = (rlen < h && !self) ? -s45 * hr * hr * inv : 0.0f;
  return p;
}

// ---------------------------------------------------------------------------
// Phase 1. Replaces the Pallas kernel
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
    float h, float h2, float eps, float c6, float s45, float inv_p0, float relax) {
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
  float wa = 0.0f, cga = 0.0f, c2a = 0.0f, nla = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
  for (int j = 0; j < 27; ++j) {
    const int nb = nbr[cell * 27 + j];
    if (nb >= C) continue;  // no such cell: the same for the whole block
    const int n_s = cnt[nb];
    if (n_s == 0) continue;
    __syncthreads();  // the previous row is consumed
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
      const Pair p = pair_terms(xc, yc, zc, sx[s], sy[s], sz[s], self_row && s == i, h, h2, eps, c6, s45);
      wa += p.w;
      cga += p.cg;
      c2a += p.cg * p.cg * p.d2;
      nla += p.d2 <= h2 ? 1.0f : 0.0f;
      bx += p.cg * sx[s];
      by += p.cg * sy[s];
      bz += p.cg * sz[s];
    }
  }
  if (i >= M) return;
  if (!live) {
    lam[at] = pi_raw[at] = nl[at] = 0.0f;
    return;
  }
  const float sg0 = cga * xc - bx, sg1 = cga * yc - by, sg2 = cga * zc - bz;
  const float ip2 = inv_p0 * inv_p0;
  const float gr_dot = (sg0 * sg0 + sg1 * sg1 + sg2 * sg2) * ip2;
  const float p_ratio = wa / imass[at] * inv_p0;
  lam[at] = -(p_ratio - 1.0f) / (c2a * ip2 + gr_dot + relax);
  pi_raw[at] = wa;
  nl[at] = nla;
}

// ---------------------------------------------------------------------------
// Phase 2. Replaces the Pallas kernel
// fluidnexus_tpu/sim/pbf_pallas.py:_phase2_kernel_v3 (wrapper phase2_slots_v3).
// Per live slot, over its non-self pairs:
//   corr = -k_p (w / w(dq))^e_p, b = (lambda_i + lambda_s + corr) cg,
//   x_new = x_i + ((sum b) x_i - sum b x_s) / p0 / max(nc_i, 1e-20),
// where nc = nl + counts. It writes the UPDATED coordinates, not the deltas;
// dead slots and empty rows keep their input coordinates. Each row also
// writes its partial sums of corr and of the non-self in-radius count over
// its live slots, part[row] = (s_corr, s_ns): the caller adds the rows up, so
// the global sums need no float atomics and come out the same every run.
//
// Bound on the H100: as phase 1, ~35 f32 operations per live candidate pair
// against one read of four planes and one write of three: bound by
// operations. Same design as phase 1; lambda is staged beside the shifted
// coordinates, and the row's two partial sums are reduced by warp shuffles
// and one shared-memory pass over the block's warps.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) phase2_kernel(
    const int* __restrict__ cnt, const int* __restrict__ nbr, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ lam,
    const float* __restrict__ nc, float* __restrict__ xo, float* __restrict__ yo,
    float* __restrict__ zo, float* __restrict__ part, int C, int M, float h, float h2, float eps,
    float c6, float s45, float k_p, float e_p, int int_pow, float inv_denom, float inv_p0) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M], sl[MAX_M];
  __shared__ float red[2][MAX_M / 32];
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
  float ba = 0.0f, cra = 0.0f, nsa = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
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
      sl[i] = lam[src];
    }
    __syncthreads();
    if (!live) continue;
    const bool self_row = nb == cell;
    for (int s = 0; s < n_s; ++s) {
      const bool self = self_row && s == i;
      const Pair p = pair_terms(xc, yc, zc, sx[s], sy[s], sz[s], self, h, h2, eps, c6, s45);
      const float wd = (self ? 0.0f : p.w) * inv_denom;
      float pw;
      if (int_pow > 0) {
        pw = wd;
        for (int e = 1; e < int_pow; ++e) pw *= wd;
      } else {
        pw = powf(wd, e_p);
      }
      const float corr = -k_p * pw;
      const float b = (lc + sl[s] + corr) * p.cg;
      const float ns = (p.d2 <= h2 && !self) ? 1.0f : 0.0f;
      ba += b;
      cra += corr * ns;
      nsa += ns;
      bx += b * sx[s];
      by += b * sy[s];
      bz += b * sz[s];
    }
  }
  if (i < M) {
    if (live) {
      const float scale = inv_p0 / fmaxf(nc[at], 1e-20f);
      xo[at] = xc + (ba * xc - bx) * scale;
      yo[at] = yc + (ba * yc - by) * scale;
      zo[at] = zc + (ba * zc - bz) * scale;
    } else {
      xo[at] = x[at];
      yo[at] = y[at];
      zo[at] = z[at];
    }
  }
  // the row's partial sums: dead threads hold 0
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

}  // namespace

extern "C" {

int fnx_pbf_max_m() { return MAX_M; }

int fnx_pbf_phase1(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                   const float* imass, float* lam, float* pi_raw, float* nl, int C, int M, float h,
                   float h2, float eps, float c6, float s45, float inv_p0, float relax, void* stream) {
  if (C < 0 || M <= 0 || M > MAX_M) return (int)cudaErrorInvalidValue;
  phase1_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, imass, lam, pi_raw, nl, C, M, h, h2, eps, c6, s45, inv_p0, relax);
  return (int)cudaGetLastError();
}

int fnx_pbf_phase2(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                   const float* lam, const float* nc, float* xo, float* yo, float* zo, float* part,
                   int C, int M, float h, float h2, float eps, float c6, float s45, float k_p,
                   float e_p, int int_pow, float inv_denom, float inv_p0, void* stream) {
  if (C < 0 || M <= 0 || M > MAX_M) return (int)cudaErrorInvalidValue;
  phase2_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(
      cnt, nbr, x, y, z, lam, nc, xo, yo, zo, part, C, M, h, h2, eps, c6, s45, k_p, e_p, int_pow,
      inv_denom, inv_p0);
  return (int)cudaGetLastError();
}

int fnx_pbf_density(const int* cnt, const int* nbr, const float* x, const float* y, const float* z,
                    float* pi, int C, int M, float h, float h2, float c6, void* stream) {
  if (C < 0 || M <= 0 || M > MAX_M) return (int)cudaErrorInvalidValue;
  density_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(cnt, nbr, x, y, z, pi, C, M, h,
                                                                     h2, c6);
  return (int)cudaGetLastError();
}

int fnx_pbf_density_bwd(const int* cnt, const int* nbr, const float* x, const float* y,
                        const float* z, const float* g, float* dx, int C, int M, float h, float h2,
                        float c6, void* stream) {
  if (C < 0 || M <= 0 || M > MAX_M) return (int)cudaErrorInvalidValue;
  density_bwd_kernel<<<C + 1, threads_for(M), 0, (cudaStream_t)stream>>>(cnt, nbr, x, y, z, g, dx,
                                                                         C, M, h, h2, c6);
  return (int)cudaGetLastError();
}

}  // extern "C"
