// The two-set velocity splat for Hopper (sm_90a): the forward and the adjoint
// of the differentiable advection of visual particles (queries) by the hidden
// particles (sources). Plain C interface, loaded with ctypes by
// fluidnexus_torch/sim/splat_cuda.py, which also holds each kernel's plain
// PyTorch version.
//
// Layout (fluidnexus_torch/ops/neighbors.DenseGrid and bin_queries): the
// source grid has Cs rows and the empty row Cs, Ms slots a row; the query grid
// Cq rows and the empty row Cq, Mq slots a row; both sit on one lattice of
// cells of edge h. Per grid: cnt (C+1,) i32 live slots per row (front
// compacted, cnt[C] = 0) and x, y, z (C+1, M) f32 cell-relative coordinates.
//   qnbr (Cq, 27) i32: each query row's 27 neighbour rows in the source
//     table, Cs where there is none;
//   rnbr (Cs, 27) i32: each source row's 27 neighbour rows in the query
//     table, Cq where there is none;
//   neighbour j sits at cell offset (j/9 - 1, (j/3)%3 - 1, j%3 - 1), so a
//   neighbour's coordinate relative to the centre cell is its own plus o_j h.
// Per-slot vectors are (C+1, M, 3) f32. One block per centre row, one thread
// per centre slot; dead slots and rows are masked by cnt, so no sentinel
// coordinates are needed, and every output is 0 at dead slots.
//
// Pair math, that of fluidnexus_tpu/sim/pbf_pallas.py:_splat_fwd_kernel and
// _splat_bwd_kernel: d2 = |x_c - (x_n + o_j h)|^2 formed without FMA, as the
// plain version forms it; W = (h^2 - d2)^3 and W' = -3 (h^2 - d2)^2 where
// d2 < h^2, without the poly6 coefficient (the caller applies it). The two
// sets are distinct, so there is no self pair. Both W and W' go to 0 at
// d2 = h^2, so a pair that flips at the threshold moves no value; past d2 the
// compiler may fuse multiply-adds.
//
// Bound on the H100: each live candidate pair costs 9 f32 operations for d2
// and the test, and a pair in radius 10 more (forward) or 24 (adjoint),
// against the bytes the function must move: the forward reads the query
// slots and only the source rows its occupied query rows reach, and writes
// wv and ws; the adjoint reads only the source rows that have a query in
// reach and the query rows they reach, and writes both gradients of every
// live source. Which of the two bounds depends on how the sets overlap;
// chip_smoke.py counts both from the run's grids. The design
// stages each neighbour row, shifted by its offset, in
// shared memory once per block and keeps every per-slot sum in registers.
// No float atomics: each output is written by the one thread that owns it.

#include <cuda_runtime.h>

#include "pair_common.cuh"

namespace {

using fnx::MAX_M;   // slots per cell row in either grid
using fnx::norm2_rn;
using fnx::shift;
using fnx::threads_for;

// ---------------------------------------------------------------------------
// Forward. Replaces fluidnexus_tpu/sim/pbf_pallas.py:_splat_fwd_kernel
// (wrapper splat_slots). Per live query slot, over the live source slots of
// its 27 neighbour cells: wv = sum W vel_s (3) and ws = sum W.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) splat_fwd_kernel(
    const int* __restrict__ qcnt, const int* __restrict__ qnbr, const float* __restrict__ xq,
    const float* __restrict__ yq, const float* __restrict__ zq, const int* __restrict__ scnt,
    const float* __restrict__ xs, const float* __restrict__ ys, const float* __restrict__ zs,
    const float* __restrict__ vel, float* __restrict__ wv, float* __restrict__ ws, int Cq, int Mq,
    int Cs, int Ms, float h, float h2) {
  __shared__ float sx[MAX_M], sy[MAX_M], sz[MAX_M], sv0[MAX_M], sv1[MAX_M], sv2[MAX_M];
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)row * Mq + i;
  const int n_c = qcnt[row];
  const bool live = i < n_c;
  const float xc = live ? xq[at] : 0.0f, yc = live ? yq[at] : 0.0f, zc = live ? zq[at] : 0.0f;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, aw = 0.0f;
  for (int j = 0; j < 27 && n_c > 0; ++j) {
    const int nb = qnbr[row * 27 + j];
    if (nb >= Cs) continue;  // the same for the whole block
    const int n_s = scnt[nb];
    if (n_s == 0) continue;
    __syncthreads();  // the previous row is consumed
    for (int s = i; s < n_s; s += blockDim.x) {
      const size_t src = (size_t)nb * Ms + s;
      sx[s] = __fadd_rn(xs[src], shift(j, 0, h));
      sy[s] = __fadd_rn(ys[src], shift(j, 1, h));
      sz[s] = __fadd_rn(zs[src], shift(j, 2, h));
      sv0[s] = vel[3 * src];
      sv1[s] = vel[3 * src + 1];
      sv2[s] = vel[3 * src + 2];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < n_s; ++s) {
      const float d2 = norm2_rn(__fsub_rn(xc, sx[s]), __fsub_rn(yc, sy[s]), __fsub_rn(zc, sz[s]));
      if (d2 < h2) {
        const float t2 = h2 - d2;
        const float w = t2 * t2 * t2;
        aw += w;
        a0 += w * sv0[s];
        a1 += w * sv1[s];
        a2 += w * sv2[s];
      }
    }
  }
  if (i < Mq) {
    wv[3 * at] = live ? a0 : 0.0f;
    wv[3 * at + 1] = live ? a1 : 0.0f;
    wv[3 * at + 2] = live ? a2 : 0.0f;
    ws[at] = live ? aw : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Adjoint. Replaces fluidnexus_tpu/sim/pbf_pallas.py:_splat_bwd_kernel
// (wrapper splat_bwd_slots). With the per-query planes p (3) and q that the
// caller forms from the cotangent (c6 folded in), the pair factor is
// f = <p_i, vel_s> - q_i, and per live source slot, over the live query slots
// of its 27 neighbour cells (read through rnbr):
//   g_est = sum_i 2 f W'(d2) (x_s - x_i),   g_vel = sum_i W p_i.
// Each pair adds its term directly, where the Pallas kernel forms
// (sum f W') x_s - sum f W' x_i.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_M) splat_bwd_kernel(
    const int* __restrict__ scnt, const int* __restrict__ rnbr, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ zs, const float* __restrict__ vel,
    const int* __restrict__ qcnt, const float* __restrict__ xq, const float* __restrict__ yq,
    const float* __restrict__ zq, const float* __restrict__ p, const float* __restrict__ q,
    float* __restrict__ gx, float* __restrict__ gv, int Cs, int Ms, int Cq, int Mq, float h,
    float h2) {
  __shared__ float qx[MAX_M], qy[MAX_M], qz[MAX_M], p0[MAX_M], p1[MAX_M], p2[MAX_M], qq[MAX_M];
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  const size_t at = (size_t)row * Ms + i;
  const int n_c = scnt[row];
  const bool live = i < n_c;
  const float xc = live ? xs[at] : 0.0f, yc = live ? ys[at] : 0.0f, zc = live ? zs[at] : 0.0f;
  const float v0 = live ? vel[3 * at] : 0.0f, v1 = live ? vel[3 * at + 1] : 0.0f,
              v2 = live ? vel[3 * at + 2] : 0.0f;
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int j = 0; j < 27 && n_c > 0; ++j) {
    const int nb = rnbr[row * 27 + j];
    if (nb >= Cq) continue;
    const int n_q = qcnt[nb];
    if (n_q == 0) continue;
    __syncthreads();
    for (int s = i; s < n_q; s += blockDim.x) {
      const size_t src = (size_t)nb * Mq + s;
      qx[s] = __fadd_rn(xq[src], shift(j, 0, h));
      qy[s] = __fadd_rn(yq[src], shift(j, 1, h));
      qz[s] = __fadd_rn(zq[src], shift(j, 2, h));
      p0[s] = p[3 * src];
      p1[s] = p[3 * src + 1];
      p2[s] = p[3 * src + 2];
      qq[s] = q[src];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < n_q; ++s) {
      const float dx = __fsub_rn(xc, qx[s]), dy = __fsub_rn(yc, qy[s]), dz = __fsub_rn(zc, qz[s]);
      const float d2 = norm2_rn(dx, dy, dz);
      if (d2 < h2) {
        const float t2 = h2 - d2;
        const float w = t2 * t2 * t2;
        const float fd = (v0 * p0[s] + v1 * p1[s] + v2 * p2[s] - qq[s]) * (-3.0f * t2 * t2);
        e0 += fd * dx;
        e1 += fd * dy;
        e2 += fd * dz;
        g0 += w * p0[s];
        g1 += w * p1[s];
        g2 += w * p2[s];
      }
    }
  }
  if (i < Ms) {
    gx[3 * at] = live ? 2.0f * e0 : 0.0f;
    gx[3 * at + 1] = live ? 2.0f * e1 : 0.0f;
    gx[3 * at + 2] = live ? 2.0f * e2 : 0.0f;
    gv[3 * at] = live ? g0 : 0.0f;
    gv[3 * at + 1] = live ? g1 : 0.0f;
    gv[3 * at + 2] = live ? g2 : 0.0f;
  }
}

}  // namespace

extern "C" {

int fnx_splat_max_m() { return MAX_M; }

int fnx_splat_fwd(const int* qcnt, const int* qnbr, const float* xq, const float* yq,
                  const float* zq, const int* scnt, const float* xs, const float* ys,
                  const float* zs, const float* vel, float* wv, float* ws, int Cq, int Mq, int Cs,
                  int Ms, float h, float h2, void* stream) {
  if (Cq < 0 || Cs < 0 || Mq <= 0 || Mq > MAX_M || Ms <= 0 || Ms > MAX_M)
    return (int)cudaErrorInvalidValue;
  splat_fwd_kernel<<<Cq + 1, threads_for(Mq), 0, (cudaStream_t)stream>>>(
      qcnt, qnbr, xq, yq, zq, scnt, xs, ys, zs, vel, wv, ws, Cq, Mq, Cs, Ms, h, h2);
  return (int)cudaGetLastError();
}

int fnx_splat_bwd(const int* scnt, const int* rnbr, const float* xs, const float* ys,
                  const float* zs, const float* vel, const int* qcnt, const float* xq,
                  const float* yq, const float* zq, const float* p, const float* q, float* gx,
                  float* gv, int Cs, int Ms, int Cq, int Mq, float h, float h2, void* stream) {
  if (Cq < 0 || Cs < 0 || Mq <= 0 || Mq > MAX_M || Ms <= 0 || Ms > MAX_M)
    return (int)cudaErrorInvalidValue;
  splat_bwd_kernel<<<Cs + 1, threads_for(Ms), 0, (cudaStream_t)stream>>>(
      scnt, rnbr, xs, ys, zs, vel, qcnt, xq, yq, zq, p, q, gx, gv, Cs, Ms, Cq, Mq, h, h2);
  return (int)cudaGetLastError();
}

}  // extern "C"
