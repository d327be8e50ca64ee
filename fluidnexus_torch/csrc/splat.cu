// The two-set velocity splat for Hopper (sm_90a): the forward and the adjoint
// of the differentiable advection of visual particles (queries) by the hidden
// particles (sources). Plain C interface, loaded with ctypes by
// fluidnexus_torch/sim/splat_cuda.py, which also holds each kernel's plain
// PyTorch version.
//
// Layout. The sources (fluidnexus_torch/ops/neighbors.DenseGrid): Cs rows
// and the empty row Cs, Ms slots a row; scnt (Cs+1,) i32 live slots per row
// (front compacted, scnt[Cs] = 0), xs, ys, zs (Cs+1, Ms) f32 cell-relative
// coordinates, vel and both gradients (Cs+1, Ms, 3). The queries
// (ops/neighbors.QueryList, sort_queries): one list of Nq points sorted by
// cell, query row h's points at entries qstart[h] .. qstart[h] + qcnt[h] - 1
// with no cap on qcnt[h]; Cq rows; xq, yq, zq (Nq,) f32 cell-relative
// coordinates, p (Nq, 3) and q (Nq,) per entry. Both sets sit on one
// lattice of cells of edge h.
//   qnbr (Cq, 27) i32: each query row's 27 neighbour rows in the source
//     table, Cs where there is none;
//   rnbr (Cs, 27) i32: each source row's 27 neighbour rows in the query
//     list, Cq where there is none;
//   neighbour j sits at cell offset (j/9 - 1, (j/3)%3 - 1, j%3 - 1), so a
//   neighbour's coordinate relative to the centre cell is its own plus o_j h.
// Dead source slots are masked by scnt and entries past the rows by qcnt, so
// no sentinel coordinates are needed.
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
// against the bytes the function must move: the forward reads the listed
// queries and only the source rows their rows reach, and writes wv and ws;
// the adjoint reads only the source rows that have a query in reach and the
// query rows they reach, and writes both gradients of every live source.
// Which of the two bounds depends on how the sets overlap; chip_smoke.py
// counts both from the run's inputs. Both kernels stage one set's lists
// (pair_common.cuh) and keep every per-point sum in registers. No float
// atomics: each output is written by the one thread that owns it.

#include <cuda_runtime.h>

#include "pair_common.cuh"

namespace {

using fnx::GROUP_CPL;
using fnx::GROUP_LANES;
using fnx::GROUP_ROWS;
using fnx::GROUP_WARPS;
using fnx::MAX_M;   // slots per cell row of the source grid
using fnx::norm2_rn;
constexpr unsigned FULL_MASK = 0xffffffffu;

// ---------------------------------------------------------------------------
// Forward. Replaces fluidnexus_tpu/sim/pbf_pallas.py:_splat_fwd_kernel
// (wrapper splat_slots). Per listed query, over the live source slots of its
// 27 neighbour cells (read through qnbr, Cs = none): wv = sum W vel_s (3)
// and ws = sum W, written as one float4 (wv, ws) an entry; entry Nq is
// written 0, for the callers' queries of no row.
//
// Design. On the main path only ~141 of the 4 097 query rows hold a query,
// so the work items are the rows' chunks of 32 queries, ceil(qcnt/32) a row,
// a warp each: a pile of 1 000 queries in one cell runs as 32 warps side by
// side, not as 32 passes of one. chunk_ends_kernel, launched just before
// (one block), writes the chunks' running count over the rows (ends,
// inclusive); the launch has a warp for each of at most
// min(Cq, Nq) + ceil(Nq / 32) chunks, the surplus leaves at once, and a warp
// finds its row by a 32-ary search of ends (find_row: three rounds of loads
// at Cq = 4 096). Then the row design of the gas loss's density (pbf.cu,
// pair_common.cuh): the warp reads the 27 source rows' ids and counts in two
// trips (load_nbr_table), stages the source list in chunks of SPF_CHUNK
// entries, in one round of loads, as two float4 lists, (x, y, z shifted, 0)
// and (v0, v1, v2, 0) (stage_chunk's VEC3: no fourth plane is loaded), and
// runs one branch-free pair loop over it, a lane to a query; the warp's trip
// count is its row's list, so no far entry is staged. Out of radius W is
// selected to 0, which leaves a sum's bits as they are. Each query adds the
// terms of the walk over rows in its order (neighbour, then slot), each
// a += W v by one FMA as the walk's `a += w * v` compiled, so the kernel is
// bit for bit the walk's. Why a warp to 32 queries, where the density gives
// a row half a warp: the live query rows hold up to 32 queries over lists of
// up to 234 sources (PERF.md), and their serial loops set the kernel's time;
// in half a warp a lane of a full row held two queries and ran twice the
// instructions an entry (0.0114 ms against 0.0078 on the H100). A query with
// no source in reach gets 0; entries past the rows are not written.
// ---------------------------------------------------------------------------
constexpr int SPF_ROWS = GROUP_WARPS;       // work items a block: a warp each
constexpr int SPF_QUERIES = 32;             // queries a work item: a lane each
constexpr int SPF_CHUNK = 256;              // source list entries a row stages at once
constexpr int SPF_ROUND = SPF_CHUNK / 32;   // a whole chunk in one round of loads

size_t splat_fwd_smem() { return (size_t)SPF_ROWS * SPF_CHUNK * 2 * sizeof(float4); }

// ends[h] = the chunks of SPF_QUERIES queries in rows 0 .. h, for the Cq
// rows, in one block: a tile of SCAN_THREADS rows at a time, scanned by warp
// shuffles and a second scan of the warps' sums, with the tiles' carry.
constexpr int SCAN_THREADS = 1024;

__global__ void __launch_bounds__(SCAN_THREADS) chunk_ends_kernel(const int* __restrict__ qcnt,
                                                                  int* __restrict__ ends, int Cq) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  int carry = 0;
  for (int base = 0; base < Cq; base += SCAN_THREADS) {
    const int row = base + threadIdx.x;
    int x = row < Cq ? (qcnt[row] + SPF_QUERIES - 1) / SPF_QUERIES : 0;
    for (int o = 1; o < 32; o <<= 1) {  // inclusive scan within the warp
      const int t = __shfl_up_sync(FULL_MASK, x, o);
      if (lane >= o) x += t;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {  // inclusive scan of the warps' sums
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL_MASK, w, o);
        if (lane >= o) w += t;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (row < Cq) ends[row] = carry + (wid > 0 ? warp_sums[wid - 1] : 0) + x;
    carry += warp_sums[31];
    __syncthreads();  // the sums are read before the next tile writes them
  }
}

// The first of the n rows whose ends[row] exceeds the work item w (ends
// ascending, w < ends[n - 1]): a 32-ary search, lane sub probing the last
// row of segment sub of the range left, the whole warp in step.
__device__ __forceinline__ int find_row(const int* __restrict__ ends, int n, int w, int sub) {
  int lo = 0, len = n;  // the row lies in [lo, lo + len)
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int probe = lo + (sub + 1) * step - 1;
    const bool past = probe < lo + len - 1 && ends[probe] <= w;  // the row lies past segment sub
    const int c = __popc(__ballot_sync(FULL_MASK, past));
    lo += c * step;
    len = min(step, len - c * step);
  }
  return lo;
}

// The pair loop over kn staged source entries for a lane's query: no
// branch, so the compiler can overlap the iterations.
__device__ __forceinline__ void splat_fwd_sweep(const float4* xl, const float4* vl, int kn,
                                                float xc, float yc, float zc, float& a0,
                                                float& a1, float& a2, float& aw, float h2) {
#pragma unroll 8
  for (int k = 0; k < kn; ++k) {
    const float4 s = xl[k], v = vl[k];
    const float d2 = norm2_rn(__fsub_rn(xc, s.x), __fsub_rn(yc, s.y), __fsub_rn(zc, s.z));
    const float t2 = h2 - d2;
    const float w = d2 < h2 ? t2 * t2 * t2 : 0.0f;
    aw += w;
    a0 += w * v.x;
    a1 += w * v.y;
    a2 += w * v.z;
  }
}

__global__ void __launch_bounds__(GROUP_WARPS * 32) splat_fwd_kernel(
    const int* __restrict__ ends, const int* __restrict__ qstart, const int* __restrict__ qcnt,
    const int* __restrict__ qnbr, const float* __restrict__ xq, const float* __restrict__ yq,
    const float* __restrict__ zq, const int* __restrict__ scnt, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ zs, const float* __restrict__ vel,
    float4* __restrict__ out, int Cq, int Nq, int Cs, int Ms, float h, float h2) {
  extern __shared__ float4 spf_lists[];  // [SPF_ROWS][2][SPF_CHUNK]
  __shared__ fnx::NbrTable tabs[SPF_ROWS];
  const int grp = threadIdx.x / 32;
  const int sub = threadIdx.x % 32;
  const int w = blockIdx.x * SPF_ROWS + grp;  // the work item
  if (blockIdx.x == 0 && threadIdx.x == 0) out[Nq] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (Cq == 0 || w >= ends[Cq - 1]) return;  // the surplus: the same for the whole warp
  const int row = find_row(ends, Cq, w, sub);
  const int n_c = qcnt[row];
  const int i0 = (w - (ends[row] - (n_c + SPF_QUERIES - 1) / SPF_QUERIES)) * SPF_QUERIES;
  const int left = n_c - i0;  // the chunk's queries: 1 to 32 from lane 0
  const bool live = sub < left;
  const size_t e = (size_t)qstart[row] + i0 + sub;
  float4* xl = spf_lists + grp * 2 * SPF_CHUNK;
  float4* vl = xl + SPF_CHUNK;
  const fnx::PlaneSource src{qnbr, scnt, xs, ys, zs, nullptr, vel, Cs, Ms};
  const int n_tot = fnx::load_nbr_table<32>(tabs[grp], src, row, sub, true);
  const float xc = live ? xq[e] : 0.0f, yc = live ? yq[e] : 0.0f, zc = live ? zq[e] : 0.0f;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, aw = 0.0f;
  for (int c0 = 0; c0 < n_tot; c0 += SPF_CHUNK) {
    const int kn = min(SPF_CHUNK, n_tot - c0);
    fnx::stage_chunk<32, SPF_CHUNK, SPF_ROUND, fnx::VEC3>(xl, tabs[grp], c0, n_tot, kn, src, h,
                                                          sub, vl);
    splat_fwd_sweep(xl, vl, kn, xc, yc, zc, a0, a1, a2, aw, h2);
    __syncwarp();  // the chunk is consumed before the next one is staged
  }
  if (live) out[e] = make_float4(a0, a1, a2, aw);
}

// ---------------------------------------------------------------------------
// Adjoint. Replaces fluidnexus_tpu/sim/pbf_pallas.py:_splat_bwd_kernel
// (wrapper splat_bwd_slots). With the per-query planes p (3) and q that the
// caller forms from the cotangent (c6 folded in), the pair factor is
// f = <p_i, vel_s> - q_i, and per live source slot, over the listed queries
// of its 27 neighbour cells (read through rnbr):
//   g_est = sum_i 2 f W'(d2) (x_s - x_i),   g_vel = sum_i W p_i.
// Each pair adds its term directly, where the Pallas kernel forms
// (sum f W') x_s - sum f W' x_i.
//
// Design: the forward's, from the source side, with half a warp to a row (a
// group of GROUP_LANES lanes, two rows a warp: the source rows hold ~8 live
// slots). A group reads the 27 query rows' ids (rnbr, Cq = none) and then
// their counts and first entries (fnx::ListSource); on the main path only
// ~1 source row in 6 has a query in reach, and the rest write their row's
// zeros (a warp whose two rows have none leaves there). The others stage the
// query lists, any length (a source row beside a pile of 1 000 queries walks
// four chunks), in chunks of
// SPB_CHUNK entries as two float4 lists, (x, y, z shifted, q) and (p0, p1,
// p2, 0) (stage_chunk's W_VEC3), and run one branch-free pair loop over it; a
// centre keeps its x, y, z and vel in registers, with six accumulators. Out
// of radius and at a far entry (d2 = inf, h^2 - d2 = -inf, -3 t2 t2 = inf;
// its p and q are 0) the pair's factors f W' and W are selected to 0, never
// multiplied by 0, so the sums keep their bits and each slot adds the terms
// of the walk over rows in its order (neighbour row, then lowest point index
// first).
// Every output slot is written: dead slots, live sources with no query in
// reach and row Cs get 0.
// ---------------------------------------------------------------------------
constexpr int SPB_CHUNK = 256;                   // query list entries a row stages at once
constexpr int SPB_ROUND = SPB_CHUNK / GROUP_LANES;  // a whole chunk in one round of loads

size_t splat_bwd_smem() { return (size_t)GROUP_ROWS * SPB_CHUNK * 2 * sizeof(float4); }

// A source slot of a pass: its position and velocity, and its six sums.
struct Src {
  float x, y, z, v0, v1, v2;
  float e0, e1, e2, g0, g1, g2;
};

// The pair loop over kn staged query entries for the first NC source slots a
// lane holds: no branch, so the compiler can overlap the iterations.
template <int NC>
__device__ __forceinline__ void splat_bwd_sweep(const float4* xl, const float4* pl, int kn,
                                                Src (&c)[GROUP_CPL], float h2) {
#pragma unroll 8
  for (int k = 0; k < kn; ++k) {
    const float4 s = xl[k], p = pl[k];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      Src& a = c[i];
      const float dx = __fsub_rn(a.x, s.x), dy = __fsub_rn(a.y, s.y), dz = __fsub_rn(a.z, s.z);
      const float d2 = norm2_rn(dx, dy, dz);
      const float t2 = h2 - d2;
      const float w = d2 < h2 ? t2 * t2 * t2 : 0.0f;
      const float fd = d2 < h2 ? (a.v0 * p.x + a.v1 * p.y + a.v2 * p.z - s.w) * (-3.0f * t2 * t2)
                               : 0.0f;
      a.e0 += fd * dx;
      a.e1 += fd * dy;
      a.e2 += fd * dz;
      a.g0 += w * p.x;
      a.g1 += w * p.y;
      a.g2 += w * p.z;
    }
  }
}

__global__ void __launch_bounds__(GROUP_WARPS * 32) splat_bwd_kernel(
    const int* __restrict__ scnt, const int* __restrict__ rnbr, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ zs, const float* __restrict__ vel,
    const int* __restrict__ qstart, const int* __restrict__ qcnt, const float* __restrict__ xq,
    const float* __restrict__ yq, const float* __restrict__ zq, const float* __restrict__ p,
    const float* __restrict__ q, float* __restrict__ gx, float* __restrict__ gv, int Cs, int Ms,
    int Cq, float h, float h2) {
  extern __shared__ float4 spb_lists[];  // [GROUP_ROWS][2][SPB_CHUNK]
  __shared__ fnx::NbrTable tabs[GROUP_ROWS];
  const int grp = threadIdx.x / GROUP_LANES;
  const int sub = threadIdx.x % GROUP_LANES;
  const int row = blockIdx.x * GROUP_ROWS + grp;
  float4* xl = spb_lists + grp * 2 * SPB_CHUNK;
  float4* pl = xl + SPB_CHUNK;
  const fnx::ListSource src{rnbr, qstart, qcnt, xq, yq, zq, q, p, Cq};
  const int n_c = row <= Cs ? scnt[row] : 0;
  const int n_tot = fnx::load_nbr_table<GROUP_LANES>(tabs[grp], src, row, sub, row < Cs);
  const int n_w = n_tot > 0 ? n_c : 0;  // the live slots the pair loop writes
  if (row <= Cs) {  // the slots the pair loop does not write
    if (n_w == 0 && Ms % 4 == 0) {  // the row's every slot, 16 bytes a store (the entry checks alignment)
      float4* gx4 = reinterpret_cast<float4*>(gx + (size_t)3 * row * Ms);
      float4* gv4 = reinterpret_cast<float4*>(gv + (size_t)3 * row * Ms);
      for (int i = sub; i < 3 * Ms / 4; i += GROUP_LANES) gx4[i] = gv4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int i = n_w + sub; i < Ms; i += GROUP_LANES) {  // dead slots, or the row's every slot
        const size_t at = (size_t)row * Ms + i;
#pragma unroll
        for (int a = 0; a < 3; ++a) gx[3 * at + a] = gv[3 * at + a] = 0.0f;
      }
    }
  }
  const int list_max = __reduce_max_sync(FULL_MASK, n_w > 0 ? (unsigned)n_tot : 0u);
  if (list_max == 0) return;  // neither row of the warp has a query in reach
  const int passes = __reduce_max_sync(FULL_MASK, (unsigned)(n_w + 31) / 32);
  for (int pass = 0; pass < passes; ++pass) {
    const int left = n_w - pass * 32;  // this row's live centre slots from the pass on
    const int cpl = __reduce_max_sync(FULL_MASK, left > GROUP_LANES ? (unsigned)GROUP_CPL : 1u);
    bool live[GROUP_CPL];
    Src c[GROUP_CPL];
#pragma unroll
    for (int i = 0; i < GROUP_CPL; ++i) {
      const int s = sub + i * GROUP_LANES;
      const size_t at = (size_t)row * Ms + pass * 32 + s;
      live[i] = s < left;
      c[i].x = live[i] ? xs[at] : 0.0f;
      c[i].y = live[i] ? ys[at] : 0.0f;
      c[i].z = live[i] ? zs[at] : 0.0f;
      c[i].v0 = live[i] ? vel[3 * at] : 0.0f;
      c[i].v1 = live[i] ? vel[3 * at + 1] : 0.0f;
      c[i].v2 = live[i] ? vel[3 * at + 2] : 0.0f;
      c[i].e0 = c[i].e1 = c[i].e2 = c[i].g0 = c[i].g1 = c[i].g2 = 0.0f;
    }
    for (int c0 = 0; c0 < list_max; c0 += SPB_CHUNK) {
      const int kn = min(SPB_CHUNK, list_max - c0);  // the warp's trip count
      fnx::stage_chunk<GROUP_LANES, SPB_CHUNK, SPB_ROUND, fnx::W_VEC3>(
          xl, tabs[grp], c0, left > 0 ? n_tot : 0, kn, src, h, sub, pl);
      if (cpl == 1)
        splat_bwd_sweep<1>(xl, pl, kn, c, h2);
      else
        splat_bwd_sweep<GROUP_CPL>(xl, pl, kn, c, h2);
      __syncwarp();  // the chunk is consumed before the next one is staged
    }
#pragma unroll
    for (int i = 0; i < GROUP_CPL; ++i) {
      if (!live[i]) continue;
      const size_t at = (size_t)row * Ms + pass * 32 + sub + i * GROUP_LANES;
      gx[3 * at] = 2.0f * c[i].e0;
      gx[3 * at + 1] = 2.0f * c[i].e1;
      gx[3 * at + 2] = 2.0f * c[i].e2;
      gv[3 * at] = c[i].g0;
      gv[3 * at + 1] = c[i].g1;
      gv[3 * at + 2] = c[i].g2;
    }
  }
}

}  // namespace

extern "C" {

int fnx_splat_max_m() { return MAX_M; }

int fnx_splat_fwd(const int* qstart, const int* qcnt, const int* qnbr, const float* xq,
                  const float* yq, const float* zq, const int* scnt, const float* xs,
                  const float* ys, const float* zs, const float* vel, int* ends, float* out,
                  int Cq, int Nq, int Cs, int Ms, float h, float h2, void* stream) {
  if (Cq < 0 || Nq < 0 || Cs < 0 || Ms <= 0 || Ms > MAX_M || (size_t)out % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = splat_fwd_smem();
  cudaError_t err = cudaFuncSetAttribute(splat_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (Cq > 0) {
    chunk_ends_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(qcnt, ends, Cq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // a row of n queries has ceil(n / 32) chunks, so the rows' chunks number at
  // most the occupied rows (at most min(Cq, Nq)) plus Nq / 32
  const long work = (long)(Cq < Nq ? Cq : Nq) + (Nq + SPF_QUERIES - 1) / SPF_QUERIES;
  splat_fwd_kernel<<<(int)((work + SPF_ROWS - 1) / SPF_ROWS) + 1, GROUP_WARPS * 32, smem,
                     (cudaStream_t)stream>>>(ends, qstart, qcnt, qnbr, xq, yq, zq, scnt, xs, ys,
                                             zs, vel, reinterpret_cast<float4*>(out), Cq, Nq, Cs,
                                             Ms, h, h2);
  return (int)cudaGetLastError();
}

int fnx_splat_bwd(const int* scnt, const int* rnbr, const float* xs, const float* ys,
                  const float* zs, const float* vel, const int* qstart, const int* qcnt,
                  const float* xq, const float* yq, const float* zq, const float* p,
                  const float* q, float* gx, float* gv, int Cs, int Ms, int Cq, float h, float h2,
                  void* stream) {
  if (Cq < 0 || Cs < 0 || Ms <= 0 || Ms > MAX_M ||
      ((size_t)gx | (size_t)gv) % sizeof(float4) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = splat_bwd_smem();
  cudaError_t err = cudaFuncSetAttribute(splat_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  splat_bwd_kernel<<<Cs / GROUP_ROWS + 1, GROUP_WARPS * 32, smem, (cudaStream_t)stream>>>(
      scnt, rnbr, xs, ys, zs, vel, qstart, qcnt, xq, yq, zq, p, q, gx, gv, Cs, Ms, Cq, h, h2);
  return (int)cudaGetLastError();
}

}  // extern "C"
