// Flash-attention backward for Hopper (sm_90a): the gradient of the forward
// in csrc/attention.cu. Plain C interface, loaded with ctypes by
// fluidnexus_torch/ops/attention_cuda.py, which holds the autograd Function
// around both and the plain PyTorch version (autograd through
// attention_plain).
//
// Replaces the backward of the library Pallas flash_attention that
// fluidnexus_tpu/diffusion/video/dit.py:_joint_attention calls on a TPU: the
// dkv and dq kernels behind its custom_vjp (512-row blocks; the sequence
// padded at the back to a multiple of 512, segment ids masking the pad), with
// D computed outside them.
//
// With s = 1/sqrt(d), P = softmax(s Q K^T) recomputed from the forward's
// log-sum-exp (P_ij = 2^(s_ij * scale_log2 - lse_i * log2 e), the base set
// out in attention_common.cuh) and D_i = dO_i . O_i:
//   dV = P^T dO,  dS = P o (dO V^T - D),  dQ = s dS K,  dK = s dS^T Q.
//
// Bound on the H100 at the CogVideoX-5B shape (b 2, h 48, s 17 776, d 64):
// the gradient needs 5 products of 2 b h s^2 d = 3.88e12 operations, 1.94e13,
// 19.6 ms at bf16's 989 TFLOP/s, and b h s^2 = 3.0e10 exponentials, 7.8 ms at
// ~3.9e12/s; the bytes (q, k, v, o, dO, lse read once, dq, dk, dv written)
// 0.5 ms. So it is bound by operations.
//
// Two designs:
//   attention_bwd_wgmma_kernel, bf16 at d = 64 (the 5B and 2B DiTs' 64-wide
//     heads), built from hopper_common.cuh: one pass, the 5 products once.
//     One block per (128-key tile, b h), three warpgroups. The producer
//     (setmaxnreg 24; one thread) loads the block's K and V once by TMA, then
//     walks the query tiles: Q and dO (128 rows each) by TMA and the tile's
//     lse log2 e and D rows (1 KB, padded by the wrapper to whole tiles, so
//     a 16-byte-aligned 1-D bulk copy) through a ring of HSTAGES stages with
//     full and empty barriers. Two consumer warpgroups (setmaxnreg 240) of 64
//     keys each keep dK and dV in registers and take each query tile in two
//     halves of 64 queries: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16,
//     both from shared), P^T in f32 while dP^T is still on the tensor cores,
//     dS^T = P^T o (dP^T - D) with f32 P, then dV += P^T dO and dK += dS^T Q
//     (m64n64k16, P^T and dS^T rounded to bf16 in registers, dO and Q read
//     MN-major). A whole 128-query tile at once would hold S^T and dP^T at
//     64 registers each beside dK and dV: ptxas gives every thread of a
//     384-thread block at most 168 registers whatever setmaxnreg asks, and
//     spilled and serialised the products (94 ms at the 5B shape); halves
//     fit. Each half's dS^T also goes, as bf16, into a shared tile of 128
//     keys x 64 queries; when both consumers have written theirs (a named
//     barrier), each computes dQ for 64 query rows = dS K over the block's
//     128 keys (m64n64k16, dS read MN-major from that tile, K MN-major),
//     stages it times s as f32 in the tile it just read and one thread adds
//     it into an f32 workspace by TMA reduce-add (the wrapper zeroes the
//     workspace before and casts it to bf16 after). dS tiles are double
//     buffered. Pad keys (rows past s, TMA zero-fills them) have P set to 0:
//     their S is 0, and 2^(0 - lse log2 e) overflows to inf when every logit
//     of a row lies far below 0, and inf times the zero K row would make dQ
//     NaN. Pad queries have lse = +inf, so their P is 0 and they add nothing
//     to dK and dV; dK and dV of pad keys are not written, dQ rows past s
//     are skipped by TMA. dQ is summed across key blocks in an order that
//     changes from run to run, so its last bits do too; dK and dV are
//     summed in registers and repeat bit for bit.
//   the mma.sync pair (f32, and bf16 at d = 16, 32 and 128), as the TPU
//     split it, so no output is summed across blocks: no atomics, and a
//     rerun gives the same bits.
//     dq:  one block per (64-query tile, b h) walks the key tiles; it first
//          computes D for its rows and writes it (f32, (b, h, s)) for dkv,
//          which is launched after it on the same stream.
//     dkv: one block per (64-key tile, b h) walks the query tiles, with dK
//          and dV in registers.
//     Both recompute S and P: 7 products of 2 b h s^2 d operations each
//     against the 5 of a backward that keeps P, so by construction at least
//     1.4x above the bound.
//     Inputs q, k, v, o, dO and outputs dq, dk, dv are (b, h, s, d) with any
//     element strides for b, h and s (d contiguous, rows 16-byte aligned);
//     the DiT's v is a strided view of the qkv projection, read in place.
//     Ragged tiles: rows past s are zero-filled by cp.async, so a pad key
//     adds dS_ij K_j = 0 to dQ, and pad queries (Q and dO zero) add nothing
//     to dK and dV; a pad key's P is still set to 0 before it is used (the
//     overflow above). Pad queries' P is set to 0 as well.
//     bf16: four warps of 16 rows; every product on the tensor cores
//       (mma.sync m16n8k16, bf16 in, f32 accumulators), P and dS rounded to
//       bf16 as A fragments straight from the accumulators. dq keeps Q and dO
//       fragments in registers, dkv keeps K and V; the walked tiles are
//       double-buffered by cp.async.
//     f32: plain FMAs, four threads a row, each holding a quarter of the
//       row's vectors and accumulators, dot products summed by shuffles.

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace fnx_attn;
typedef __nv_bfloat16 bf16;

// ------------------------------- bf16 kernels --------------------------------

template <int D>
__global__ void __launch_bounds__(128) attention_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dsum, bf16* __restrict__ dq, int H, int S, Strides sq, Strides sk,
    Strides sv, Strides so, Strides sdo, Strides sdq, float scale_log2, float scale) {
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int KS = D / 16;      // k-steps over d
  constexpr int NO = D / 8;       // n-tiles of dQ
  constexpr int TILE = BK * CH;   // chunks a tile
  extern __shared__ uint4 smem[];
  uint4* q_tile = smem;
  uint4* do_tile = smem + TILE;
  uint4* k_tiles = smem + 2 * TILE;   // two buffers
  uint4* v_tiles = smem + 4 * TILE;   // two buffers
  float* d_rows = reinterpret_cast<float*>(smem + 6 * TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long bh = (long long)b * H + h;
  const int q0 = blockIdx.x * BQ;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int ntiles = (S + BK - 1) / BK;

  load_tile<bf16, D, 128>(q_tile, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_tile<bf16, D, 128>(do_tile, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
  load_tile<bf16, D, 128>(k_tiles, kb, sk.s, 0, S, tid);
  load_tile<bf16, D, 128>(v_tiles, vb, sv.s, 0, S, tid);
  cp_async_commit();

  // D_i = dO_i . O_i in f32 from the stored bf16 values, two threads a row
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const bf16* orow = o + b * so.b + h * so.h + row * so.s + half * (D / 2);
      const bf16* drow = dout + b * sdo.b + h * sdo.h + row * sdo.s + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      d_rows[r] = acc;
      if (row < S) dsum[bh * S + row] = acc;
    }
  }

  const int r0 = warp * 16 + g;
  const int row0 = q0 + r0, row1 = row0 + 8;
  const float lse0 = row0 < S ? lse[bh * S + row0] * LOG2E : 0.f;
  const float lse1 = row1 < S ? lse[bh * S + row1] * LOG2E : 0.f;
  float d0 = 0.f, d1 = 0.f;
  uint32_t qf[KS][4], dof[KS][4];
  float acc_dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc_dq[n][0] = acc_dq[n][1] = acc_dq[n][2] = acc_dq[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile<bf16, D, 128>(k_tiles + (buf ^ 1) * TILE, kb, sk.s, (t + 1) * BK, S, tid);
      load_tile<bf16, D, 128>(v_tiles + (buf ^ 1) * TILE, vb, sv.s, (t + 1) * BK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_a_frags<CH, KS>(qf, q_tile, r0, tg);
      load_a_frags<CH, KS>(dof, do_tile, r0, tg);
      d0 = d_rows[r0];
      d1 = d_rows[r0 + 8];
    }
    const uint4* kt = k_tiles + buf * TILE;
    const uint4* vt = v_tiles + buf * TILE;

    float s_acc[8][4], dp[8][4];
    mma_a_tt<CH, KS>(s_acc, qf, kt, g, tg);    // S = Q K^T, 16 rows x 64 keys a warp
    mma_a_tt<CH, KS>(dp, dof, vt, g, tg);      // dP = dO V^T
    const bool ragged = (t + 1) * BK > S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s_acc[j][e], scale_log2, -(e < 2 ? lse0 : lse1)));
        if (ragged && t * BK + j * 8 + tg * 2 + (e & 1) >= S) p = 0.f;   // keys past s
        s_acc[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));                 // dS
      }
    }
    mma_acc_t<CH, NO>(acc_dq, s_acc, kt, lane);   // dQ += dS K
    __syncthreads();
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + tg * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dqb + row0 * sdq.s + d) =
          pack_bf16(acc_dq[n][0] * scale, acc_dq[n][1] * scale);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dqb + row1 * sdq.s + d) =
          pack_bf16(acc_dq[n][2] * scale, acc_dq[n][3] * scale);
  }
}

// lse (times log2 e) and D of query rows tile * 64 .. + 63 into shared rows;
// rows past s get 0 (their P is masked, their Q and dO rows are zero)
__device__ __forceinline__ void load_rows(float* rows, const float* lse, const float* dsum,
                                          long long bh, int tile, int S, int tid) {
  const int r = tid & 63, i = tile * BQ + r;
  if (tid < 64)
    rows[r] = i < S ? lse[bh * S + i] * LOG2E : 0.f;
  else if (tid < 128)
    rows[64 + r] = i < S ? dsum[bh * S + i] : 0.f;
}

template <int D>
__global__ void __launch_bounds__(128) attention_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale_log2, float scale) {
  constexpr int CH = D / 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  constexpr int TILE = BK * CH;
  extern __shared__ uint4 smem[];
  uint4* k_tile = smem;
  uint4* v_tile = smem + TILE;
  uint4* q_tiles = smem + 2 * TILE;    // two buffers
  uint4* do_tiles = smem + 4 * TILE;   // two buffers
  float* rows = reinterpret_cast<float*>(smem + 6 * TILE);   // two buffers of lse | D

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long bh = (long long)b * H + h;
  const int k0 = blockIdx.x * BK;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const int ntiles = (S + BQ - 1) / BQ;

  load_tile<bf16, D, 128>(k_tile, k + b * sk.b + h * sk.h, sk.s, k0, S, tid);
  load_tile<bf16, D, 128>(v_tile, v + b * sv.b + h * sv.h, sv.s, k0, S, tid);
  load_tile<bf16, D, 128>(q_tiles, qb, sq.s, 0, S, tid);
  load_tile<bf16, D, 128>(do_tiles, dob, sdo.s, 0, S, tid);
  cp_async_commit();
  load_rows(rows, lse, dsum, bh, 0, S, tid);

  const int r0 = warp * 16 + g;
  uint32_t kf[KS][4], vf[KS][4];
  float acc_dk[NO][4], acc_dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
    acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile<bf16, D, 128>(q_tiles + (buf ^ 1) * TILE, qb, sq.s, (t + 1) * BQ, S, tid);
      load_tile<bf16, D, 128>(do_tiles + (buf ^ 1) * TILE, dob, sdo.s, (t + 1) * BQ, S, tid);
      cp_async_commit();
      load_rows(rows + (buf ^ 1) * 2 * BQ, lse, dsum, bh, t + 1, S, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_a_frags<CH, KS>(kf, k_tile, r0, tg);
      load_a_frags<CH, KS>(vf, v_tile, r0, tg);
    }
    const uint4* qt = q_tiles + buf * TILE;
    const uint4* dt = do_tiles + buf * TILE;
    const float* ls = rows + buf * 2 * BQ;
    const float* dd = ls + BQ;

    float s_acc[8][4], dp[8][4];
    mma_a_tt<CH, KS>(s_acc, kf, qt, g, tg);    // S^T = K Q^T, 16 keys x 64 queries a warp
    mma_a_tt<CH, KS>(dp, vf, dt, g, tg);       // dP^T = V dO^T
    const bool ragged = (t + 1) * BQ > S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        float p = ex2(fmaf(s_acc[j][e], scale_log2, -ls[col]));
        if (ragged && t * BQ + col >= S) p = 0.f;   // queries past s
        s_acc[j][e] = p;
      }
    }
    mma_acc_t<CH, NO>(acc_dv, s_acc, dt, lane);   // dV += P^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] *= dp[j][e] - dd[j * 8 + tg * 2 + (e & 1)];  // dS^T
    }
    mma_acc_t<CH, NO>(acc_dk, s_acc, qt, lane);   // dK += dS^T Q
    __syncthreads();
  }

  const int key0 = k0 + r0, key1 = key0 + 8;
  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + tg * 2;
    if (key0 < S) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * sdk.s + d) =
          pack_bf16(acc_dk[n][0] * scale, acc_dk[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * sdv.s + d) = pack_bf16(acc_dv[n][0], acc_dv[n][1]);
    }
    if (key1 < S) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * sdk.s + d) =
          pack_bf16(acc_dk[n][2] * scale, acc_dk[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * sdv.s + d) = pack_bf16(acc_dv[n][2], acc_dv[n][3]);
    }
  }
}

// -------------------------------- f32 kernels --------------------------------

template <int DP>
__device__ __forceinline__ float quarter_dot(const float (&x)[DP], const uint4* tile, int row,
                                             int part) {
  constexpr int CH = DP;   // a row of D = 4 DP floats is DP 16-byte chunks
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 y = reinterpret_cast<const float4*>(tile)[swz<CH>(row, part * (DP / 4) + c)];
    dot = fmaf(x[4 * c], y.x, dot);
    dot = fmaf(x[4 * c + 1], y.y, dot);
    dot = fmaf(x[4 * c + 2], y.z, dot);
    dot = fmaf(x[4 * c + 3], y.w, dot);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  return dot + __shfl_xor_sync(0xffffffffu, dot, 2);
}

template <int DP>
__device__ __forceinline__ void quarter_axpy(float (&acc)[DP], float a, const uint4* tile, int row,
                                             int part) {
  constexpr int CH = DP;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 y = reinterpret_cast<const float4*>(tile)[swz<CH>(row, part * (DP / 4) + c)];
    acc[4 * c] = fmaf(a, y.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(a, y.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, y.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, y.w, acc[4 * c + 3]);
  }
}

template <int DP>
__device__ __forceinline__ void load_quarter(float (&x)[DP], const float* base, Strides st, int b,
                                             int h, int row, int S, int part) {
  const float* p = base + b * st.b + h * st.h + (long long)(row < S ? row : 0) * st.s + part * DP;
#pragma unroll
  for (int i = 0; i < DP; ++i) x[i] = row < S ? p[i] : 0.f;
}

template <int D>
__global__ void __launch_bounds__(256) attention_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dsum, float* __restrict__ dq, int H, int S, Strides sq, Strides sk,
    Strides sv, Strides so, Strides sdo, Strides sdq, float scale_log2, float scale) {
  constexpr int DP = D / 4;
  constexpr int TILE = BK * (D / 4);
  extern __shared__ uint4 smem[];
  uint4* k_tile = smem;
  uint4* v_tile = smem + TILE;

  const int tid = threadIdx.x, part = tid & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long bh = (long long)b * H + h;
  const int row = blockIdx.x * BQ + (tid >> 2);
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int ntiles = (S + BK - 1) / BK;

  float qv[DP], dov[DP], acc[DP];
  load_quarter<DP>(qv, q, sq, b, h, row, S, part);
  load_quarter<DP>(dov, dout, sdo, b, h, row, S, part);
  load_quarter<DP>(acc, o, so, b, h, row, S, part);
  float drow = 0.f;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    drow = fmaf(dov[i], acc[i], drow);
    acc[i] = 0.f;
  }
  drow += __shfl_xor_sync(0xffffffffu, drow, 1);
  drow += __shfl_xor_sync(0xffffffffu, drow, 2);
  if (row < S && part == 0) dsum[bh * S + row] = drow;
  const float lse2 = row < S ? lse[bh * S + row] * LOG2E : 0.f;

  for (int t = 0; t < ntiles; ++t) {
    load_tile<float, D, 256>(k_tile, kb, sk.s, t * BK, S, tid);
    load_tile<float, D, 256>(v_tile, vb, sv.s, t * BK, S, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float s = quarter_dot<DP>(qv, k_tile, j, part);
      const float dpv = quarter_dot<DP>(dov, v_tile, j, part);
      const float p = t * BK + j < S ? ex2(fmaf(s, scale_log2, -lse2)) : 0.f;   // keys past s: 0
      quarter_axpy<DP>(acc, p * (dpv - drow), k_tile, j, part);
    }
    __syncthreads();
  }
  if (row < S) {
    float* out = dq + b * sdq.b + h * sdq.h + row * sdq.s + part * DP;
#pragma unroll
    for (int i = 0; i < DP; ++i) out[i] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256) attention_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int H, int S, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale_log2, float scale) {
  constexpr int DP = D / 4;
  constexpr int TILE = BQ * (D / 4);
  extern __shared__ uint4 smem[];
  uint4* q_tile = smem;
  uint4* do_tile = smem + TILE;
  float* rows = reinterpret_cast<float*>(smem + 2 * TILE);   // lse | D of the query tile

  const int tid = threadIdx.x, part = tid & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long bh = (long long)b * H + h;
  const int key = blockIdx.x * BK + (tid >> 2);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const int ntiles = (S + BQ - 1) / BQ;

  float kv[DP], vv[DP], adk[DP], adv[DP];
  load_quarter<DP>(kv, k, sk, b, h, key, S, part);
  load_quarter<DP>(vv, v, sv, b, h, key, S, part);
#pragma unroll
  for (int i = 0; i < DP; ++i) adk[i] = adv[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    load_tile<float, D, 256>(q_tile, qb, sq.s, t * BQ, S, tid);
    load_tile<float, D, 256>(do_tile, dob, sdo.s, t * BQ, S, tid);
    cp_async_commit();
    load_rows(rows, lse, dsum, bh, t, S, tid);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float s = quarter_dot<DP>(kv, q_tile, i, part);
      const float p = t * BQ + i < S ? ex2(fmaf(s, scale_log2, -rows[i])) : 0.f;  // queries past s
      quarter_axpy<DP>(adv, p, do_tile, i, part);
      const float dpv = quarter_dot<DP>(vv, do_tile, i, part);
      quarter_axpy<DP>(adk, p * (dpv - rows[BQ + i]), q_tile, i, part);
    }
    __syncthreads();
  }
  if (key < S) {
    float* ok = dk + b * sdk.b + h * sdk.h + key * sdk.s + part * DP;
    float* ov = dv + b * sdv.b + h * sdv.h + key * sdv.s + part * DP;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      ok[i] = adk[i] * scale;
      ov[i] = adv[i];
    }
  }
}

// ---------------------- bf16 backward at d = 64, wgmma -----------------------

namespace hop = fnx_hopper;

constexpr int HK = 128;                          // keys a block, 64 a consumer warpgroup
constexpr int HQ = 128;                          // query rows a tile
constexpr int HSTAGES = 2;                       // Q and dO tiles in flight
constexpr int HTILE = 128 * hop::ROW_BYTES;      // a 128-row bf16 tile (16 KB)
constexpr int HROWS = 2 * HQ * 4;                // a query tile's lse log2 e | D, f32
// K, V; the ring's Q and dO; two dS buffers of two tiles (query columns
// 0..63, 64..127); the ring's rows; barriers
constexpr int HROWS_AT = 2 * HTILE + HSTAGES * 2 * HTILE + 2 * 2 * HTILE;
constexpr int HSMEM = 1024 + HROWS_AT + HSTAGES * HROWS + 8 * (1 + 2 * HSTAGES);

__global__ void __launch_bounds__(384, 1) attention_bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ rows,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv, int H, int S,
    float scale_log2, float scale) {
  extern __shared__ uint8_t wsmem[];
  const uint32_t base = (hop::smem_addr(wsmem) + 1023) & ~1023u;   // the swizzle's alignment
  const uint8_t* gbase = wsmem + (base - hop::smem_addr(wsmem));
  const uint32_t k_s = base, v_s = base + HTILE, ds_s = base + 2 * HTILE * (1 + HSTAGES);
  auto q_s = [&](int st) { return base + 2 * HTILE * (1 + st); };
  auto do_s = [&](int st) { return base + 2 * HTILE * (1 + st) + HTILE; };
  const uint32_t bar_kv = base + HROWS_AT + HSTAGES * HROWS;
  auto full = [&](int st) { return bar_kv + 8 * (1 + st); };
  auto empty = [&](int st) { return bar_kv + 8 * (1 + HSTAGES + st); };

  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  const int b = blockIdx.y / H, h = blockIdx.y % H, k0 = blockIdx.x * HK;
  const int nq = (S + HQ - 1) / HQ;
  if (threadIdx.x == 0) {
    hop::mbar_init(bar_kv, 1);
    for (int st = 0; st < HSTAGES; ++st) {
      hop::mbar_init(full(st), 1);
      hop::mbar_init(empty(st), 2);   // one arrival from each consumer warpgroup
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads K and V once, then walks the query tiles
    hop::setmaxnreg_dec<24>();
    if (t128 == 0) {
      hop::tma_prefetch(&tq);
      hop::tma_prefetch(&tdo);
      hop::mbar_expect_tx(bar_kv, 2 * HTILE);
      hop::tma_load_4d(k_s, &tk, bar_kv, 0, k0, h, b);
      hop::tma_load_4d(v_s, &tv, bar_kv, 0, k0, h, b);
      const float* rb = rows + (long long)blockIdx.y * nq * 2 * HQ;
      for (int t = 0; t < nq; ++t) {
        const int st = t % HSTAGES;
        hop::mbar_wait(empty(st), ((t / HSTAGES) & 1) ^ 1);
        hop::mbar_expect_tx(full(st), 2 * HTILE + HROWS);
        hop::tma_load_4d(q_s(st), &tq, full(st), 0, t * HQ, h, b);
        hop::tma_load_4d(do_s(st), &tdo, full(st), 0, t * HQ, h, b);
        hop::bulk_load(base + HROWS_AT + st * HROWS, rb + t * 2 * HQ, HROWS, full(st));
      }
    }
    return;
  }

  // consumers: warpgroup cw takes keys cw * 64 .. cw * 64 + 63 of the block;
  // this thread rows r and r + 8 of them (and, in dQ, of each query tile)
  hop::setmaxnreg_inc<240>();
  const int cw = wg - 1, lane = t128 & 31, g = lane >> 2, tg = lane & 3;
  const int r = cw * 64 + (t128 >> 5) * 16 + g;
  const bool live0 = k0 + r < S, live1 = k0 + r + 8 < S;   // pad keys: P = 0
  const uint32_t ka = k_s + cw * (HTILE / 2), va = v_s + cw * (HTILE / 2);
  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  hop::mbar_wait(bar_kv, 0);
  for (int t = 0; t < nq; ++t) {
    const int st = t % HSTAGES;
    const uint32_t ds_buf = ds_s + (t & 1) * 2 * HTILE;
    const float* lr = reinterpret_cast<const float*>(gbase + HROWS_AT + st * HROWS);
    hop::mbar_wait(full(st), (t / HSTAGES) & 1);
    // the tile's 128 queries in two halves of 64: what a half holds (S^T,
    // dP^T, then P and dS fragments) fits beside dK and dV under the 168
    // registers that the launch bounds give every thread
#pragma unroll 1
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t qh = q_s(st) + hh * (HTILE / 2), doh = do_s(st) + hh * (HTILE / 2);
      const float* lh = lr + 64 * hh;
      // declared here, not zeroed: each half's first k-step overwrites them,
      // so nothing of them lives from one half to the next
      float s[32], dp[32];
      uint32_t pf[4][4], df[4][4];
      hop::wgmma_fence();
      hop::product_abt64(s, ka, qh);       // S^T = K Q^T: 64 keys x 64 queries
      hop::wgmma_commit();
      hop::product_abt64(dp, va, doh);     // dP^T = V dO^T
      hop::wgmma_commit();
      hop::wgmma_wait<1>();                // S^T done, dP^T may still run
      hop::fence_regs(s);
      // P^T = 2^(S^T scale_log2 - lse log2 e) in f32, the query of column c
      // reading its row's lse (+inf past s, so a pad query's P is 0)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lh + 8 * j + 2 * tg);
        s[4 * j] = live0 ? ex2(fmaf(s[4 * j], scale_log2, -l.x)) : 0.f;
        s[4 * j + 1] = live0 ? ex2(fmaf(s[4 * j + 1], scale_log2, -l.y)) : 0.f;
        s[4 * j + 2] = live1 ? ex2(fmaf(s[4 * j + 2], scale_log2, -l.x)) : 0.f;
        s[4 * j + 3] = live1 ? ex2(fmaf(s[4 * j + 3], scale_log2, -l.y)) : 0.f;
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
      // dS^T = P^T o (dP^T - D) with f32 P, into dp
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(lh + HQ + 8 * j + 2 * tg);
        dp[4 * j] = s[4 * j] * (dp[4 * j] - dd.x);
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dd.y);
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dd.x);
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dd.y);
      }
      hop::pack_a_frags(pf, s);
      hop::pack_a_frags(df, dp);
      hop::store_frags(ds_buf + hh * HTILE, df, r, tg);
      hop::fence_regs(acc_dv);
      hop::fence_regs(acc_dk);
      hop::fence_regs(pf);
      hop::fence_regs(df);
      hop::wgmma_fence();
      hop::product_pv(acc_dv, pf, doh);    // dV += P^T dO
      hop::product_pv(acc_dk, df, qh);     // dK += dS^T Q
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc_dv);
      hop::fence_regs(acc_dk);
      hop::fence_regs(pf);
      hop::fence_regs(df);
    }
    if (t128 == 0) hop::mbar_arrive(empty(st));   // the stage's Q, dO and rows are read
    // both consumers' halves of the dS tile written, and the last tile's
    // reduce-add done reading its buffer (the next tile's dS goes there):
    // dQ for this warpgroup's 64 query rows = dS K over the block's 128 keys
    float acc_dq[32];
    if (t128 == 0) hop::bulk_wait_read<0>();
    hop::fence_proxy_async();
    hop::named_barrier_sync<1, 256>();
    hop::wgmma_fence();
    const uint32_t dq_s = ds_buf + cw * HTILE;   // no other warpgroup reads this tile
    hop::product_atb(acc_dq, dq_s, k_s);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc_dq);
    // s dQ staged in the tile just read, then added by TMA into the f32
    // workspace (rows past s skipped)
    hop::store_acc_f32(dq_s, acc_dq, scale, r & 63, tg);
    hop::fence_proxy_async();
    if (cw == 0)
      hop::named_barrier_sync<2, 128>();
    else
      hop::named_barrier_sync<3, 128>();
    if (t128 == 0) {
      hop::tma_reduce_add_4d(&tdq, dq_s, 0, t * HQ + cw * 64, h, b);
      hop::tma_reduce_add_4d(&tdq, dq_s + 64 * hop::ROW_BYTES, 32, t * HQ + cw * 64, h, b);
      hop::bulk_commit();
    }
  }
  if (t128 == 0) hop::bulk_wait<0>();   // shared memory stays until the last reduce-add is done

  // dK and dV of keys past s are not written
  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
  const int key0 = k0 + r, key1 = key0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = 8 * j + 2 * tg;
    if (live0) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * sdk.s + d) =
          pack_bf16(acc_dk[4 * j] * scale, acc_dk[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * sdv.s + d) = pack_bf16(acc_dv[4 * j], acc_dv[4 * j + 1]);
    }
    if (live1) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * sdk.s + d) =
          pack_bf16(acc_dk[4 * j + 2] * scale, acc_dk[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * sdv.s + d) =
          pack_bf16(acc_dv[4 * j + 2], acc_dv[4 * j + 3]);
    }
  }
}

// ---------------------------------- launches ---------------------------------

struct Args {  // pointers and strides of one backward
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

template <typename T, int D>
int launch_dq(const Args& a, int B, int H, int S, float scale_log2, float scale, cudaStream_t st) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  if constexpr (sizeof(T) == 2)
    return launch_kernel(attention_dq_bf16_kernel<D>, grid, 128,
                         (size_t)BK * D * 2 * 6 + BQ * sizeof(float), st, q, k, v, o, dout, a.lse,
                         a.dsum, dq, H, S, a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq, scale_log2, scale);
  else
    return launch_kernel(attention_dq_f32_kernel<D>, grid, 256, (size_t)BK * D * 4 * 2, st, q, k,
                         v, o, dout, a.lse, a.dsum, dq, H, S, a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq,
                         scale_log2, scale);
}

template <typename T, int D>
int launch_dkv(const Args& a, int B, int H, int S, float scale_log2, float scale, cudaStream_t st) {
  const dim3 grid((S + BK - 1) / BK, B * H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  if constexpr (sizeof(T) == 2)
    return launch_kernel(attention_dkv_bf16_kernel<D>, grid, 128,
                         (size_t)BK * D * 2 * 6 + 4 * BQ * sizeof(float), st, q, k, v, dout, a.lse,
                         a.dsum, dk, dv, H, S, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, scale_log2,
                         scale);
  else
    return launch_kernel(attention_dkv_f32_kernel<D>, grid, 256,
                         (size_t)BQ * D * 4 * 2 + 2 * BQ * sizeof(float), st, q, k, v, dout, a.lse,
                         a.dsum, dk, dv, H, S, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, scale_log2,
                         scale);
}

template <typename T>
int launch_bwd(bool dkv, int D, const Args& a, int B, int H, int S, float scale_log2, float scale,
               cudaStream_t st) {
  switch (D) {
    case 16: return dkv ? launch_dkv<T, 16>(a, B, H, S, scale_log2, scale, st)
                        : launch_dq<T, 16>(a, B, H, S, scale_log2, scale, st);
    case 32: return dkv ? launch_dkv<T, 32>(a, B, H, S, scale_log2, scale, st)
                        : launch_dq<T, 32>(a, B, H, S, scale_log2, scale, st);
    case 64: return dkv ? launch_dkv<T, 64>(a, B, H, S, scale_log2, scale, st)
                        : launch_dq<T, 64>(a, B, H, S, scale_log2, scale, st);
    case 128: return dkv ? launch_dkv<T, 128>(a, B, H, S, scale_log2, scale, st)
                         : launch_dq<T, 128>(a, B, H, S, scale_log2, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One kernel of the backward: which 0 is dq (it also writes dsum = D), 1 is
// dkv (it reads dsum), launched in that order. dtype 0: float32, 1: bfloat16.
// st holds the (b, h, s) element strides of q, k, v, o, dout, dq, dk, dv, in
// that order (24 values); every row must be 16-byte aligned (the wrapper
// checks). lse and dsum are contiguous f32 (b, h, s).
int fnx_attention_bwd(int which, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dsum, void* dq, void* dk, void* dv,
                      int dtype, int B, int H, int S, int D, const long long* st, float scale_log2,
                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535 || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(dsum), dq, dk, dv,
         {st[0], st[1], st[2]},    {st[3], st[4], st[5]},    {st[6], st[7], st[8]},
         {st[9], st[10], st[11]},  {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         {st[18], st[19], st[20]}, {st[21], st[22], st[23]}};
  const cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == 1) return launch_bwd<bf16>(which == 1, D, a, B, H, S, scale_log2, scale, cs);
  if (dtype == 0) return launch_bwd<float>(which == 1, D, a, B, H, S, scale_log2, scale, cs);
  return (int)cudaErrorInvalidValue;
}

// The bf16 backward at head_dim 64 on wgmma and TMA, one launch. q, k, v
// and dout (b, h, s, 64) as fnx_attention_bwd takes them, plus what TMA
// needs: every stride a multiple of 8 elements, each base 16-byte aligned.
// rows is contiguous f32 (b, h, nq, 2, 128), nq = ceil(s / 128): each query
// tile's lse times log2(e) (+inf past s), then its D = dO . O (0 past s). dq
// is an f32 (b, h, s, 64) of zeros (any strides a multiple of 4 elements)
// into which s dS K is summed. st holds the (b, h, s) element strides of q,
// k, v, dout, dq, dk, dv, in that order (21 values). Tensor maps are encoded
// at each call; one that cannot be encoded returns 1000 + its CUresult.
int fnx_attention_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* rows, void* dq, void* dk, void* dv, int B, int H, int S,
                            const long long* st, float scale_log2, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = hop::encode_bf16_rows(&tq, q, B, H, S, st[0], st[1], st[2], HQ);
  if (err == 0) err = hop::encode_bf16_rows(&tk, k, B, H, S, st[3], st[4], st[5], HK);
  if (err == 0) err = hop::encode_bf16_rows(&tv, v, B, H, S, st[6], st[7], st[8], HK);
  if (err == 0) err = hop::encode_bf16_rows(&tdo, dout, B, H, S, st[9], st[10], st[11], HQ);
  if (err == 0) err = hop::encode_f32_rows(&tdq, dq, B, H, S, st[12], st[13], st[14], 64);
  if (err != 0) return 1000 + err;
  return launch_kernel(attention_bwd_wgmma_kernel, dim3((S + HK - 1) / HK, B * H), 384,
                       (size_t)HSMEM, (cudaStream_t)stream, tq, tk, tv, tdo, tdq,
                       static_cast<const float*>(rows), static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv), Strides{st[15], st[16], st[17]},
                       Strides{st[18], st[19], st[20]}, H, S, scale_log2, scale);
}

}  // extern "C"
