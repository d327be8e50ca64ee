// Flash-attention forward for Hopper (sm_90a): non-causal softmax attention
// over the video DiT's joint text + video sequence. Plain C interface, loaded
// with ctypes by fluidnexus_torch/ops/attention_cuda.py, which also holds the
// plain PyTorch version.
//
// Replaces fluidnexus_tpu/diffusion/video/dit.py:_joint_attention, which on a
// TPU calls the library Pallas flash_attention forward (512-row blocks, the
// sequence padded at the back to a multiple of 512, segment ids masking the
// pad). Here no pad is made: the ragged last key tile is masked in the kernel.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, h, i] . k[b, h, j] / sqrt(d)) v[b, h, j]
//
// Inputs q, k, v are (b, h, s, d) with any element strides for b, h and s
// (d contiguous, every row 16-byte aligned); o is written once, contiguous
// (b, s, h, d), in the input type. The DiT's v is a strided view of the qkv
// projection, so it is read in place. When asked (a non-null lse), each row's
// log-sum-exp of the scaled logits goes to a contiguous f32 (b, h, s) for the
// backward (csrc/attention_bwd.cu; the base is set out in
// attention_common.cuh).
//
// Tiling: one block per (64-query tile, b h). Key and value tiles of 64 rows
// pass through shared memory by cp.async, 16 bytes a thread, rows past s
// zero-filled; the key index of the last tile is masked to -inf before the
// row max, so the zero-filled rows get no weight. The online softmax (running
// max m, running sum l, O rescaled by exp(m_old - m_new) when m rises) is f32
// in registers, in base 2 with log2(e)/sqrt(d) folded into the exponent.
//   bf16: four warps of 16 query rows. S = Q K^T and O += P V run on the
//     tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators); P is
//     rounded to bf16 for the second product, its f32 values go into l. The
//     S accumulator is reused as P's A fragment in registers. K and V tiles
//     are double-buffered; shared rows are XOR-swizzled by 16-byte chunk so
//     the fragment loads (32-bit for Q and K, ldmatrix.trans for V) are free
//     of bank conflicts at d = 64 and 128.
//   f32: the same tiles with plain FMAs: four threads per query row, each
//     holding a quarter of q and o, the dot products summed by shuffles.
//
// Bound on the H100 at the CogVideoX-5B shape (b 2, h 48, s 17 776, d 64):
// 4 b h s^2 d = 7.77e12 tensor-core operations, 7.9 ms at 989 TFLOP/s; b h s^2
// = 3.0e10 exponentials on the special-function units, ~7.8 ms at ~3.9e12/s;
// the bytes (q, k, v read once, o written once, 874 MB) 0.26 ms. So it is
// bound by operations. This first design is simple: mma.sync rather than
// wgmma, no TMA, no warp specialisation, the exponentials not overlapped
// with the products.

#include "attention_common.cuh"

namespace {

using namespace fnx_attn;

// ------------------------------- bf16 kernel --------------------------------

template <int D>
__global__ void __launch_bounds__(128) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int H, int S, Strides sq, Strides sk, Strides sv, float scale_log2) {
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int KS = D / 16;      // k-steps of Q K^T
  constexpr int NO = D / 8;       // n-tiles of O
  constexpr int TILE = BK * CH;   // chunks a tile
  extern __shared__ uint4 smem[];
  uint4* q_tile = smem;
  uint4* k_tiles = smem + TILE;           // two buffers
  uint4* v_tiles = smem + 3 * TILE;       // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const int ntiles = (S + BK - 1) / BK;

  load_tile<__nv_bfloat16, D, 128>(q_tile, qb, sq.s, q0, S, tid);
  load_tile<__nv_bfloat16, D, 128>(k_tiles, kb, sk.s, 0, S, tid);
  load_tile<__nv_bfloat16, D, 128>(v_tiles, vb, sv.s, 0, S, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc_o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc_o[n][0] = acc_o[n][1] = acc_o[n][2] = acc_o[n][3] = 0.f;
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int r0 = warp * 16 + g;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile<__nv_bfloat16, D, 128>(k_tiles + (buf ^ 1) * TILE, kb, sk.s, (t + 1) * BK, S, tid);
      load_tile<__nv_bfloat16, D, 128>(v_tiles + (buf ^ 1) * TILE, vb, sv.s, (t + 1) * BK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) load_a_frags<CH, KS>(qf, q_tile, r0, tg);
    const uint4* kt = k_tiles + buf * TILE;
    const uint4* vt = v_tiles + buf * TILE;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s_acc[8][4];
    mma_a_tt<CH, KS>(s_acc, qf, kt, g, tg);
    // keys past s in the ragged last tile: -inf before the row max
    if ((t + 1) * BK > S) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = t * BK + j * 8 + tg * 2;
        if (key >= S) s_acc[j][0] = s_acc[j][2] = neg_inf();
        if (key + 1 >= S) s_acc[j][1] = s_acc[j][3] = neg_inf();
      }
    }
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s_acc[j][0], s_acc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s_acc[j][2], s_acc[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = ex2((m0 - mn0) * scale_log2), corr1 = ex2((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float off0 = mn0 * scale_log2, off1 = mn1 * scale_log2;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_acc[j][0] = ex2(fmaf(s_acc[j][0], scale_log2, -off0));
      s_acc[j][1] = ex2(fmaf(s_acc[j][1], scale_log2, -off0));
      s_acc[j][2] = ex2(fmaf(s_acc[j][2], scale_log2, -off1));
      s_acc[j][3] = ex2(fmaf(s_acc[j][3], scale_log2, -off1));
      ps0 += s_acc[j][0] + s_acc[j][1];
      ps1 += s_acc[j][2] + s_acc[j][3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc_o[n][0] *= corr0;
      acc_o[n][1] *= corr0;
      acc_o[n][2] *= corr1;
      acc_o[n][3] *= corr1;
    }

    // O += P V: P's A fragment is the S accumulator of n-tiles 2kk, 2kk + 1
    mma_acc_t<CH, NO>(acc_o, s_acc, vt, lane);
    __syncthreads();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + tg * 2;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(o + (((long long)b * S + row0) * H + h) * D + d) =
          pack_bf16(acc_o[n][0] * inv0, acc_o[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(o + (((long long)b * S + row1) * H + h) * D + d) =
          pack_bf16(acc_o[n][2] * inv1, acc_o[n][3] * inv1);
  }
  if (lse != nullptr && tg == 0) {
    float* lrow = lse + ((long long)b * H + h) * S;
    if (row0 < S) lrow[row0] = (m0 * scale_log2 + log2f(l0)) * LN2;
    if (row1 < S) lrow[row1] = (m1 * scale_log2 + log2f(l1)) * LN2;
  }
}

// -------------------------------- f32 kernel --------------------------------

template <int D>
__global__ void __launch_bounds__(256) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int S, Strides sq, Strides sk,
    Strides sv, float scale_log2) {
  constexpr int CH = D / 4;       // 16-byte chunks a row
  constexpr int DP = D / 4;       // dims of one thread's quarter
  constexpr int TILE = BK * CH;
  extern __shared__ uint4 smem[];
  uint4* k_tile = smem;
  uint4* v_tile = smem + TILE;

  const int tid = threadIdx.x, part = tid & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row = blockIdx.x * BQ + (tid >> 2);
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int ntiles = (S + BK - 1) / BK;

  float qv[DP], acc[DP];
  const float* qr = q + b * sq.b + h * sq.h + (long long)(row < S ? row : 0) * sq.s + part * DP;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qv[i] = row < S ? qr[i] : 0.f;
    acc[i] = 0.f;
  }
  float m = neg_inf(), l = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    load_tile<float, D, 256>(k_tile, kb, sk.s, t * BK, S, tid);
    load_tile<float, D, 256>(v_tile, vb, sv.s, t * BK, S, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float sc[BK];
    float mx = neg_inf();
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        const float4 kv = reinterpret_cast<const float4*>(k_tile)[swz<CH>(j, part * (DP / 4) + c)];
        dot = fmaf(qv[4 * c], kv.x, dot);
        dot = fmaf(qv[4 * c + 1], kv.y, dot);
        dot = fmaf(qv[4 * c + 2], kv.z, dot);
        dot = fmaf(qv[4 * c + 3], kv.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      sc[j] = t * BK + j < S ? dot : neg_inf();  // keys past s: -inf before the max
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = ex2((m - mn) * scale_log2);
    m = mn;
    const float off = mn * scale_log2;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = ex2(fmaf(sc[j], scale_log2, -off));
      ps += p;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        const float4 vv = reinterpret_cast<const float4*>(v_tile)[swz<CH>(j, part * (DP / 4) + c)];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    l = l * corr + ps;
    __syncthreads();
  }
  if (row < S) {
    const float inv = 1.f / l;
    float* orow = o + (((long long)b * S + row) * H + h) * D + part * DP;
#pragma unroll
    for (int i = 0; i < DP; ++i) orow[i] = acc[i] * inv;
    if (lse != nullptr && part == 0)
      lse[((long long)b * H + h) * S + row] = (m * scale_log2 + log2f(l)) * LN2;
  }
}

// One launch of the (T, D) kernel: bf16 with 128 threads, Q and two K and V
// buffers in shared memory; f32 with 256 threads, one K and one V tile.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int S,
           Strides sq, Strides sk, Strides sv, float scale_log2, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
    const __nv_bfloat16* kk = static_cast<const __nv_bfloat16*>(k);
    const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
    return launch_kernel(attention_bf16_kernel<D>, grid, 128, (size_t)BK * D * 2 * 5, stream, qq,
                         kk, vv, static_cast<__nv_bfloat16*>(o), lse, H, S, sq, sk, sv,
                         scale_log2);
  } else {
    const float* qq = static_cast<const float*>(q);
    const float* kk = static_cast<const float*>(k);
    const float* vv = static_cast<const float*>(v);
    return launch_kernel(attention_f32_kernel<D>, grid, 256, (size_t)BK * D * 4 * 2, stream, qq,
                         kk, vv, static_cast<float*>(o), lse, H, S, sq, sk, sv, scale_log2);
  }
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int S, Strides sq, Strides sk, Strides sv, float scale_log2, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, S, sq, sk, sv, scale_log2, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, S, sq, sk, sv, scale_log2, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, S, sq, sk, sv, scale_log2, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, S, sq, sk, sv, scale_log2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. Strides are in elements, for (b, h, s) of
// each input; every row must be 16-byte aligned (the wrapper checks). lse may
// be null: the sampler needs no log-sum-exp.
int fnx_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                      int B, int H, int S, int D, long long qsb, long long qsh, long long qss,
                      long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                      long long vss, float scale_log2, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss};
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, S, sq, sk, sv, scale_log2, st);
  if (dtype == 0) return launch_d<float>(D, q, k, v, o, l, B, H, S, sq, sk, sv, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
