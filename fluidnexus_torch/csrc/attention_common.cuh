// Shared pieces of the flash-attention kernels (csrc/attention.cu, the
// forward, and csrc/attention_bwd.cu, the backward): tile loads by cp.async
// into XOR-swizzled shared tiles, the bf16 tensor-core fragments (mma.sync
// m16n8k16, f32 accumulators) and the launch helper.
//
// The log-sum-exp that the forward writes and the backward reads is in the
// natural base, of the scaled logits: lse_i = log sum_j exp(q_i . k_j / sqrt(d)),
// as torch.logsumexp gives it. Both kernels work in base 2 inside
// (scale_log2 = log2(e) / sqrt(d) folded into the exponent), so the forward
// writes (m * scale_log2 + log2(l)) * ln 2 and the backward multiplies by
// log2(e) when it reads it back: P = 2^(s * scale_log2 - lse * log2(e)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fnx_attn {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {  // element strides of a (b, h, s, d) tensor; d has stride 1
  long long b, h, s;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; 0 source bytes fill the chunk with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// Chunk index of (row, 16-byte chunk) in a tile of CH chunks a row; the
// chunk is XORed with the row's low bits, a bijection within each row.
template <int CH>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  return row * CH + (chunk ^ (row & MASK));
}

// Rows row0 .. row0 + 63 of one (b, h) slice into a swizzled tile; rows past
// s are zero-filled (their address is clamped to row 0 and nothing is read).
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(uint4* tile, const T* src, long long ss, int row0, int s,
                                          int tid) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  constexpr int PER = BK * CH / NT;
  static_assert(BK * CH % NT == 0, "tile chunks must split evenly over the threads");
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int idx = it * NT + tid;
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < s;
    const T* p = src + (ok ? (long long)(row0 + r) * ss : 0) + c * (16 / (int)sizeof(T));
    cp_async16(tile + swz<CH>(r, c), p, ok);
  }
}

// ------------------------- bf16 tensor-core fragments ------------------------
//
// mma.sync m16n8k16 with lane = 4 g + tg: the A fragment (16 x 16, row major)
// holds (g, 2tg..2tg+1), (g+8, 2tg..), (g, 8+2tg..), (g+8, 8+2tg..); B (16 x 8)
// holds (k 2tg..2tg+1, n g) and (k 8+2tg.., n g); the accumulator of an
// n8 tile holds (g, 2tg..2tg+1) and (g+8, 2tg..2tg+1). So two n8 tiles of an
// accumulator are, packed to bf16, the A fragment of one k16 step.

// two bf16 at an even column of a swizzled row, as one 32-bit word
template <int CH>
__device__ __forceinline__ uint32_t ld_pair(const uint4* tile, int row, int col) {
  const uint4* chunk = tile + swz<CH>(row, col >> 3);
  return reinterpret_cast<const uint32_t*>(chunk)[(col & 7) >> 1];
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of rows r0 and r0 + 8 of a swizzled (64 x D) tile, KS = D / 16
// k-steps: the operand that stays in registers (Q in the forward and dq, K
// and V in dkv, dO in dq).
template <int CH, int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4], const uint4* tile, int r0,
                                             int tg) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    f[kk][0] = ld_pair<CH>(tile, r0, kk * 16 + tg * 2);
    f[kk][1] = ld_pair<CH>(tile, r0 + 8, kk * 16 + tg * 2);
    f[kk][2] = ld_pair<CH>(tile, r0, kk * 16 + 8 + tg * 2);
    f[kk][3] = ld_pair<CH>(tile, r0 + 8, kk * 16 + 8 + tg * 2);
  }
}

// acc (16 x 64) = A (16 x D, fragments in registers) . T^T, T a swizzled
// (64 x D) tile: the B operand of n-tile j is T's rows j*8 .. j*8 + 7.
template <int CH, int KS>
__device__ __forceinline__ void mma_a_tt(float (&acc)[8][4], const uint32_t (&a)[KS][4],
                                         const uint4* tile, int g, int tg) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t b0 = ld_pair<CH>(tile, j * 8 + g, kk * 16 + tg * 2);
      const uint32_t b1 = ld_pair<CH>(tile, j * 8 + g, kk * 16 + 8 + tg * 2);
      mma_bf16(acc[j], a[kk], b0, b1);
    }
  }
}

// out (16 x D) += X (16 x 64, an accumulator in registers, rounded to bf16)
// . T, T a swizzled (64 x D) tile read transposed by ldmatrix.
template <int CH, int NO>
__device__ __forceinline__ void mma_acc_t(float (&out)[NO][4], const float (&x)[8][4],
                                          const uint4* tile, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const int row = kk * 16 + (mi & 1) * 8 + rr;
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, tile + swz<CH>(row, np * 2 + (mi >> 1)));
      mma_bf16(out[2 * np], pa, bv[0], bv[1]);
      mma_bf16(out[2 * np + 1], pa, bv[2], bv[3]);
    }
  }
}

// One launch with `smem` bytes of dynamic shared memory, opting in above
// 48 KB; returns the launch's error code.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace fnx_attn
