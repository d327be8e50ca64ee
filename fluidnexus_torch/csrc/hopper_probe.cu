// One tile through each of hopper_common.cuh's building blocks, for the
// card-only tests (tests/test_torch_attention.py) to hold against
// torch.matmul: TMA loads of a 64-row A and 128-row B and V tile (bf16, 64
// columns, any row stride that TMA takes) completing on one mbarrier, then
//   s = A B^T       (wgmma m64n128k16, both operands K-major from shared)
//   o = bf16(s) V   (wgmma m64n64k16, A the s accumulator packed in place, V
//                    MN-major through the transpose bit)
// both written out in f32, row-major, by the accumulator layout the
// attention kernel's masking and epilogue assume. One block of one
// warpgroup. Plain C interface, loaded with ctypes.

#include "hopper_common.cuh"

namespace {

namespace hop = fnx_hopper;

constexpr int TILE = 128 * hop::ROW_BYTES;   // a 128-row tile, 16 KB
constexpr int SMEM = 1024 + TILE / 2 + 2 * TILE + 8;

__global__ void __launch_bounds__(128) hopper_probe_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ s_out,
    float* __restrict__ o_out) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (hop::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t a_s = base, b_s = base + TILE / 2, v_s = b_s + TILE, bar = v_s + TILE;
  if (threadIdx.x == 0) {
    hop::mbar_init(bar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hop::mbar_expect_tx(bar, TILE / 2 + 2 * TILE);
    hop::tma_load_4d(a_s, &ta, bar, 0, 0, 0, 0);
    hop::tma_load_4d(b_s, &tb, bar, 0, 0, 0, 0);
    hop::tma_load_4d(v_s, &tv, bar, 0, 0, 0, 0);
  }
  hop::mbar_wait(bar, 0);

  float s[64], acc[32];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  hop::fence_regs(s);
  hop::wgmma_fence();
  hop::product_abt(s, a_s, b_s);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_out[(r0 + 8 * (e >> 1)) * 128 + 8 * j + 2 * tg + (e & 1)] = s[4 * j + e];

  hop::pack_a_frags(p, s);
  hop::fence_regs(acc);
  hop::fence_regs(p);
  hop::wgmma_fence();
  hop::product_pv(acc, p, v_s);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_out[(r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * tg + (e & 1)] = acc[4 * j + e];
}

}  // namespace

extern "C" {

// a (64, 64), b and v (128, 64) bf16 with row strides (in elements) as, bs,
// vs; s_out (64, 128) and o_out (64, 64) f32. Returns a CUDA error code, or
// 1000 + its CUresult when a tensor map cannot be encoded.
int fnx_hopper_probe(const void* a, const void* b, const void* v, float* s_out, float* o_out,
                     long long as, long long bs, long long vs, void* stream) {
  CUtensorMap ta, tb, tv;
  int err = hop::encode_bf16_rows(&ta, a, 1, 1, 64, 64 * as, 64 * as, as, 64);
  if (err == 0) err = hop::encode_bf16_rows(&tb, b, 1, 1, 128, 128 * bs, 128 * bs, bs, 128);
  if (err == 0) err = hop::encode_bf16_rows(&tv, v, 1, 1, 128, 128 * vs, 128 * vs, vs, 128);
  if (err != 0) return 1000 + err;
  cudaError_t st = cudaFuncSetAttribute(hopper_probe_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (st != cudaSuccess) return (int)st;
  hopper_probe_kernel<<<1, 128, SMEM, (cudaStream_t)stream>>>(ta, tb, tv, s_out, o_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
