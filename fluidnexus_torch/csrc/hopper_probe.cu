// One tile through each of hopper_common.cuh's building blocks, for the
// card-only tests (tests/test_torch_attention.py) to hold against
// torch.matmul: TMA loads of a 64-row A and 128-row B and V tile (bf16, 64
// columns, any row stride that TMA takes) and a 1-D bulk copy of 256 f32,
// all completing on one mbarrier, then
//   s = A B^T       (wgmma m64n128k16, both operands K-major from shared)
//   w = A B[:64]^T  (wgmma m64n64k16, the same operands' first 64 rows of B)
//   o = bf16(s) V   (wgmma m64n64k16, A the s accumulator packed in place, V
//                    MN-major through the transpose bit)
//   t += B^T V      (wgmma m64n64k16, both operands MN-major from shared;
//                    staged as f32 in shared memory and added into t_out
//                    by TMA reduce-add, as the attention backward sums dQ)
//   u_c = bf16(s)[:, 64c:64c+64]^T V[:64], c = 0, 1  (bf16(s) stored to
//                    shared as A fragments, in the swizzled layout, then
//                    read by the MN-major product: the backward's dS tile)
// s, w, o and u written out in f32, row-major, by the accumulator layout the
// attention kernels' masking and epilogues assume; the bulk copy's 256 f32
// copied back out. One block of one warpgroup. Plain C interface, loaded
// with ctypes.

#include "hopper_common.cuh"

namespace {

namespace hop = fnx_hopper;

constexpr int TILE = 128 * hop::ROW_BYTES;   // a 128-row tile, 16 KB
constexpr int ROWS = 256 * 4;                // the bulk copy's bytes
constexpr int SMEM = 1024 + TILE / 2 + 2 * TILE + 2 * TILE + TILE + ROWS + 8;

__global__ void __launch_bounds__(128) hopper_probe_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tt,
    const float* __restrict__ r_in,
    float* __restrict__ s_out, float* __restrict__ o_out, float* __restrict__ u_out,
    float* __restrict__ w_out, float* __restrict__ r_out) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (hop::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t a_s = base, b_s = base + TILE / 2, v_s = b_s + TILE, x_s = v_s + TILE;
  const uint32_t y_s = x_s + 2 * TILE, r_s = y_s + TILE, bar = r_s + ROWS;
  const float* r_gen = reinterpret_cast<const float*>(smem + (r_s - hop::smem_addr(smem)));
  if (threadIdx.x == 0) {
    hop::mbar_init(bar, 1);
    hop::fence_barrier_init();
  }
  // rows 64..127 of both tiles of x hold zeros: the u products sum over 128
  // rows, of which the s fragments fill 64
  for (int i = threadIdx.x; i < 2 * 64 * hop::ROW_BYTES / 4; i += 128) {
    const int tile = i / (64 * hop::ROW_BYTES / 4), word = i % (64 * hop::ROW_BYTES / 4);
    hop::st_shared(x_s + tile * TILE + 64 * hop::ROW_BYTES + 4 * word, 0u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hop::mbar_expect_tx(bar, TILE / 2 + 2 * TILE + ROWS);
    hop::tma_load_4d(a_s, &ta, bar, 0, 0, 0, 0);
    hop::tma_load_4d(b_s, &tb, bar, 0, 0, 0, 0);
    hop::tma_load_4d(v_s, &tv, bar, 0, 0, 0, 0);
    hop::bulk_load(r_s, r_in, ROWS, bar);
  }
  hop::mbar_wait(bar, 0);
  r_out[threadIdx.x] = r_gen[threadIdx.x];
  r_out[128 + threadIdx.x] = r_gen[128 + threadIdx.x];

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

  float w[32];   // the first k-step overwrites it
  hop::wgmma_fence();
  hop::product_abt64(w, a_s, b_s);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(w);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) w_out[(r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * tg + (e & 1)] = w[4 * j + e];

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

  // t += B^T V, staged in shared memory and added into device memory
  hop::fence_regs(acc);
  hop::wgmma_fence();
  hop::product_atb(acc, b_s, v_s);
  hop::wgmma_commit();
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  hop::store_acc_f32(y_s, acc, 1.f, r0, tg);
  hop::fence_proxy_async();
  hop::named_barrier_sync<1, 128>();
  if (threadIdx.x == 0) {
    hop::tma_reduce_add_4d(&tt, y_s, 0, 0, 0, 0);
    hop::tma_reduce_add_4d(&tt, y_s + 64 * hop::ROW_BYTES, 32, 0, 0, 0);
    hop::bulk_commit();
    hop::bulk_wait<0>();
  }

  // bf16(s) through shared memory as the backward's dS tile
  hop::store_frags(x_s, p, r0, tg);
  hop::fence_proxy_async();
  hop::named_barrier_sync<2, 128>();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    hop::fence_regs(acc);
    hop::wgmma_fence();
    hop::product_atb(acc, x_s + c * TILE, v_s);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        u_out[c * 64 * 64 + (r0 + 8 * (e >> 1)) * 64 + 8 * j + 2 * tg + (e & 1)] = acc[4 * j + e];
  }
}

}  // namespace

extern "C" {

// a (64, 64), b and v (128, 64) bf16 with row strides (in elements) as, bs,
// vs; r_in and r_out 256 f32 (r_in 16-byte aligned); s_out (64, 128), o_out,
// t_out and w_out (64, 64), u_out (2, 64, 64) f32; t_out (contiguous) is
// added to. Returns a
// CUDA error code, or 1000 + its CUresult when a tensor map cannot be
// encoded.
int fnx_hopper_probe(const void* a, const void* b, const void* v, const float* r_in,
                     float* s_out, float* o_out, float* t_out, float* u_out, float* w_out,
                     float* r_out,
                     long long as, long long bs, long long vs, void* stream) {
  CUtensorMap ta, tb, tv, tt;
  int err = hop::encode_bf16_rows(&ta, a, 1, 1, 64, 64 * as, 64 * as, as, 64);
  if (err == 0) err = hop::encode_bf16_rows(&tb, b, 1, 1, 128, 128 * bs, 128 * bs, bs, 128);
  if (err == 0) err = hop::encode_bf16_rows(&tv, v, 1, 1, 128, 128 * vs, 128 * vs, vs, 128);
  if (err == 0) err = hop::encode_f32_rows(&tt, t_out, 1, 1, 64, 64 * 64, 64 * 64, 64, 64);
  if (err != 0) return 1000 + err;
  cudaError_t st = cudaFuncSetAttribute(hopper_probe_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (st != cudaSuccess) return (int)st;
  hopper_probe_kernel<<<1, 128, SMEM, (cudaStream_t)stream>>>(ta, tb, tv, tt, r_in, s_out, o_out,
                                                              u_out, w_out, r_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
