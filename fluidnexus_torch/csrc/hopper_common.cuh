// Hopper's building blocks (sm_90a), shared by the port's kernels that use
// them (csrc/attention.cu's bf16 forward at head_dim 64, csrc/attention_bwd.cu's
// bf16 backward at head_dim 64; csrc/hopper_probe.cu holds each against
// torch.matmul on one tile):
//   - mbarriers: init, arrive, arrive with an expected transaction count, and
//     a wait on a phase's parity that traps after ~10 s instead of hanging;
//   - TMA: a 4-D tensor map of a bf16 or f32 (b, h, s, d) tensor, encoded on
//     the host through cudaGetDriverEntryPointByVersion (no -lcuda); the tile
//     load that completes on an mbarrier; the tile reduce-add (f32) from
//     shared memory into device memory, in a bulk group; a 1-D bulk copy of
//     contiguous bytes that completes on an mbarrier;
//   - wgmma: the shared-memory matrix descriptor of a 128-byte-swizzled tile,
//     fence / commit / wait, an SS product m64n128k16, an RS product
//     m64n64k16 (A in registers, B read MN-major) and an SS product m64n64k16
//     (each operand K-major or MN-major), bf16 in, f32 accumulators;
//   - bf16 A fragments stored to shared memory in the swizzled tile layout
//     (for a later product to read), the proxy fence that makes such stores
//     visible to wgmma and TMA, a named barrier, and an f32 accumulator
//     stored to shared memory as an f32 tensor map's boxes;
//   - setmaxnreg, and a register fence that keeps the compiler from moving
//     reads of an accumulator above the wait that completes it.
//
// Shared tiles are rows of 64 bf16 (128 bytes) as TMA writes them with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer: the 16-byte
// chunk c of row r sits at chunk c ^ (r & 7). That is wgmma's 128-byte
// swizzle atom (8 rows of 128 bytes), so a tile is read in place:
//   K-major (the product's depth along the row: Q and K in S = Q K^T): the
//     stride between 8-row groups (SBO) is 1024 bytes, LBO is unused; a k-step
//     of 16 elements (32 bytes) adds 2 to the descriptor's address field.
//   MN-major (V in O += P V, rows along the depth, the 64 outputs along the
//     row; the transpose bit): SBO, the stride between 8-row groups along the
//     depth, is 1024 bytes; LBO, the stride between 64-column atoms, is unused
//     at 64 columns; a k-step of 16 rows adds 2048 bytes. An A operand read
//     MN-major (64 rows of the product along the tile's row) is laid out the
//     same way.
//
// Accumulator layout of m64nNk16 (f32), thread t = 32 w + 4 g + tg of the
// warpgroup: d[4 j + e] holds row 16 w + g + 8 (e >> 1), column 8 j + 2 tg +
// (e & 1). The A fragment of an RS product (16 bf16 columns of k-step kk)
// holds the same rows at columns 2 tg, 2 tg + 1, 8 + 2 tg, 8 + 2 tg + 1, so the
// accumulator's column tiles 2 kk and 2 kk + 1, rounded to bf16 and packed in
// pairs, are that fragment in place (pack_a_frags).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fnx_hopper {

// ------------------------------- host: TMA maps -----------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime finds it; null where it is
// missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A map of a (B, H, S, 64) tensor of `type` (`bytes` a element) with
// element strides sb, sh, ss (d contiguous) as (d, s, h, b), innermost first,
// moved in boxes of box_d x box_s of one (b, h) to and from 128-byte-swizzled
// shared tiles (box_d elements make one 128-byte row). Rows past S read as
// zeros and are not written. TMA needs a 16-byte-aligned base and byte
// strides that are multiples of 16. Returns the CUresult of
// cuTensorMapEncodeTiled.
inline int encode_rows(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* ptr,
                       int B, int H, int S, long long sb, long long sh, long long ss, int box_d,
                       int box_s) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {64, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * bytes), (cuuint64_t)(sh * bytes),
                                 (cuuint64_t)(sb * bytes)};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, (cuuint32_t)box_s, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// bf16 rows: boxes of 64 x box_s, a whole row a box
inline int encode_bf16_rows(CUtensorMap* map, const void* ptr, int B, int H, int S, long long sb,
                            long long sh, long long ss, int box_s) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, B, H, S, sb, sh, ss, 64, box_s);
}

// f32 rows: boxes of 32 x box_s, half a row a box
inline int encode_f32_rows(CUtensorMap* map, const void* ptr, int B, int H, int S, long long sb,
                           long long sh, long long ss, int box_s) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, B, H, S, sb, sh, ss, 32, box_s);
}

// ------------------------------ device: mbarriers ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// one arrival, and `bytes` more to come from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed (a fresh barrier's
// phase 0 is under way, so a wait on parity 1 passes at once). A phase that
// never completes is a fault in the kernel: it traps after ~2e10 cycles
// (~10 s), so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// ---------------------------------- device: TMA ------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box at (c0, c1, c2, c3), innermost first, into shared memory at `dst`;
// its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous memory at `src` (16-byte aligned)
// into shared memory at `dst` (16-byte aligned); they complete on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// Adds the box at shared `src` into the tensor at (c0, c1, c2, c3), innermost
// first (rows past its bounds are skipped), in this thread's bulk group.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// --------------------------------- device: wgmma -----------------------------

// Descriptor of a 128-byte-swizzled tile at shared address `addr` (1024-byte
// aligned, or advanced from such an address by a k-step inside the atom).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Tells the compiler that `x` changes here: reads of an accumulator stay
// after the wait that completes it, writes before the product that reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j]) :: "memory");
}

// d (64 x 128) (+)= A (64 x 16, K-major in shared) . B (128 x 16, K-major in
// shared)^T; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, a fragment in registers) . B (16 x 64, MN-major
// in shared: rows along the depth, read through the transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) (+)= A (64 x 16) . B (16 x 64), both from shared, each read
// K-major (0: the depth along the tile's row, as Q and K in S = Q K^T) or
// MN-major (1: the tile's rows along the depth, through the transpose bit);
// scale_d 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ------------------------- device: tile products at d = 64 -------------------

constexpr int ROW_BYTES = 128;   // a row of 64 bf16: one swizzle span

// s (64 x 128) = A . B^T, A a 64-row tile and B a 128-row tile of 64 bf16 a
// row (both K-major at their shared addresses): 4 k-steps, one issue group.
__device__ __forceinline__ void product_abt(float (&s)[64], uint32_t a_addr, uint32_t b_addr) {
  const uint64_t da = desc_sw128(a_addr, 16, 1024), db = desc_sw128(b_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss(s, da + 2 * kk, db + 2 * kk, kk > 0);
}

// s (64 x 64) = A . B^T as above with B a 64-row tile: the same 4 k-steps on
// the m64n64k16 shape.
__device__ __forceinline__ void product_abt64(float (&s)[32], uint32_t a_addr, uint32_t b_addr) {
  const uint64_t da = desc_sw128(a_addr, 16, 1024), db = desc_sw128(b_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(s, da + 2 * kk, db + 2 * kk, kk > 0);
}

// acc (64 x 64) += P (64 x 16 KS, fragments in registers) . V, V a tile of
// 16 KS rows of 64 bf16 a row at its shared address (MN-major): KS k-steps
// (8: a 128-row V).
template <int KS>
__device__ __forceinline__ void product_pv(float (&acc)[32], const uint32_t (&p)[KS][4],
                                           uint32_t v_addr) {
  const uint64_t dv = desc_sw128(v_addr, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_m64n64k16_rs_mn(acc, p[kk], dv + kk * (16 * ROW_BYTES >> 4));
}

// acc (64 x 64) = A^T . B, A and B 128-row tiles of 64 bf16 a row at their
// shared addresses (A's rows are the depth: both read MN-major): 8 k-steps,
// the first overwriting acc.
__device__ __forceinline__ void product_atb(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
  const uint64_t da = desc_sw128(a_addr, 1024, 1024), db = desc_sw128(b_addr, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss<1, 1>(acc, da + kk * (16 * ROW_BYTES >> 4), db + kk * (16 * ROW_BYTES >> 4),
                             kk > 0);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the (64 x 16 KS) accumulator s as bf16 A fragments of KS k-steps of 16
// columns
template <int KS>
__device__ __forceinline__ void pack_a_frags(uint32_t (&p)[KS][4], const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    p[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(x) : "memory");
}

// Rows r and r + 8 of a (rows x 16 KS) bf16 matrix, held as this thread's A
// fragments p (pack_a_frags's layout: r = 16 w + g, plus a multiple of 16),
// into `buf`: 128-row tiles of 64 bf16 a row, columns 0..63 in the first,
// 64..127 in the next, swizzled as TMA writes them, so that a product reads
// a tile in place. Each store of a warp hits 32 distinct banks.
template <int KS>
__device__ __forceinline__ void store_frags(uint32_t buf, const uint32_t (&p)[KS][4], int r,
                                            int tg) {
  const int sw = r & 7;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t row0 = buf + (kk >> 2) * 128 * ROW_BYTES + r * ROW_BYTES + tg * 4;
    const uint32_t row1 = row0 + 8 * ROW_BYTES;
    const int c = 2 * (kk & 3);   // the 16-byte chunk of columns 16 kk .. 16 kk + 7 in its tile
    st_shared(row0 + ((c ^ sw) << 4), p[kk][0]);
    st_shared(row1 + ((c ^ sw) << 4), p[kk][1]);
    st_shared(row0 + (((c + 1) ^ sw) << 4), p[kk][2]);
    st_shared(row1 + (((c + 1) ^ sw) << 4), p[kk][3]);
  }
}

// makes this thread's stores to shared memory visible to the async proxy
// (wgmma's and TMA's reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier ID (not 0, which __syncthreads takes) over N threads
template <int ID, int N>
__device__ __forceinline__ void named_barrier_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// Rows r and r + 8 (r = 16 w + g, plus a multiple of 16) of a (64 x 64) f32
// accumulator, times `scale`, into `buf` (1024-byte aligned) as an f32 map of
// encode_f32_rows with box_s 64 reads them: columns 0..31, then 32..63, each
// box 64 rows of 128 bytes, 128-byte swizzled. A warp's stores of one column
// tile hit each bank twice.
__device__ __forceinline__ void store_acc_f32(uint32_t buf, const float (&acc)[32], float scale,
                                              int r, int tg) {
  const int sw = r & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 2 * (j & 3) + (tg >> 1);   // the 16-byte chunk of columns 8 j + 2 tg in its box
    const uint32_t a = buf + (j >> 2) * 64 * ROW_BYTES + r * ROW_BYTES + ((c ^ sw) << 4) + (tg & 1) * 8;
    st_shared_v2(a, acc[4 * j] * scale, acc[4 * j + 1] * scale);
    st_shared_v2(a + 8 * ROW_BYTES, acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

}  // namespace fnx_hopper
