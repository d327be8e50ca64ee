// Non-local-means denoise of one 8-bit gray image for Hopper (sm_90a):
// OpenCV's fastNlMeansDenoising(gray, None, h, 7, 21), bit for bit. Plain C
// interface, loaded with ctypes by fluidnexus_torch/ops/nlmeans_cuda.py; the
// plain PyTorch version is fluidnexus_torch/utils/nlmeans.denoise_plain.
//
// Replaces no Pallas kernel: the JAX package denoises on the host through
// OpenCV (fluidnexus_tpu/data/dataset_builders.py:52-56, denoise_image),
// and the port runs the ScalarFlow preprocess on the card with no OpenCV.
//
// What it computes (utils/nlmeans.py has the derivation from OpenCV's
// FastNlMeansDenoisingInvoker<uchar, int, unsigned, DistSquared, int>): for
// each pixel and each of the 21 x 21 offsets around it, ssd = the sum over
// the 7 x 7 patch of squared differences between the patch at the pixel and
// the patch at the offset, in the image padded by 13 with BORDER_REFLECT_101
// (reflected again where 13 exceeds the image: reflect101 is OpenCV's
// borderInterpolate loop); weight = head[ssd >> shift], 0 past the table's
// non-zero head; out = (sum w p + sum w / 2) / sum w in unsigned 32-bit,
// p the pixel at the offset. Every term is an exact integer (ssd < 49 * 255^2
// < 2^22; sum w p < 441 * 19096 * 255 < 2^31), so any order of the sums gives
// OpenCV's bits.
//
// Design (a simple first kernel): one thread an output pixel, a block of
// 32 x 8 pixels. The block stages its tile of the padded image, (8 + 26) x
// (32 + 26) pixels as int32, into shared memory through the reflect index
// map (the padding is never built in device memory), and the weight table's
// non-zero head (48 entries at h 3) beside it. A thread keeps its own 7 x 7
// patch in registers; for each of the 21 search rows it takes the 7 template
// rows in turn, reads the 27 tile pixels the row's 21 offsets touch into
// registers once, and adds its 21 x 7 squared differences into 21 running
// ssds, then weighs the 21 offsets. So a pixel reads 21 x 7 x 27 shared words
// for its 441 x 49 squared differences.
//
// Bound on the H100: the function reads the image once and writes it once
// (2 bytes a pixel), and its least work is the sliding-sum form's ~8 integer
// operations an offset and pixel (a column sum's new squared difference and
// its update, the window's update, the weight's two multiply-adds), so it is
// bound by operations on the int32 units; this direct form does ~49 x 2 an
// offset and pixel, ~12 x the bound's count. chip_smoke.py prints both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 7 x 7 patches, 21 x 21 offsets: ops/nlmeans_cuda.TEMPLATE and SEARCH
constexpr int TW = 3;              // template half width
constexpr int SW = 10;             // search half width
constexpr int TS = 2 * TW + 1;
constexpr int SS = 2 * SW + 1;
constexpr int BORDER = TW + SW;
constexpr int BX = 32, BY = 8;     // pixels a block
constexpr int TILE_X = BX + 2 * BORDER, TILE_Y = BY + 2 * BORDER;
constexpr int MAX_HEAD = 8192;     // table entries staged (h up to ~39)

// OpenCV's borderInterpolate for BORDER_REFLECT_101.
__device__ __forceinline__ int reflect101(int p, int n) {
  if (n == 1) return 0;
  while ((unsigned)p >= (unsigned)n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

__global__ void __launch_bounds__(BX * BY)
nlmeans_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int H, int W,
               const int* __restrict__ head, int n_head, int shift) {
  __shared__ int tile[TILE_Y][TILE_X];
  extern __shared__ int weight[];
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  for (int k = tid; k < TILE_Y * TILE_X; k += BX * BY) {
    const int ly = k / TILE_X, lx = k % TILE_X;
    tile[ly][lx] = src[(size_t)reflect101(y0 + ly - BORDER, H) * W +
                       reflect101(x0 + lx - BORDER, W)];
  }
  for (int k = tid; k < n_head; k += BX * BY) weight[k] = head[k];
  __syncthreads();

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x = x0 + lx, y = y0 + ly;
  if (x >= W || y >= H) return;
  int own[TS][TS];
#pragma unroll
  for (int ty = 0; ty < TS; ++ty)
#pragma unroll
    for (int tx = 0; tx < TS; ++tx) own[ty][tx] = tile[ly + SW + ty][lx + SW + tx];

  unsigned est = 0, wsum = 0;
  for (int dy = 0; dy < SS; ++dy) {
    int ssd[SS];
#pragma unroll
    for (int dx = 0; dx < SS; ++dx) ssd[dx] = 0;
#pragma unroll
    for (int ty = 0; ty < TS; ++ty) {
      const int* row = &tile[ly + dy + ty][lx];
      int r[SS + TS - 1];
#pragma unroll
      for (int c = 0; c < SS + TS - 1; ++c) r[c] = row[c];
#pragma unroll
      for (int dx = 0; dx < SS; ++dx)
#pragma unroll
        for (int tx = 0; tx < TS; ++tx) {
          const int d = own[ty][tx] - r[dx + tx];
          ssd[dx] += d * d;
        }
    }
    const int* p = &tile[ly + dy + TW][lx + TW];
#pragma unroll
    for (int dx = 0; dx < SS; ++dx) {
      const int idx = ssd[dx] >> shift;
      const unsigned w = idx < n_head ? (unsigned)weight[idx] : 0u;
      est += w * (unsigned)p[dx];
      wsum += w;
    }
  }
  // the offset (0, 0) has ssd 0, so wsum >= head[0] > 0
  dst[(size_t)y * W + x] = (uint8_t)((est + wsum / 2) / wsum);
}

}  // namespace

extern "C" {

int fnx_nlmeans_max_head() { return MAX_HEAD; }

// src, dst: (H, W) uint8, contiguous, on the card; head: n_head int32 (the
// weight table's non-zero head, head[0] > 0). Launches on `stream`; returns
// the CUDA error code of the launch.
int fnx_nlmeans(const uint8_t* src, uint8_t* dst, int H, int W, const int* head, int n_head,
                int shift, void* stream) {
  if (H <= 0 || W <= 0 || (H + BY - 1) / BY > 65535 || n_head < 1 || n_head > MAX_HEAD ||
      shift < 0 || shift > 30)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY), block(BX, BY);
  nlmeans_kernel<<<grid, block, n_head * sizeof(int), (cudaStream_t)stream>>>(
      src, dst, H, W, head, n_head, shift);
  return (int)cudaGetLastError();
}

}  // extern "C"
