// Tile-rasterizer kernels for Hopper (sm_90a): composite forward, composite
// backward and the gradient combine. Plain C interface, loaded with ctypes by
// fluidnexus_torch/ops/rasterizer_cuda.py, which also holds each kernel's plain
// PyTorch version.
//
// Layout shared by the three kernels:
//   packed (T, K, F) f32, F = 7 + C, rows [x y | ca cb cc | opacity | color(C) | depth],
//     tile t's slots front to back by depth; slot s is live iff s < counts[t].
//   P = tile_x * tile_y pixels per tile, row-major over (tile_y, tile_x);
//     one block per tile, one thread per pixel.
//
// Semantics (those of fluidnexus_tpu/ops/rasterizer.py:_composite_tiles):
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy, dx = x - px, dy = y - py,
//   alpha = min(.99, op * exp(power)), slot skipped if power > 0 or alpha < 1/255;
//   a contribution counts only while T >= 1e-4, but T keeps multiplying;
//   median depth: the depth of the slot where T crosses 0.5, else 15.
//
// power is computed from dx, dy directly: the expanded monomial form
// (px^2, px py, ...) cancels catastrophically in f32 at px ~ 960.

#include <cuda_runtime.h>

namespace {

constexpr int CKPT = 32;             // slots between saved transmittance checkpoints
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_MIN = 1e-4f;
constexpr float MEDIAN_DEFAULT = 15.0f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float splat_power(const float* r, float dx, float dy) {
  return -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
}

// ---------------------------------------------------------------------------
// Composite forward. Replaces the Pallas kernel
// fluidnexus_tpu/ops/rasterizer_pallas.py:_fwd_kernel/_fwd_one (run by _run_fwd).
//
// Bound on the H100: one exp and ~20 f32 operations per (slot, pixel) over the
// live prefix, against one read of the live rows and one write of the
// (C + 2) P outputs per tile: it is bound by operations. The design keeps the
// per-pixel state (T, C accumulators, median) in registers, stages the tile's
// rows through shared memory in batches of P rows with one coalesced load per
// batch (the shape of the reference renderCUDA), and walks only the live
// prefix. Every CKPT slots it saves T, so the backward can recompute any slot's
// T from the window start exactly: final T alone underflows after hundreds of
// splats and cannot be divided back.
// ---------------------------------------------------------------------------
template <int C>
__global__ void composite_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                                     float* __restrict__ accum, float* __restrict__ final_t,
                                     float* __restrict__ median, float* __restrict__ ckpt,
                                     int K, int tiles_x, int tile_x, int tile_y) {
  constexpr int F = 7 + C;
  extern __shared__ float rows[];  // [P][F]
  const int t = blockIdx.x;
  const int P = blockDim.x;
  const int i = threadIdx.x;
  const float px = (float)((t % tiles_x) * tile_x + i % tile_x);
  const float py = (float)((t / tiles_x) * tile_y + i / tile_x);
  const int cnt = counts[t];
  const int nck = (K + CKPT - 1) / CKPT;
  const float* tile_rows = packed + (size_t)t * K * F;

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float depth = MEDIAN_DEFAULT;
  bool med_set = false;

  for (int b0 = 0; b0 < cnt; b0 += P) {
    const int nb = min(P, cnt - b0);
    __syncthreads();  // the previous batch is consumed
    for (int e = i; e < nb * F; e += P) rows[e] = tile_rows[(size_t)b0 * F + e];
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const int s = b0 + j;
      if (s % CKPT == 0) ckpt[((size_t)t * nck + s / CKPT) * P + i] = T;
      const float* r = rows + j * F;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power = splat_power(r, dx, dy);
      const float a = fminf(ALPHA_MAX, r[5] * expf(power));
      if (power > 0.0f || a < ALPHA_MIN) continue;
      const float t_after = T * (1.0f - a);
      if (T >= T_MIN) {
        const float w = a * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * r[6 + c];
        if (!med_set && T > 0.5f && t_after < 0.5f) {
          depth = r[6 + C];
          med_set = true;
        }
      }
      T = t_after;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) accum[((size_t)t * C + c) * P + i] = acc[c];
  final_t[(size_t)t * P + i] = T;
  median[(size_t)t * P + i] = depth;
}

// ---------------------------------------------------------------------------
// Composite backward. Replaces the Pallas kernel
// fluidnexus_tpu/ops/rasterizer_pallas.py:_bwd_kernel/_bwd_one (run by _run_bwd).
//
// Emits the per-slot packed gradient [dxy | dconic | dop | dcolor | 0] of
// _bwd_one: no gradient through depth or order, none through the alpha clamp
// at .99, dop = da * raw / op, and the gT * T_final term.
//
// Bound on the H100: by operations, like the forward, plus one reduction of
// 6 + C values over the P pixels for every live slot. The design walks the
// live prefix back to front one checkpoint window at a time: it recomputes
// the window's T before each slot front to back from the saved checkpoint
// (bit-identical to the forward, since the same products are taken in the
// same order), keeps them in shared memory, then goes back through the
// window carrying the suffix colour mass. Each slot's gradient is reduced
// over the pixels with warp shuffles into shared memory, and the warps'
// partial sums are added once per window: no global atomics per pixel.
// ---------------------------------------------------------------------------
template <int C>
__global__ void composite_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                                     const float* __restrict__ gacc, const float* __restrict__ gft,
                                     const float* __restrict__ final_t, const float* __restrict__ ckpt,
                                     float* __restrict__ dpacked,
                                     int K, int tiles_x, int tile_x, int tile_y) {
  constexpr int F = 7 + C;
  constexpr int G = 6 + C;  // reduced fields: dx dy dca dcb dcc dop dcolor(C)
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int P = blockDim.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nwarps = P >> 5;
  float* rows = smem;                        // [CKPT][F]
  float* part = rows + CKPT * F;             // [CKPT][nwarps][G]
  float* t_before = part + CKPT * nwarps * G;  // [CKPT][P]

  const int cnt = counts[t];
  if (cnt == 0) return;  // the whole block: counts[t] is uniform
  const float px = (float)((t % tiles_x) * tile_x + i % tile_x);
  const float py = (float)((t / tiles_x) * tile_y + i / tile_x);
  const int nck = (K + CKPT - 1) / CKPT;
  const float* tile_rows = packed + (size_t)t * K * F;

  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = gacc[((size_t)t * C + c) * P + i];
  const float g_t_term = gft[(size_t)t * P + i] * final_t[(size_t)t * P + i];
  float suffix = 0.0f;  // sum over later slots k of (color_k . g) * w_k

  for (int win = (cnt - 1) / CKPT; win >= 0; --win) {
    const int w0 = win * CKPT;
    const int nw = min(CKPT, cnt - w0);
    __syncthreads();  // the previous window's rows and partial sums are consumed
    for (int e = i; e < nw * F; e += P) rows[e] = tile_rows[(size_t)w0 * F + e];
    __syncthreads();

    float T = ckpt[((size_t)t * nck + win) * P + i];
    for (int j = 0; j < nw; ++j) {
      t_before[j * P + i] = T;
      const float* r = rows + j * F;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power = splat_power(r, dx, dy);
      const float a = fminf(ALPHA_MAX, r[5] * expf(power));
      if (!(power > 0.0f || a < ALPHA_MIN)) T *= 1.0f - a;
    }

    for (int j = nw - 1; j >= 0; --j) {
      const float* r = rows + j * F;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power = splat_power(r, dx, dy);
      const float raw = r[5] * expf(power);
      const float a = fminf(ALPHA_MAX, raw);
      const bool ok = !(power > 0.0f || a < ALPHA_MIN);
      float v[G];
#pragma unroll
      for (int f = 0; f < G; ++f) v[f] = 0.0f;
      if (ok) {
        const float tb = t_before[j * P + i];
        const float alive = tb >= T_MIN ? 1.0f : 0.0f;
        float gdotcol = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) gdotcol += r[6 + c] * g[c];
        const float w = a * tb * alive;
        if (raw < ALPHA_MAX) {
          const float da = gdotcol * tb * alive - (suffix + g_t_term) / fmaxf(1.0f - a, 0.01f);
          const float dpower = da * a;
          v[0] = -dpower * (r[2] * dx + r[3] * dy);
          v[1] = -dpower * (r[4] * dy + r[3] * dx);
          v[2] = -0.5f * dpower * dx * dx;
          v[3] = -dpower * dx * dy;
          v[4] = -0.5f * dpower * dy * dy;
          v[5] = da * (raw / fmaxf(r[5], 1e-20f));
        }
#pragma unroll
        for (int c = 0; c < C; ++c) v[6 + c] = w * g[c];
        suffix += gdotcol * w;
      }
      if (__any_sync(FULL_MASK, ok)) {
#pragma unroll
        for (int f = 0; f < G; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[f] += __shfl_down_sync(FULL_MASK, v[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < G; ++f) part[(j * nwarps + warp) * G + f] = v[f];
      }
    }
    __syncthreads();
    for (int e = i; e < nw * G; e += P) {
      const int j = e / G;
      const int f = e - j * G;
      float s = 0.0f;
      for (int wp = 0; wp < nwarps; ++wp) s += part[(j * nwarps + wp) * G + f];
      dpacked[((size_t)t * K + w0 + j) * F + f] = s;  // depth column F-1 stays 0
    }
  }
}

// ---------------------------------------------------------------------------
// Gradient combine: out[gid[t, s]] += g[t, s] over each tile's live prefix.
// Replaces the Pallas kernel fluidnexus_tpu/ops/rasterizer_pallas.py:
// _combine_kernel/combine_rows_rmw, the adjoint of the per-tile row gather
// (the reference CUDA backward's atomicAdd).
//
// Bound on the H100: by bytes (F floats read and F atomics per live slot, no
// arithmetic to speak of). One thread per slot; a dead slot reads only its
// tile's count, never its row. The atomics land in L2, where the (N, F)
// accumulator of a few MB stays resident.
// ---------------------------------------------------------------------------
__global__ void combine_kernel(const float* __restrict__ g, const long long* __restrict__ gid,
                               const int* __restrict__ counts, float* __restrict__ out,
                               int T, int K, int F) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)T * K) return;
  const int t = (int)(e / K);
  const int s = (int)(e - (long long)t * K);
  if (s >= counts[t]) return;
  const float* src = g + e * F;
  float* dst = out + gid[e] * F;
  for (int f = 0; f < F; ++f) atomicAdd(dst + f, src[f]);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_tile(int P) { return P <= 0 || P % 32 != 0 || P > 1024; }

}  // namespace

extern "C" {

int fnx_ckpt_interval() { return CKPT; }

int fnx_composite_fwd(const float* packed, const int* counts, float* accum, float* final_t,
                      float* median, float* ckpt, int T, int K, int C, int tiles_x, int tile_x,
                      int tile_y, void* stream) {
  const int P = tile_x * tile_y;
  if (bad_tile(P)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const size_t smem = (size_t)P * (7 + C) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (C) {
    case 1:
      if ((err = allow_smem(composite_fwd_kernel<1>, smem)) != cudaSuccess) return (int)err;
      composite_fwd_kernel<1><<<T, P, smem, st>>>(packed, counts, accum, final_t, median, ckpt, K,
                                                  tiles_x, tile_x, tile_y);
      break;
    case 3:
      if ((err = allow_smem(composite_fwd_kernel<3>, smem)) != cudaSuccess) return (int)err;
      composite_fwd_kernel<3><<<T, P, smem, st>>>(packed, counts, accum, final_t, median, ckpt, K,
                                                  tiles_x, tile_x, tile_y);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fnx_composite_bwd(const float* packed, const int* counts, const float* gacc, const float* gft,
                      const float* final_t, const float* ckpt, float* dpacked, int T, int K, int C,
                      int tiles_x, int tile_x, int tile_y, void* stream) {
  const int P = tile_x * tile_y;
  if (bad_tile(P)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const size_t smem = (size_t)(CKPT * (7 + C) + CKPT * (P / 32) * (6 + C) + CKPT * P) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (C) {
    case 1:
      if ((err = allow_smem(composite_bwd_kernel<1>, smem)) != cudaSuccess) return (int)err;
      composite_bwd_kernel<1><<<T, P, smem, st>>>(packed, counts, gacc, gft, final_t, ckpt, dpacked,
                                                  K, tiles_x, tile_x, tile_y);
      break;
    case 3:
      if ((err = allow_smem(composite_bwd_kernel<3>, smem)) != cudaSuccess) return (int)err;
      composite_bwd_kernel<3><<<T, P, smem, st>>>(packed, counts, gacc, gft, final_t, ckpt, dpacked,
                                                  K, tiles_x, tile_x, tile_y);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fnx_combine_rows(const float* g, const long long* gid, const int* counts, float* out, int T,
                     int K, int F, void* stream) {
  const long long slots = (long long)T * K;
  if (slots == 0) return 0;
  const int threads = 256;
  const long long blocks = (slots + threads - 1) / threads;
  combine_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(g, gid, counts, out, T, K, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
