// Tile-rasterizer kernels for Hopper (sm_90a): composite forward, composite
// backward and the gradient combine. Plain C interface, loaded with ctypes by
// fluidnexus_torch/ops/rasterizer_cuda.py, which also holds each kernel's plain
// PyTorch version.
//
// Layout shared by the three kernels:
//   packed (T, K, F) f32, F = 7 + C, rows [x y | ca cb cc | opacity | color(C) | depth],
//     tile t's slots front to back by depth; slot s is live iff s < counts[t].
//   P = tile_x * tile_y pixels per tile, row-major over (tile_y, tile_x),
//     any P >= 1; one block per tile, or per chunk of MAX_BLOCK_P pixels of a
//     larger tile (the forward and the backward a thread per two adjacent
//     pixels, the combine 128 threads per tile).
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

// A slot's alpha at pixel (px, py); ok is false where the slot is skipped. The forward
// and the backward's re-sweep both take it from here, and every step names
// its rounding (the fused multiply-adds are written out, none is left for
// the compiler to choose, which it could do differently in the two kernels),
// so the backward's T is bit-identical to the forward's.
__device__ __forceinline__ float splat_alpha(const float* r, float px, float py, bool& ok) {
  const float dx = __fsub_rn(r[0], px);
  const float dy = __fsub_rn(r[1], py);
  const float quad = __fmaf_rn(__fmul_rn(r[2], dx), dx, __fmul_rn(__fmul_rn(r[4], dy), dy));
  const float power = __fmaf_rn(-0.5f, quad, -__fmul_rn(__fmul_rn(r[3], dx), dy));
  const float a = fminf(ALPHA_MAX, __fmul_rn(r[5], expf(power)));
  ok = !(power > 0.0f || a < ALPHA_MIN);
  return a;
}

// T after a slot of alpha a.
__device__ __forceinline__ float transmit(float T, float a) { return __fmul_rn(T, __fsub_rn(1.0f, a)); }

// The first N floats of a row in shared memory (16-byte aligned), as float4 loads.
template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(src)[k];
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// Tile order, shared by the forward and the backward: each launches
// tile_order_kernel on its stream just before itself, and its blocks take
// their tiles from `order`, heaviest first, so the 512-slot tiles do not
// trail the grid. The order is a workspace of T ints that the wrapper sizes
// for each launch and hands in (allocated on the launch's stream), so a
// launch takes any number of tiles and launches on two streams at once do
// not share it. A tile of more than MAX_BLOCK_P pixels runs as chunks of at
// most MAX_BLOCK_P, one block each; a tile's chunks take neighbouring
// blocks, so the order stays per tile.
// ---------------------------------------------------------------------------
constexpr int ORDER_THREADS = 1024;   // tile_order_kernel's block, one count bucket a thread
constexpr int MAX_BLOCK_P = 1024;     // most pixels one block of the forward or the backward takes

// Chunks of at most MAX_BLOCK_P pixels a tile of P pixels runs as.
__host__ __device__ __forceinline__ int tile_chunks(int P) {
  return (P + MAX_BLOCK_P - 1) / MAX_BLOCK_P;
}

// Tiles by descending live count (counts quantised to ORDER_THREADS
// buckets; within a bucket in no fixed order). One block: a histogram, an
// exclusive scan from the heaviest bucket, a scatter, each thread striding
// over the T tiles.
__global__ void tile_order_kernel(const int* __restrict__ counts, int* __restrict__ order, int T,
                                  int K) {
  __shared__ int start[ORDER_THREADS];
  const int b = threadIdx.x;
  start[b] = 0;
  __syncthreads();
  for (int t = b; t < T; t += ORDER_THREADS) {
    const int c = min(max(counts[t], 0), K);
    atomicAdd(&start[ORDER_THREADS - 1 - (int)((long long)c * ORDER_THREADS / (K + 1))], 1);
  }
  __syncthreads();
  for (int off = 1; off < ORDER_THREADS; off <<= 1) {  // inclusive scan
    const int v = b >= off ? start[b - off] : 0;
    __syncthreads();
    start[b] += v;
    __syncthreads();
  }
  const int mine = b ? start[b - 1] : 0;
  __syncthreads();
  start[b] = mine;  // exclusive: the bucket's first position
  __syncthreads();
  for (int t = b; t < T; t += ORDER_THREADS) {
    const int c = min(max(counts[t], 0), K);
    const int bucket = ORDER_THREADS - 1 - (int)((long long)c * ORDER_THREADS / (K + 1));
    order[atomicAdd(&start[bucket], 1)] = t;
  }
}

// A block's tile and chunk: the order's entry blockIdx.x / nch, chunk
// blockIdx.x % nch (nch = 1 where every tile fits one block).
struct TileChunk {
  int t, chunk;
};
template <bool ANY>
__device__ __forceinline__ TileChunk tile_chunk(const int* __restrict__ order, int P) {
  if constexpr (ANY) {
    const int nch = tile_chunks(P);
    return TileChunk{order[blockIdx.x / nch], (int)(blockIdx.x % nch)};
  } else {
    return TileChunk{order[blockIdx.x], 0};
  }
}

// Stores a thread's two adjacent pixels a, b at dst[0] and dst[1]: one
// float2 where the tile's rows of P floats keep dst on 8 bytes (P even;
// then both pixels lie in the tile or neither does), else each on its own,
// b only where it lies in the tile.
__device__ __forceinline__ void store_pair(float* dst, float a, float b, bool even, bool second) {
  if (even) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    dst[0] = a;
    if (second) dst[1] = b;
  }
}

// Whether the slot of row r may draw (alpha >= 1/255, as splat_alpha takes
// it) on any pixel of the box [x0, x1] x [y0, y1]. False only where that is
// ruled out with room to spare: the least of the positive definite form
// ca dx^2 + 2 cb dx dy + cc dy^2 over the box (0 at the centre, else on an
// edge at the clamped stationary point), with a slack of 1e-5 of the form's
// largest terms, which is ~100 times the f32 rounding of this test and of
// splat_alpha's own power together.
__device__ bool may_draw(const float* r, float x0, float x1, float y0, float y1) {
  const float ca = r[2], cb = r[3], cc = r[4], op = r[5];
  if (!(ca > 0.0f && cc > 0.0f && ca * cc > cb * cb && op > 0.0f)) return !(op <= 0.0f);
  const float dxl = r[0] - x1, dxh = r[0] - x0, dyl = r[1] - y1, dyh = r[1] - y0;
  auto form = [&](float dx, float dy) { return ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy; };
  float qmin = 0.0f;
  if (!(dxl <= 0.0f && dxh >= 0.0f && dyl <= 0.0f && dyh >= 0.0f)) {
    const float xs[2] = {dxl, dxh}, ys[2] = {dyl, dyh};
    qmin = 3e38f;
    for (int k = 0; k < 2; ++k) {
      qmin = fminf(qmin, form(xs[k], fminf(fmaxf(-cb * xs[k] / cc, dyl), dyh)));
      qmin = fminf(qmin, form(fminf(fmaxf(-cb * ys[k] / ca, dxl), dxh), ys[k]));
    }
  }
  const float m = fmaxf(fmaxf(fabsf(dxl), fabsf(dxh)), fmaxf(fabsf(dyl), fabsf(dyh)));
  const float slack = 1e-5f * ((ca + cc + 2.0f * fabsf(cb)) * m * m + 1.0f);
  return !(-0.5f * qmin + slack < logf(ALPHA_MIN / op));
}

// ---------------------------------------------------------------------------
// Composite forward. Replaces the Pallas kernel
// fluidnexus_tpu/ops/rasterizer_pallas.py:_fwd_kernel/_fwd_one (run by _run_fwd).
//
// Bound on the H100: one exp and ~20 f32 operations per (slot, pixel) over the
// live prefix, against one read of the live rows and one write of the
// (C + 2) P outputs per tile: it is bound by operations, and in practice by
// the instructions issued for them. The design is the backward's: a thread
// owns FWD_PPT = 2 adjacent pixels and keeps their state (T, C accumulators,
// median) in registers, so a slot's row is read from shared memory once for
// two pixels, as float4 loads at the padded stride FP; the tile's live rows
// are staged in batches of FWD_BATCH with one coalesced load; for each group
// of 32 slots a warp tests every slot against the box of its 64 pixels
// (may_draw, a slot a lane) and walks only the slots that may draw there, so
// a skipped slot costs no exp. A warp's pixels are an 8 x 8 block where the
// tile's sides are multiples of 8 (at camera 0 it walks 0.574 of the live
// (slot, pixel) pairs, against 0.611 for 16 x 4 rows), else 64 consecutive
// pixels. The skip is exact: may_draw passes every slot that splat_alpha
// takes at one of the warp's pixels, and a slot it takes at none leaves T as
// it was. The tiles run heaviest first (tile_order_kernel).
// Every CKPT slots it saves T, so the backward can recompute any slot's T from
// the window start exactly: final T alone underflows after hundreds of
// splats and cannot be divided back.
// Any tile runs. The tiles of the main path (a multiple of 32 pixels, at most
// MAX_BLOCK_P) take the instantiation ANY = false, one block a tile, a
// thread's two pixels stored as a float2, a ragged last warp's spare lanes
// masked. Every other tile takes ANY = true: a pixel past P is masked at the
// pixel (an odd P gives the last thread one pixel, and the (T, ., P) rows of
// an odd P start on odd floats, so its stores go a float at a time); a tile
// of more than MAX_BLOCK_P pixels runs as chunks of MAX_BLOCK_P (16 of the 8
// x 8 blocks, or 1 024 consecutive pixels), a block each, every chunk
// walking the tile's one slot list in the same depth order: compositing is
// per pixel, so the chunks give the bits one block would; a warp that holds
// no pixel of the tile walks nothing.
// ---------------------------------------------------------------------------
constexpr int FWD_PPT = 2;       // adjacent pixels a thread owns in the forward
constexpr int FWD_BATCH = 128;   // live rows staged in shared memory at once

template <int C, bool ANY>
__global__ void __launch_bounds__(MAX_BLOCK_P / FWD_PPT)
composite_fwd_kernel(const int* __restrict__ order, const float* __restrict__ packed,
                     const int* __restrict__ counts, float* __restrict__ accum,
                     float* __restrict__ final_t, float* __restrict__ median,
                     float* __restrict__ ckpt, int K, int tiles_x, int tile_x, int tile_y,
                     int box_skip) {
  constexpr int F = 7 + C;
  constexpr int FP = (F + 3) / 4 * 4;  // a row's stride in shared memory, float4-aligned
  static_assert(FWD_PPT == 2, "a thread's two pixels are written as a float2");
  static_assert(CKPT == 32 && FWD_BATCH % CKPT == 0, "a group of 32 slots is a checkpoint window");
  extern __shared__ float4 fwd_smem4[];
  float* rows = reinterpret_cast<float*>(fwd_smem4);  // [FWD_BATCH][FP]
  const int P = tile_x * tile_y;
  const int nthreads = blockDim.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const TileChunk tc = tile_chunk<ANY>(order, P);
  const int t = tc.t, cnt = counts[t];
  // this thread's and its warp's place in the whole tile
  const int gi = tc.chunk * (MAX_BLOCK_P / FWD_PPT) + i;
  const int warp = gi >> 5;
  const int nck = (K + CKPT - 1) / CKPT;
  const float* tile_rows = packed + (size_t)t * K * F;
  const int tx0 = (t % tiles_x) * tile_x, ty0 = (t / tiles_x) * tile_y;
  // this thread's first pixel, and the box [bx0, bx1] x [by0, by1] that holds
  // the warp's pixels (tile coordinates)
  int p0, bx0, bx1, by0, by1;
  bool warp_live = true;  // the warp holds a pixel of the tile
  if (tile_x % 8 == 0 && tile_y % 8 == 0) {  // an 8 x 8 block a warp
    bx0 = warp % (tile_x / 8) * 8;
    by0 = warp / (tile_x / 8) * 8;
    bx1 = bx0 + 7;
    by1 = by0 + 7;
    p0 = (by0 + lane / 4) * tile_x + bx0 + FWD_PPT * (lane % 4);
    if constexpr (ANY) warp_live = by0 < tile_y;
  } else {  // up to 64 consecutive pixels a warp
    const int w0 = warp * 32 * FWD_PPT, w1 = min(w0 + 32 * FWD_PPT, P) - 1;
    const bool one_row = w0 / tile_x == w1 / tile_x;
    bx0 = one_row ? w0 % tile_x : 0;
    bx1 = one_row ? w1 % tile_x : tile_x - 1;
    by0 = w0 / tile_x;
    by1 = w1 / tile_x;
    p0 = gi * FWD_PPT;
    if constexpr (ANY) warp_live = w0 < P;
  }
  const bool mine = p0 < P;  // a spare lane holds no pixel
  // where the thread's second pixel lies in the tile, and whether its pair
  // may be stored as one float2
  const bool second = !ANY || p0 + 1 < P, even = !ANY || P % 2 == 0;
  const float box_x0 = (float)(tx0 + bx0), box_x1 = (float)(tx0 + bx1);
  const float box_y0 = (float)(ty0 + by0), box_y1 = (float)(ty0 + by1);

  // T only falls, so it crosses 0.5 at most once: the median needs no flag
  float px[FWD_PPT], py[FWD_PPT], T[FWD_PPT], acc[FWD_PPT][C], depth[FWD_PPT];
#pragma unroll
  for (int q = 0; q < FWD_PPT; ++q) {
    px[q] = (float)(tx0 + (p0 + q) % tile_x);
    py[q] = (float)(ty0 + (p0 + q) / tile_x);
    T[q] = 1.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[q][c] = 0.0f;
    depth[q] = MEDIAN_DEFAULT;
  }

  for (int b0 = 0; b0 < cnt; b0 += FWD_BATCH) {
    const int nb = min(FWD_BATCH, cnt - b0);
    __syncthreads();  // the previous batch is consumed
    for (int e = i; e < nb * F; e += nthreads) {
      const int j = e / F;
      rows[j * FP + (e - j * F)] = tile_rows[(size_t)b0 * F + e];
    }
    __syncthreads();
    for (int g0 = 0; g0 < nb; g0 += CKPT) {
      const int ng = min(CKPT, nb - g0);
      if (mine)
        store_pair(ckpt + ((size_t)t * nck + (b0 + g0) / CKPT) * P + p0, T[0], T[1], even, second);
      // bit j: slot g0 + j may draw on one of the warp's pixels (lane j tests it)
      unsigned draws = __ballot_sync(
          FULL_MASK, warp_live && lane < ng &&
                         (!box_skip || may_draw(rows + (g0 + lane) * FP, box_x0, box_x1, box_y0,
                                                box_y1)));
      while (draws) {  // warp-uniform
        const int j = __ffs(draws) - 1;
        draws &= draws - 1;
        float r[FP];
        load_row(rows + (g0 + j) * FP, r);
#pragma unroll
        for (int q = 0; q < FWD_PPT; ++q) {
          bool ok;
          const float a = splat_alpha(r, px[q], py[q], ok);
          if (!ok) continue;  // skipped: T as it was
          const float t_after = transmit(T[q], a);
          if (T[q] >= T_MIN) {
            const float w = a * T[q];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[q][c] += w * r[6 + c];
            if (T[q] > 0.5f && t_after < 0.5f) depth[q] = r[6 + C];
          }
          T[q] = t_after;
        }
      }
    }
  }
  if (!mine) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    store_pair(accum + ((size_t)t * C + c) * P + p0, acc[0][c], acc[1][c], even, second);
  store_pair(final_t + (size_t)t * P + p0, T[0], T[1], even, second);
  store_pair(median + (size_t)t * P + p0, depth[0], depth[1], even, second);
}

// ---------------------------------------------------------------------------
// Composite backward. Replaces the Pallas kernel
// fluidnexus_tpu/ops/rasterizer_pallas.py:_bwd_kernel/_bwd_one (run by _run_bwd).
//
// Emits the per-slot packed gradient [dxy | dconic | dop | dcolor | 0] of
// _bwd_one: no gradient through depth or order, none through the alpha clamp
// at .99, dop = da * raw / op, and the gT * T_final term. Dead slots and the
// depth column are written as 0 by the kernel itself.
//
// Bound on the H100: by operations, like the forward, plus one reduction of
// G = 6 + C values over the P pixels for every live slot. The design walks
// the live prefix back to front one checkpoint window at a time, and each
// window back to front in parts of BWD_SUB slots. A re-sweep recomputes each
// (slot, pixel)'s alpha and the T before it, front to back from the
// forward's checkpoint (bit-identical to the forward: splat_alpha is shared
// and names its rounding), and keeps both in shared memory for one part; the
// back pass reads them. A window's first part is swept twice (once to reach
// the second part's T), so a (slot, pixel) takes 1.5 exps on average: with
// the whole window kept (one exp) the 64 KB of state leaves 3 blocks an SM,
// and the kernel ran 1.2 times slower. A warp skips the slots that a test
// of its pixel box (may_draw) rules out. Each thread owns BWD_PPT adjacent
// pixels and sums their share of a slot in registers first.
// The geometry gradients come from six moments of dpower in dx, dy (never in
// px, py: those monomials cancel in f32), so a slot's pixel sums are G plain
// sums: S0 = sum dp, Sx, Sy, Sxx, Sxy, Syy (dp times dx, dy, dx^2, dx dy,
// dy^2), and sum w g_c. A warp reduces them with a transposing halving (each
// level a lane keeps half the open sums and adds its partner's copy: 12
// shuffles at G = 9, not 5 G), stores one partial per warp, and a warp whose
// pixels all skip a slot stores zeros without computing. The window's
// gradient rows are formed from the warps' partials, summed in warp order
// (deterministic), and written once. The tiles run heaviest first
// (tile_order_kernel). With t_end given, the kernel also writes the T its
// re-sweep reaches at the end of each window, (T, ceil(K / CKPT), P), which a
// check holds bit for bit against the forward's next checkpoint and final T.
// Any tile runs. The main path's tiles (a multiple of 64 pixels, at most
// MAX_BLOCK_P) take the instantiation ANY = false: full warps, one block a
// tile. Every other tile takes ANY = true: a pixel past P (an odd P, a
// ragged last warp, a chunk's spare warps) reads nothing, keeps alpha 0 and
// adds nothing, so its lane's sums stay +0 and WarpHalve and the warp
// partials sum the tile's pixels alone. The shared state is BWD_SUB * P * 8
// bytes (128 KB at MAX_BLOCK_P), so a larger tile runs as chunks of
// MAX_BLOCK_P consecutive pixels, a block each, and a chunk writes its own
// G sums of each live slot (its warps' partials in warp order) into a
// workspace (T, nch, K, G); chunk_sum_kernel then forms each gradient row
// from the chunks' sums added in chunk order: deterministic, with no
// atomics, so a tile's gradient repeats bit for bit.
// ---------------------------------------------------------------------------
constexpr int BWD_PPT = 2;            // adjacent pixels a thread owns in the backward
constexpr int BWD_SUB = 16;           // slots of a window whose T and alpha it keeps at once
// Tiles of up to 2 * BWD_SMALL threads' pixels take an instantiation bounded
// at BWD_SMALL threads: bounded at 512, the 16 x 16 tiles ran 2 % slower.
constexpr int BWD_SMALL = 256;

// Transposing sum across the warp of M values a lane holds: at each level
// (lane offset O) the lanes without bit O keep the first half of the open
// sums and the others the second half, each adding its partner's copy, so a
// level costs ceil(M / 2) shuffles. After the five levels a lane holds the
// whole warp's sum of one value: the one bwd_field() names, if valid.
template <int M, int O>
struct WarpHalve {
  static __device__ __forceinline__ float run(const float (&v)[M]) {
    constexpr int H = (M + 1) / 2;
    const bool up = threadIdx.x & O;
    float u[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = v[i];
      const float hi = H + i < M ? v[H + i] : 0.0f;
      u[i] = (up ? hi : lo) + __shfl_xor_sync(FULL_MASK, up ? lo : hi, O);
    }
    return WarpHalve<H, O / 2>::run(u);
  }
};
template <int M>
struct WarpHalve<M, 0> {
  static __device__ __forceinline__ float run(const float (&v)[M]) { return v[0]; }
};

// Which of the M values WarpHalve<M, 16> leaves in this lane, or -1: the
// split at each level follows the array sizes, and a lane whose kept half
// holds only padding keeps no value.
template <int M>
__device__ __forceinline__ int bwd_field(int lane) {
  int off = 0, real = M, size = M;
  for (int o = 16; o > 0; o >>= 1) {
    const int h = (size + 1) / 2;
    if (lane & o) {
      off += h;
      real -= h;
    } else {
      real = min(real, h);
    }
    size = h;
  }
  return real >= 1 ? off : -1;
}

// Field f of a live slot's gradient row r from its pixel sums m(0 .. G-1):
// [dx dy | dca dcb dcc | dop | dcolor (C) | 0].
template <int C, class Sums>
__device__ __forceinline__ float grad_field(int f, const float* r, Sums m) {
  switch (f) {
    case 0: return -(r[2] * m(1) + r[3] * m(2));   // dx
    case 1: return -(r[4] * m(2) + r[3] * m(1));   // dy
    case 2: return -0.5f * m(3);                   // dca
    case 3: return -m(4);                          // dcb
    case 4: return -0.5f * m(5);                   // dcc
    case 5: return m(0) / fmaxf(r[5], 1e-20f);     // dop = sum da raw / op
    default: return f < 6 + C ? m(f) : 0.0f;       // dcolor; depth 0
  }
}

template <int C, int MAXT, bool ANY>
__global__ void __launch_bounds__(MAXT)
composite_bwd_kernel(const int* __restrict__ order, const float* __restrict__ packed,
                     const int* __restrict__ counts, const float* __restrict__ gacc,
                     const float* __restrict__ gft, const float* __restrict__ final_t,
                     const float* __restrict__ ckpt, float* __restrict__ dpacked,
                     float* __restrict__ t_end, float* __restrict__ chunk_sums, int K, int tiles_x,
                     int tile_x, int tile_y) {
  constexpr int F = 7 + C;
  constexpr int FP = (F + 3) / 4 * 4;  // a row's stride in shared memory, float4-aligned
  constexpr int G = 6 + C;             // S0 Sx Sy Sxx Sxy Syy | sum w g_c
  static_assert(BWD_PPT == 2, "the state layout below packs two pixels a float4");
  static_assert(CKPT % BWD_SUB == 0, "a window is kept in whole parts");
  extern __shared__ float4 smem4[];
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int P = ANY ? tile_x * tile_y : nthreads * BWD_PPT;
  float4* state = smem4;                                           // [BWD_SUB][nthreads]: T, a a pixel
  float* rows = reinterpret_cast<float*>(state + BWD_SUB * nthreads);  // [CKPT][FP]
  float* part = rows + CKPT * FP;                                  // [BWD_SUB][nwarps][G]

  const TileChunk tc = tile_chunk<ANY>(order, P);
  const int t = tc.t;
  const int cnt = counts[t];
  // chunks of the tile; with more than one the rows are formed by chunk_sum_kernel
  const int nch = ANY ? tile_chunks(P) : 1;
  // this thread's place in the whole tile
  const int gi = tc.chunk * (MAX_BLOCK_P / BWD_PPT) + i;
  float* out_tile = dpacked + (size_t)t * K * F;
  if (nch == 1)
    for (int e = cnt * F + i; e < K * F; e += nthreads) out_tile[e] = 0.0f;
  if (cnt == 0) return;  // the whole block: counts[t] is uniform

  const int nck = (K + CKPT - 1) / CKPT;
  const float* tile_rows = packed + (size_t)t * K * F;
  bool in_tile[BWD_PPT];  // the pixel lies in the tile
  float px[BWD_PPT], py[BWD_PPT], g[BWD_PPT][C], g_t_term[BWD_PPT], suffix[BWD_PPT];
#pragma unroll
  for (int q = 0; q < BWD_PPT; ++q) {
    const int p = gi * BWD_PPT + q;
    in_tile[q] = !ANY || p < P;
    px[q] = (float)((t % tiles_x) * tile_x + p % tile_x);
    py[q] = (float)((t / tiles_x) * tile_y + p / tile_x);
#pragma unroll
    for (int c = 0; c < C; ++c) g[q][c] = in_tile[q] ? gacc[((size_t)t * C + c) * P + p] : 0.0f;
    g_t_term[q] = in_tile[q] ? gft[(size_t)t * P + p] * final_t[(size_t)t * P + p] : 0.0f;
    suffix[q] = 0.0f;  // sum over later slots k of (color_k . g) * w_k
  }
  const int field = bwd_field<G>(lane);
  // the warp's pixels (up to 64 consecutive ones, from p0) lie in this box
  const int p0 = (gi >> 5) * 32 * BWD_PPT;
  const int p1 = ANY ? min(p0 + 32 * BWD_PPT, P) - 1 : p0 + 32 * BWD_PPT - 1;
  const bool warp_live = !ANY || p0 < P;  // the warp holds a pixel of the tile
  const bool one_row = p0 / tile_x == p1 / tile_x;
  const float box_x0 = (float)((t % tiles_x) * tile_x + (one_row ? p0 % tile_x : 0));
  const float box_x1 = (float)((t % tiles_x) * tile_x + (one_row ? p1 % tile_x : tile_x - 1));
  const float box_y0 = (float)((t / tiles_x) * tile_y + p0 / tile_x);
  const float box_y1 = (float)((t / tiles_x) * tile_y + p1 / tile_x);

  for (int win = (cnt - 1) / CKPT; win >= 0; --win) {
    const int w0 = win * CKPT;
    const int nw = min(CKPT, cnt - w0);
    __syncthreads();  // the previous window's rows are consumed
    for (int e = i; e < nw * F; e += nthreads) {
      const int j = e / F;
      rows[j * FP + (e - j * F)] = tile_rows[(size_t)w0 * F + e];
    }
    __syncthreads();
    // bit j: slot w0 + j may draw on one of this warp's pixels (lane j tests it)
    const unsigned draws = __ballot_sync(
        FULL_MASK,
        warp_live && lane < nw && may_draw(rows + lane * FP, box_x0, box_x1, box_y0, box_y1));

    // T at each part's start: the forward's checkpoint, then a sweep over the
    // window's slots before the last part that keeps nothing else
    constexpr int NPART = CKPT / BWD_SUB;
    float Tp[NPART][BWD_PPT];
#pragma unroll
    for (int q = 0; q < BWD_PPT; ++q)
      Tp[0][q] = in_tile[q] ? ckpt[((size_t)t * nck + win) * P + gi * BWD_PPT + q] : 0.0f;
#pragma unroll
    for (int pp = 1; pp < NPART; ++pp) {
#pragma unroll
      for (int q = 0; q < BWD_PPT; ++q) Tp[pp][q] = Tp[pp - 1][q];
      if (pp * BWD_SUB >= nw) continue;
      for (int j = (pp - 1) * BWD_SUB; j < pp * BWD_SUB; ++j) {
        if (!(draws >> j & 1u)) continue;  // warp-uniform
        float r[8];  // x y ca cb cc op
        load_row(rows + j * FP, r);
#pragma unroll
        for (int q = 0; q < BWD_PPT; ++q) {
          bool ok;
          const float a = splat_alpha(r, px[q], py[q], ok);
          if (ok) Tp[pp][q] = transmit(Tp[pp][q], a);
        }
      }
    }

    for (int sub = (nw - 1) / BWD_SUB; sub >= 0; --sub) {
      const int s0 = sub * BWD_SUB;
      const int ns = min(BWD_SUB, nw - s0);
      // front to back: T before each slot and its alpha (0 where the slot is
      // skipped, or the pixel lies past the tile), as the forward took them
      float T[BWD_PPT];
#pragma unroll
      for (int pp = 0; pp < NPART; ++pp) {
        if (pp == sub) {
#pragma unroll
          for (int q = 0; q < BWD_PPT; ++q) T[q] = Tp[pp][q];
        }
      }
      for (int j = 0; j < ns; ++j) {
        if (!(draws >> (s0 + j) & 1u)) {  // warp-uniform: no pixel of the warp draws
          state[j * nthreads + i] = make_float4(T[0], 0.0f, T[1], 0.0f);
          continue;
        }
        float r[8];
        load_row(rows + (s0 + j) * FP, r);
        float st[2 * BWD_PPT];
#pragma unroll
        for (int q = 0; q < BWD_PPT; ++q) {
          bool ok;
          const float a = splat_alpha(r, px[q], py[q], ok);
          st[2 * q] = T[q];
          st[2 * q + 1] = ok && in_tile[q] ? a : 0.0f;
          if (ok) T[q] = transmit(T[q], a);
        }
        state[j * nthreads + i] = make_float4(st[0], st[1], st[2], st[3]);
      }
      if (t_end != nullptr && s0 + ns == nw) {  // the window's last part: T after its last slot
#pragma unroll
        for (int q = 0; q < BWD_PPT; ++q)
          if (in_tile[q]) t_end[((size_t)t * nck + win) * P + gi * BWD_PPT + q] = T[q];
      }
      __syncthreads();  // the previous part's partials are consumed

      // back to front: each slot's pixel sums, reduced per warp
      for (int j = ns - 1; j >= 0; --j) {
        const float4 st = state[j * nthreads + i];
        float r[FP];
        load_row(rows + (s0 + j) * FP, r);
        const float tb[BWD_PPT] = {st.x, st.z};
        const float al[BWD_PPT] = {st.y, st.w};
        float* slot_part = part + (j * nwarps + (i >> 5)) * G;
        if (!__any_sync(FULL_MASK, al[0] > 0.0f || al[1] > 0.0f)) {
          if (field >= 0) slot_part[field] = 0.0f;
          continue;
        }
        float s[G];
#pragma unroll
        for (int f = 0; f < G; ++f) s[f] = 0.0f;
        // a = 0 (skipped) adds zeros and leaves the suffix as it is
#pragma unroll
        for (int q = 0; q < BWD_PPT; ++q) {
          if (!in_tile[q]) continue;  // adds nothing: the lane's sums stay +0
          const float a = al[q];
          const float tba = tb[q] >= T_MIN ? tb[q] : 0.0f;  // T before, masked once below 1e-4
          float gdotcol = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) gdotcol += r[6 + c] * g[q][c];
          const float w = a * tba;
          // 1 - a >= .01 wherever dp takes da: the reference's floor at .01
          // only bites at the clamp
          const float da = gdotcol * tba - __fdividef(suffix[q] + g_t_term[q], 1.0f - a);
          // dpower; none through the clamp at .99 (there raw >= .99), and a == raw below it
          const float dp = a < ALPHA_MAX ? da * a : 0.0f;
          const float dx = r[0] - px[q];
          const float dy = r[1] - py[q];
          const float dpx = dp * dx;
          const float dpy = dp * dy;
          s[0] += dp;
          s[1] += dpx;
          s[2] += dpy;
          s[3] += dpx * dx;
          s[4] += dpx * dy;
          s[5] += dpy * dy;
#pragma unroll
          for (int c = 0; c < C; ++c) s[6 + c] += w * g[q][c];
          suffix[q] += gdotcol * w;
        }
        const float sum = WarpHalve<G, 16>::run(s);
        if (field >= 0) slot_part[field] = sum;
      }
      __syncthreads();

      if (nch == 1) {
        // the part's gradient rows from the warps' partials, in warp order
        for (int e = i; e < ns * F; e += nthreads) {
          const int j = e / F;
          const float* pj = part + j * nwarps * G;
          auto m = [&](int k) {
            float acc = 0.0f;
            for (int wp = 0; wp < nwarps; ++wp) acc += pj[wp * G + k];
            return acc;
          };
          out_tile[(size_t)(w0 + s0 + j) * F + (e - j * F)] =
              grad_field<C>(e - j * F, rows + (s0 + j) * FP, m);
        }
      } else {
        // the chunk's sums of the part's slots, its warps' partials in warp order
        float* cs = chunk_sums + (((size_t)t * nch + tc.chunk) * K + w0 + s0) * G;
        for (int e = i; e < ns * G; e += nthreads) {
          const int j = e / G;
          const float* pj = part + j * nwarps * G + (e - j * G);
          float acc = 0.0f;
          for (int wp = 0; wp < nwarps; ++wp) acc += pj[wp * G];
          cs[e] = acc;
        }
      }
    }
  }
}

// The gradient rows of tiles that ran as nch > 1 chunks: each live slot's
// pixel sums are its chunks' sums (chunk_sums (T, nch, K, G)) added in chunk
// order; dead slots and the depth column read 0. A thread an element of a
// tile's (K, F) rows, blocks over (tile, CHUNK_SUM_THREADS elements).
constexpr int CHUNK_SUM_THREADS = 256;

template <int C>
__global__ void __launch_bounds__(CHUNK_SUM_THREADS)
chunk_sum_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                 const float* __restrict__ chunk_sums, float* __restrict__ dpacked, int K, int nch) {
  constexpr int F = 7 + C;
  constexpr int G = 6 + C;
  const int t = blockIdx.x;
  const int e = blockIdx.y * CHUNK_SUM_THREADS + threadIdx.x;
  if (e >= K * F) return;
  const int j = e / F, f = e - j * F;
  float v = 0.0f;
  if (j < counts[t]) {
    const float* cs = chunk_sums + ((size_t)t * nch * K + j) * G;
    auto m = [&](int k) {
      float acc = 0.0f;
      for (int c = 0; c < nch; ++c) acc += cs[(size_t)c * K * G + k];
      return acc;
    };
    v = grad_field<C>(f, packed + ((size_t)t * K + j) * F, m);
  }
  dpacked[(size_t)t * K * F + e] = v;
}

// ---------------------------------------------------------------------------
// Gradient combine: out[gid[t, s]] += g[t, s] over each tile's live prefix.
// Replaces the Pallas kernel fluidnexus_tpu/ops/rasterizer_pallas.py:
// _combine_kernel/combine_rows_rmw, the adjoint of the per-tile row gather
// (the reference CUDA backward's atomicAdd).
//
// Bound on the H100: by bytes (F floats read and added per live slot, no
// arithmetic to speak of). One block per tile walks only the tile's live
// prefix, which is one contiguous run of cnt * F floats of g: neighbouring
// threads take neighbouring V-float pieces of it (V = 4, 2 or 1, the widest
// that divides F) and add each with one vector atomic, so a row's adds land
// in one or two sectors. The (N, F) accumulator of a few MB stays in L2.
// ---------------------------------------------------------------------------
constexpr int COMBINE_THREADS = 128;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
};
template <>
struct Vec<2> {
  using type = float2;
};
template <>
struct Vec<1> {
  using type = float;
};

template <int V>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ g, const long long* __restrict__ gid,
               const int* __restrict__ counts, float* __restrict__ out, int K, int F) {
  using VT = typename Vec<V>::type;
  const int t = blockIdx.x;
  const int per_row = F / V;
  const int n = counts[t] * per_row;
  const VT* src = reinterpret_cast<const VT*>(g + (size_t)t * K * F);
  const long long* ids = gid + (size_t)t * K;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += COMBINE_THREADS) {
    const int s = e / per_row;
    atomicAdd(reinterpret_cast<VT*>(out + ids[s] * F) + (e - s * per_row), src[e]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The tiles of the main path, which take the instantiations with ANY =
// false: the forward's a multiple of 32 pixels, the backward's of 32 *
// BWD_PPT, at most MAX_BLOCK_P. Every other tile takes ANY = true.
bool fwd_any(int P) { return P % 32 != 0 || P > MAX_BLOCK_P; }
bool bwd_any(int P) { return P % (32 * BWD_PPT) != 0 || P > MAX_BLOCK_P; }

// Threads of a block of either kernel: a thread per ppt pixels of a block's
// chunk (the whole tile up to MAX_BLOCK_P), in whole warps.
int block_threads(int P, int ppt) {
  const int bp = P < MAX_BLOCK_P ? P : MAX_BLOCK_P;
  return ((bp + ppt - 1) / ppt + 31) / 32 * 32;
}

template <int C>
const void* fwd_kernel_c(int P) {
  return fwd_any(P) ? (const void*)composite_fwd_kernel<C, true>
                    : (const void*)composite_fwd_kernel<C, false>;
}

// The forward's instantiation for C channels and tiles of P pixels.
const void* fwd_kernel(int C, int P) {
  return C == 1 ? fwd_kernel_c<1>(P) : (C == 3 ? fwd_kernel_c<3>(P) : nullptr);
}

// Tiles of up to 2 * BWD_SMALL pixels take an instantiation bounded at
// BWD_SMALL threads.
template <int C>
const void* bwd_kernel_c(int P) {
  constexpr int BIG = MAX_BLOCK_P / BWD_PPT;
  const bool small = block_threads(P, BWD_PPT) <= BWD_SMALL;
  if (bwd_any(P))
    return small ? (const void*)composite_bwd_kernel<C, BWD_SMALL, true>
                 : (const void*)composite_bwd_kernel<C, BIG, true>;
  return small ? (const void*)composite_bwd_kernel<C, BWD_SMALL, false>
               : (const void*)composite_bwd_kernel<C, BIG, false>;
}

// The backward's instantiation for C channels and tiles of P pixels.
const void* bwd_kernel(int C, int P) {
  return C == 1 ? bwd_kernel_c<1>(P) : (C == 3 ? bwd_kernel_c<3>(P) : nullptr);
}

size_t fwd_smem(int C) { return (size_t)FWD_BATCH * ((7 + C + 3) / 4 * 4) * sizeof(float); }

size_t bwd_smem(int C, int nthreads) {
  return BWD_SUB * nthreads * sizeof(float4)
         + (size_t)(CKPT * ((7 + C + 3) / 4 * 4) + BWD_SUB * (nthreads / 32) * (6 + C)) * sizeof(float);
}

// Blocks of a launch over T tiles of P pixels: one a chunk; 0 where that
// does not fit a grid.
unsigned grid_blocks(int T, int P) {
  const long long n = (long long)T * tile_chunks(P);
  return n <= 0x7fffffffLL ? (unsigned)n : 0u;
}

// The widest vector of floats that divides a row and that g is aligned to.
int combine_width(const float* g, int F) {
  const unsigned long long addr = (unsigned long long)g;
  if (F % 4 == 0 && addr % 16 == 0) return 4;
  if (F % 2 == 0 && addr % 8 == 0) return 2;
  return 1;
}

}  // namespace

extern "C" {

int fnx_ckpt_interval() { return CKPT; }

// The kernels' limits: the most pixels one block of the forward or the
// backward takes (a larger tile runs as chunks of it), and the pixels a
// thread owns.
void fnx_raster_limits(int* out) {
  out[0] = MAX_BLOCK_P;
  out[1] = BWD_PPT;
}

// order: a workspace of T ints (the tile order). box_skip 0 walks every live
// slot at every pixel: the check that the skip changes no bit.
int fnx_composite_fwd(int* order, const float* packed, const int* counts, float* accum,
                      float* final_t, float* median, float* ckpt, int T, int K, int C, int tiles_x,
                      int tile_x, int tile_y, int box_skip, void* stream) {
  if (tile_x <= 0 || tile_y <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int P = tile_x * tile_y;
  const void* fn = fwd_kernel(C, P);
  const unsigned blocks = grid_blocks(T, P);
  if (fn == nullptr || blocks == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(C);
  cudaStream_t st = (cudaStream_t)stream;
  tile_order_kernel<<<1, ORDER_THREADS, 0, st>>>(counts, order, T, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(fn, smem)) != cudaSuccess) return (int)err;
  const int* ord = order;
  void* args[] = {&ord, &packed, &counts, &accum, &final_t, &median, &ckpt,
                  &K, &tiles_x, &tile_x, &tile_y, &box_skip};
  if ((err = cudaLaunchKernel(fn, blocks, block_threads(P, FWD_PPT), args, smem, st)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

// order: a workspace of T ints (the tile order); chunk_sums: one of (T,
// chunks, K, 6 + C) floats where a tile runs as more than one chunk (P >
// MAX_BLOCK_P), else unread and may be null. t_end may be null; where given,
// the re-sweep's T at each window's end.
int fnx_composite_bwd(int* order, const float* packed, const int* counts, const float* gacc,
                      const float* gft, const float* final_t, const float* ckpt, float* dpacked,
                      float* t_end, float* chunk_sums, int T, int K, int C, int tiles_x,
                      int tile_x, int tile_y, void* stream) {
  if (tile_x <= 0 || tile_y <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int P = tile_x * tile_y;
  const int nch = tile_chunks(P);
  const int nthreads = block_threads(P, BWD_PPT);
  const void* fn = bwd_kernel(C, P);
  const unsigned blocks = grid_blocks(T, P);
  if (fn == nullptr || blocks == 0 || (nch > 1 && chunk_sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(C, nthreads);
  cudaStream_t st = (cudaStream_t)stream;
  tile_order_kernel<<<1, ORDER_THREADS, 0, st>>>(counts, order, T, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(fn, smem)) != cudaSuccess) return (int)err;
  const int* ord = order;
  void* args[] = {&ord, &packed, &counts, &gacc, &gft, &final_t, &ckpt, &dpacked, &t_end,
                  &chunk_sums, &K, &tiles_x, &tile_x, &tile_y};
  if ((err = cudaLaunchKernel(fn, blocks, nthreads, args, smem, st)) != cudaSuccess) return (int)err;
  if (nch > 1 && K > 0) {
    const dim3 grid(T, (K * (7 + C) + CHUNK_SUM_THREADS - 1) / CHUNK_SUM_THREADS);
    if (C == 1)
      chunk_sum_kernel<1><<<grid, CHUNK_SUM_THREADS, 0, st>>>(packed, counts, chunk_sums, dpacked, K, nch);
    else
      chunk_sum_kernel<3><<<grid, CHUNK_SUM_THREADS, 0, st>>>(packed, counts, chunk_sums, dpacked, K, nch);
  }
  return (int)cudaGetLastError();
}

int fnx_combine_rows(const float* g, const long long* gid, const int* counts, float* out, int T,
                     int K, int F, void* stream) {
  if (T == 0 || K == 0 || F == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (combine_width(g, F)) {
    case 4: combine_kernel<4><<<T, COMBINE_THREADS, 0, st>>>(g, gid, counts, out, K, F); break;
    case 2: combine_kernel<2><<<T, COMBINE_THREADS, 0, st>>>(g, gid, counts, out, K, F); break;
    default: combine_kernel<1><<<T, COMBINE_THREADS, 0, st>>>(g, gid, counts, out, K, F);
  }
  return (int)cudaGetLastError();
}

// Registers a thread, dynamic shared memory a block, threads a block and
// resident blocks an SM of kernel `which` (0 forward, 1 backward, 2 the
// combine at F = 7 + C, vectors as wide as an aligned g allows), in the
// instantiation a launch over tiles of P pixels takes, at C channels.
int fnx_raster_occupancy(int which, int C, int P, int* out) {
  cudaFuncAttributes attr;
  const void* fn;
  int threads;
  size_t smem = 0;
  if ((which == 0 || which == 1) && P <= 0) return (int)cudaErrorInvalidValue;
  if (which == 0) {
    fn = fwd_kernel(C, P);
    threads = block_threads(P, FWD_PPT);
    smem = fwd_smem(C);
  } else if (which == 1) {
    fn = bwd_kernel(C, P);
    threads = block_threads(P, BWD_PPT);
    smem = bwd_smem(C, threads);
  } else {
    const int F = 7 + C;
    fn = F % 4 == 0 ? (const void*)combine_kernel<4>
                    : (F % 2 == 0 ? (const void*)combine_kernel<2> : (const void*)combine_kernel<1>);
    threads = COMBINE_THREADS;
  }
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem)) != cudaSuccess)
    return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)smem;
  out[2] = threads;
  out[3] = blocks;
  return 0;
}

}  // extern "C"
