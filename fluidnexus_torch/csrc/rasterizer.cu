// Tile-rasterizer kernels for Hopper (sm_90a): composite forward, composite
// backward and the gradient combine. Plain C interface, loaded with ctypes by
// fluidnexus_torch/ops/rasterizer_cuda.py, which also holds each kernel's plain
// PyTorch version.
//
// Layout shared by the three kernels:
//   packed (T, K, F) f32, F = 7 + C, rows [x y | ca cb cc | opacity | color(C) | depth],
//     tile t's slots front to back by depth; slot s is live iff s < counts[t].
//   P = tile_x * tile_y pixels per tile, row-major over (tile_y, tile_x);
//     one block per tile (the forward and the backward a thread per two
//     adjacent pixels, the combine 128 threads).
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
// their tiles from g_tile_order, heaviest first, so the 512-slot tiles do
// not trail the grid. The order lives in one buffer of the library, so
// launches on two streams at once would race on it; the port launches on
// one stream.
// ---------------------------------------------------------------------------
constexpr int MAX_TILES = 1 << 16;    // tiles the order buffer holds (4096 x 4096 at 16 x 16)
constexpr int ORDER_THREADS = 1024;   // tile_order_kernel's block, one count bucket a thread

__device__ int g_tile_order[MAX_TILES];

// Tiles by descending live count (counts quantised to ORDER_THREADS
// buckets; within a bucket in no fixed order). One block: a histogram, an
// exclusive scan from the heaviest bucket, a scatter.
__global__ void tile_order_kernel(const int* __restrict__ counts, int T, int K) {
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
    g_tile_order[atomicAdd(&start[bucket], 1)] = t;
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
// splats and cannot be divided back. A tile of a multiple of 32 pixels that
// is not one of 64 leaves the last warp's spare lanes without pixels.
// ---------------------------------------------------------------------------
constexpr int FWD_PPT = 2;       // adjacent pixels a thread owns in the forward
constexpr int FWD_BATCH = 128;   // live rows staged in shared memory at once
constexpr int MAX_FWD_P = 1024;  // most pixels a tile may have

template <int C>
__global__ void __launch_bounds__(MAX_FWD_P / FWD_PPT)
composite_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                     float* __restrict__ accum, float* __restrict__ final_t,
                     float* __restrict__ median, float* __restrict__ ckpt, int K, int tiles_x,
                     int tile_x, int tile_y, int box_skip) {
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
  const int warp = i >> 5;
  const int t = g_tile_order[blockIdx.x], cnt = counts[t];
  const int nck = (K + CKPT - 1) / CKPT;
  const float* tile_rows = packed + (size_t)t * K * F;
  const int tx0 = (t % tiles_x) * tile_x, ty0 = (t / tiles_x) * tile_y;
  // this thread's first pixel, and the box [bx0, bx1] x [by0, by1] that holds
  // the warp's pixels (tile coordinates)
  int p0, bx0, bx1, by0, by1;
  if (tile_x % 8 == 0 && tile_y % 8 == 0) {  // an 8 x 8 block a warp
    bx0 = warp % (tile_x / 8) * 8;
    by0 = warp / (tile_x / 8) * 8;
    bx1 = bx0 + 7;
    by1 = by0 + 7;
    p0 = (by0 + lane / 4) * tile_x + bx0 + FWD_PPT * (lane % 4);
  } else {  // up to 64 consecutive pixels a warp
    const int w0 = warp * 32 * FWD_PPT, w1 = min(w0 + 32 * FWD_PPT, P) - 1;
    const bool one_row = w0 / tile_x == w1 / tile_x;
    bx0 = one_row ? w0 % tile_x : 0;
    bx1 = one_row ? w1 % tile_x : tile_x - 1;
    by0 = w0 / tile_x;
    by1 = w1 / tile_x;
    p0 = i * FWD_PPT;
  }
  const bool mine = p0 < P;  // a spare lane holds no pixel
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
        *reinterpret_cast<float2*>(ckpt + ((size_t)t * nck + (b0 + g0) / CKPT) * P + p0) =
            make_float2(T[0], T[1]);
      // bit j: slot g0 + j may draw on one of the warp's pixels (lane j tests it)
      unsigned draws = __ballot_sync(
          FULL_MASK, lane < ng && (!box_skip || may_draw(rows + (g0 + lane) * FP, box_x0,
                                                         box_x1, box_y0, box_y1)));
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
    *reinterpret_cast<float2*>(accum + ((size_t)t * C + c) * P + p0) = make_float2(acc[0][c], acc[1][c]);
  *reinterpret_cast<float2*>(final_t + (size_t)t * P + p0) = make_float2(T[0], T[1]);
  *reinterpret_cast<float2*>(median + (size_t)t * P + p0) = make_float2(depth[0], depth[1]);
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
// ---------------------------------------------------------------------------
constexpr int BWD_PPT = 2;            // adjacent pixels a thread owns in the backward
constexpr int BWD_SUB = 16;           // slots of a window whose T and alpha it keeps at once
constexpr int MAX_BWD_P = 1024;       // its shared state is BWD_SUB * P * 8 bytes (128 KB)
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

template <int C, int MAXT>
__global__ void __launch_bounds__(MAXT)
composite_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                     const float* __restrict__ gacc, const float* __restrict__ gft,
                     const float* __restrict__ final_t, const float* __restrict__ ckpt,
                     float* __restrict__ dpacked, float* __restrict__ t_end, int K, int tiles_x,
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
  const int warp = i >> 5;
  const int P = nthreads * BWD_PPT;
  float4* state = smem4;                                           // [BWD_SUB][nthreads]: T, a a pixel
  float* rows = reinterpret_cast<float*>(state + BWD_SUB * nthreads);  // [CKPT][FP]
  float* part = rows + CKPT * FP;                                  // [BWD_SUB][nwarps][G]

  const int t = g_tile_order[blockIdx.x];
  const int cnt = counts[t];
  float* out_tile = dpacked + (size_t)t * K * F;
  for (int e = cnt * F + i; e < K * F; e += nthreads) out_tile[e] = 0.0f;
  if (cnt == 0) return;  // the whole block: counts[t] is uniform

  const int nck = (K + CKPT - 1) / CKPT;
  const float* tile_rows = packed + (size_t)t * K * F;
  float px[BWD_PPT], py[BWD_PPT], g[BWD_PPT][C], g_t_term[BWD_PPT], suffix[BWD_PPT];
#pragma unroll
  for (int q = 0; q < BWD_PPT; ++q) {
    const int p = i * BWD_PPT + q;
    px[q] = (float)((t % tiles_x) * tile_x + p % tile_x);
    py[q] = (float)((t / tiles_x) * tile_y + p / tile_x);
#pragma unroll
    for (int c = 0; c < C; ++c) g[q][c] = gacc[((size_t)t * C + c) * P + p];
    g_t_term[q] = gft[(size_t)t * P + p] * final_t[(size_t)t * P + p];
    suffix[q] = 0.0f;  // sum over later slots k of (color_k . g) * w_k
  }
  const int field = bwd_field<G>(lane);
  // the warp's pixels (64 consecutive ones) lie in this box
  const int p0 = warp * 32 * BWD_PPT, p1 = p0 + 32 * BWD_PPT - 1;
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
        FULL_MASK, lane < nw && may_draw(rows + lane * FP, box_x0, box_x1, box_y0, box_y1));

    // T at each part's start: the forward's checkpoint, then a sweep over the
    // window's slots before the last part that keeps nothing else
    constexpr int NPART = CKPT / BWD_SUB;
    float Tp[NPART][BWD_PPT];
#pragma unroll
    for (int q = 0; q < BWD_PPT; ++q) Tp[0][q] = ckpt[((size_t)t * nck + win) * P + i * BWD_PPT + q];
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
      // skipped), as the forward took them
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
          st[2 * q + 1] = ok ? a : 0.0f;
          if (ok) T[q] = transmit(T[q], a);
        }
        state[j * nthreads + i] = make_float4(st[0], st[1], st[2], st[3]);
      }
      if (t_end != nullptr && s0 + ns == nw) {  // the window's last part: T after its last slot
#pragma unroll
        for (int q = 0; q < BWD_PPT; ++q) t_end[((size_t)t * nck + win) * P + i * BWD_PPT + q] = T[q];
      }
      __syncthreads();  // the previous part's partials are consumed

      // back to front: each slot's pixel sums, reduced per warp
      for (int j = ns - 1; j >= 0; --j) {
        const float4 st = state[j * nthreads + i];
        float r[FP];
        load_row(rows + (s0 + j) * FP, r);
        const float tb[BWD_PPT] = {st.x, st.z};
        const float al[BWD_PPT] = {st.y, st.w};
        float* slot_part = part + (j * nwarps + warp) * G;
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

      // the part's gradient rows from the warps' partials, in warp order
      for (int e = i; e < ns * F; e += nthreads) {
        const int j = e / F;
        const int f = e - j * F;
        const float* r = rows + (s0 + j) * FP;
        const float* pj = part + j * nwarps * G;
        auto m = [&](int k) {
          float acc = 0.0f;
          for (int wp = 0; wp < nwarps; ++wp) acc += pj[wp * G + k];
          return acc;
        };
        float v;
        switch (f) {
          case 0: v = -(r[2] * m(1) + r[3] * m(2)); break;   // dx
          case 1: v = -(r[4] * m(2) + r[3] * m(1)); break;   // dy
          case 2: v = -0.5f * m(3); break;                   // dca
          case 3: v = -m(4); break;                          // dcb
          case 4: v = -0.5f * m(5); break;                   // dcc
          case 5: v = m(0) / fmaxf(r[5], 1e-20f); break;     // dop = sum da raw / op
          default: v = f < 6 + C ? m(f) : 0.0f;              // dcolor; depth 0
        }
        out_tile[(size_t)(w0 + s0 + j) * F + f] = v;
      }
    }
  }
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

// The backward's instantiation for C channels and a block of nthreads.
const void* bwd_kernel(int C, int nthreads) {
  const bool small = nthreads <= BWD_SMALL;
  switch (C) {
    case 1:
      return small ? (const void*)composite_bwd_kernel<1, BWD_SMALL>
                   : (const void*)composite_bwd_kernel<1, MAX_BWD_P / BWD_PPT>;
    case 3:
      return small ? (const void*)composite_bwd_kernel<3, BWD_SMALL>
                   : (const void*)composite_bwd_kernel<3, MAX_BWD_P / BWD_PPT>;
    default:
      return nullptr;
  }
}

// The tiles each kernel takes: the forward multiples of 32 pixels (its
// spare lanes masked), the backward multiples of 32 * BWD_PPT.
bool bad_tile(int P) { return P <= 0 || P % 32 != 0 || P > MAX_FWD_P; }
bool bad_bwd_tile(int P) { return P <= 0 || P % (32 * BWD_PPT) != 0 || P > MAX_BWD_P; }

int fwd_threads(int P) { return (P / FWD_PPT + 31) / 32 * 32; }

size_t fwd_smem(int C, int P) { return (size_t)FWD_BATCH * ((7 + C + 3) / 4 * 4) * sizeof(float); }

size_t bwd_smem(int C, int P) {
  const int nthreads = P / BWD_PPT;
  return BWD_SUB * nthreads * sizeof(float4)
         + (size_t)(CKPT * ((7 + C + 3) / 4 * 4) + BWD_SUB * (nthreads / 32) * (6 + C)) * sizeof(float);
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

// The kernels' limits: the forward's pixel multiple and most pixels a tile,
// the backward's, and the most tiles a launch may have.
void fnx_raster_limits(int* out) {
  out[0] = 32;
  out[1] = MAX_FWD_P;
  out[2] = 32 * BWD_PPT;
  out[3] = MAX_BWD_P;
  out[4] = MAX_TILES;
}

// box_skip 0 walks every live slot at every pixel: the check that the skip
// changes no bit.
int fnx_composite_fwd(const float* packed, const int* counts, float* accum, float* final_t,
                      float* median, float* ckpt, int T, int K, int C, int tiles_x, int tile_x,
                      int tile_y, int box_skip, void* stream) {
  const int P = tile_x * tile_y;
  if (bad_tile(P) || T > MAX_TILES) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int nthreads = fwd_threads(P);
  const size_t smem = fwd_smem(C, P);
  cudaStream_t st = (cudaStream_t)stream;
  tile_order_kernel<<<1, ORDER_THREADS, 0, st>>>(counts, T, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (C) {
    case 1:
      if ((err = allow_smem(composite_fwd_kernel<1>, smem)) != cudaSuccess) return (int)err;
      composite_fwd_kernel<1><<<T, nthreads, smem, st>>>(packed, counts, accum, final_t, median,
                                                         ckpt, K, tiles_x, tile_x, tile_y, box_skip);
      break;
    case 3:
      if ((err = allow_smem(composite_fwd_kernel<3>, smem)) != cudaSuccess) return (int)err;
      composite_fwd_kernel<3><<<T, nthreads, smem, st>>>(packed, counts, accum, final_t, median,
                                                         ckpt, K, tiles_x, tile_x, tile_y, box_skip);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// t_end may be null; where given, the re-sweep's T at each window's end.
int fnx_composite_bwd(const float* packed, const int* counts, const float* gacc, const float* gft,
                      const float* final_t, const float* ckpt, float* dpacked, float* t_end, int T,
                      int K, int C, int tiles_x, int tile_x, int tile_y, void* stream) {
  const int P = tile_x * tile_y;
  if (bad_bwd_tile(P) || T > MAX_TILES) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int nthreads = P / BWD_PPT;
  const size_t smem = bwd_smem(C, P);
  cudaStream_t st = (cudaStream_t)stream;
  tile_order_kernel<<<1, ORDER_THREADS, 0, st>>>(counts, T, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const void* fn = bwd_kernel(C, nthreads);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if ((err = allow_smem(fn, smem)) != cudaSuccess) return (int)err;
  void* args[] = {&packed, &counts, &gacc, &gft, &final_t, &ckpt, &dpacked, &t_end,
                  &K, &tiles_x, &tile_x, &tile_y};
  if ((err = cudaLaunchKernel(fn, T, nthreads, args, smem, st)) != cudaSuccess) return (int)err;
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
// combine at F = 7 + C, vectors as wide as an aligned g allows) at C
// channels and P pixels a tile.
int fnx_raster_occupancy(int which, int C, int P, int* out) {
  cudaFuncAttributes attr;
  const void* fn;
  int threads;
  size_t smem = 0;
  if (which == 0) {
    if (bad_tile(P)) return (int)cudaErrorInvalidValue;
    fn = C == 1 ? (const void*)composite_fwd_kernel<1> : (const void*)composite_fwd_kernel<3>;
    threads = fwd_threads(P);
    smem = fwd_smem(C, P);
  } else if (which == 1) {
    if (bad_bwd_tile(P)) return (int)cudaErrorInvalidValue;
    threads = P / BWD_PPT;
    fn = bwd_kernel(C, threads);
    smem = bwd_smem(C, P);
  } else {
    const int F = 7 + C;
    fn = F % 4 == 0 ? (const void*)combine_kernel<4>
                    : (F % 2 == 0 ? (const void*)combine_kernel<2> : (const void*)combine_kernel<1>);
    threads = COMBINE_THREADS;
  }
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
