// Lattice arithmetic shared by the pair kernels of pbf.cu and splat.cu. Both
// walk the 27 neighbour cells of a dense cell grid and must decide the
// in-radius test d2 < h^2 exactly as their plain PyTorch versions do, so the
// shift and the squared norm live here once.
#pragma once

#include <cuda_runtime.h>

namespace fnx {

constexpr int MAX_M = 128;   // slots per cell row: at most four warps a block

// The offset of neighbour j along one axis, times h (exactly -h, 0 or h);
// neighbour j sits at cell offset (j/9 - 1, (j/3)%3 - 1, j%3 - 1).
__device__ __forceinline__ float shift(int j, int axis, float h) {
  const int o = axis == 0 ? j / 9 : (axis == 1 ? (j / 3) % 3 : j % 3);
  return (float)(o - 1) * h;
}

// |d|^2 of a pair difference, each step rounded to nearest with no FMA.
__device__ __forceinline__ float norm2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Threads for a row of M slots: whole warps.
inline int threads_for(int M) { return (M + 31) / 32 * 32; }

}  // namespace fnx
