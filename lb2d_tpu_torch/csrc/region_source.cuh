// Where the row sweeps of K2, K4 and K9 read a block's cells from: the
// whole periodic grid (GridSource: K2 in temporal_step.cu, K4 in
// multifield_step.cu), or one shard of a domain-decomposed grid with its
// neighbours' halos (HaloSource: K9, which replaces
// lb2d_tpu/ops/fused_halo.py:make_temporal_halo_step, in halo_step.cu and
// multifield_step.cu). Both sweeps take the source as a template
// parameter, so K9's flow, velocity inlet, diffusion and noisy Fisher
// physics run K2's sweep (temporal_sweep.cuh) and its multifield physics
// K4's. Every cell goes through the same per-cell updates as K2 and K4, so
// K9 agrees with them bit for bit.
//
// A block reads domain cells (y, x), unwrapped: a sweep up to K cells
// outside the written domain on each side. Each cell's BCs and noise use its global coordinates,
// wrap(y0 + y, ny) and wrap(x0 + x, nx) (Domain).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxDevices = 64;  // cards a process may launch on

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

// The written domain: rows x cols cells (row-major, `rows * cols` per
// plane), whose cell (0, 0) is global cell (y0, x0) of an ny x nx grid.
struct Domain {
  int rows, cols, y0, x0, ny, nx;
};

// The whole periodic domain f[P][rows][cols]: a region cell wraps into it.
struct GridSource {
  const float* f;
  int rows, cols;

  // plane 0 of cell (y, x), and the distance between two planes
  __device__ __forceinline__ const float* at(int y, int x,
                                             size_t& plane) const {
    plane = (size_t)rows * cols;
    return f + (size_t)wrap(y, rows) * cols + wrap(x, cols);
  }
};

// One shard f[P][H][W] with the hk rows above and below it, top and bot
// [P][hk][W], and, unless x wraps within the shard (left == right == null),
// the hk columns beside its y-extended rows, left and right [P][H + 2hk][hk]
// (corners included). The obstacle mask covers the region
// [H + 2hk][W + 2hk]. A region cell past the halo reads its outermost row
// or column: it feeds only cells no block stores, since a stored cell after
// K <= hk steps depends on cells within K of it.
struct HaloSource {
  const float *f, *top, *bot, *left, *right;
  int H, W, hk;

  // column x in the region: wrapped into the shard when x wraps there
  __device__ __forceinline__ int place_x(int x) const {
    return left ? (x < W + hk ? x : W + hk - 1) : wrap(x, W);
  }
  __device__ __forceinline__ const float* at(int y, int x,
                                             size_t& plane) const {
    return at_placed(y, place_x(x), plane);
  }
  // the same for a column placed once (place_x), as a sweep reads it row
  // after row
  __device__ __forceinline__ const float* at_placed(int y, int x,
                                                    size_t& plane) const {
    y = y < H + hk ? y : H + hk - 1;
    if (x < 0 || x >= W) {
      plane = (size_t)(H + 2 * hk) * hk;
      return (x < 0 ? left + (x + hk) : right + (x - W)) + (size_t)(y + hk) * hk;
    }
    if (y < 0 || y >= H) {
      plane = (size_t)hk * W;
      return (y < 0 ? top + (size_t)(y + hk) * W : bot + (size_t)(y - H) * W) + x;
    }
    plane = (size_t)H * W;
    return f + (size_t)y * W + x;
  }
  __device__ __forceinline__ bool solid_placed(const int* mask, int y,
                                               int x) const {
    y = y < H + hk ? y : H + hk - 1;
    return __ldg(mask + (size_t)(y + hk) * (W + 2 * hk) + (x + hk)) != 0;
  }
};

}  // namespace
