// The row sweep of K2 and K9 (temporal_sweep.cuh), K4 (multifield_step.cu,
// K9's multifield physics too) and K7 (coupled_step.cu, K7h too): its
// shared-memory rings, the cut of a grid or a shard into work items, and the
// asynchronous row loads.
// lb2d_tpu_torch/ops/sweep.py mirrors every formula here (the CPU tests
// emulate the schedule with it).
//
// A work item is a strip of columns (at most strip_width<P>() of them: the
// stored columns and a K-column halo each side, wrapped in x) and a segment
// of rows. Its block sweeps the segment one row per phase. At phase t it
// issues the cp.async loads of input row t + kPrefetch (the segment's first
// row less K, wrapped in y, then onwards), and every level s = 1..K
// computes its row y = ys - K + t - 2 s from level s - 1's rows y + 1, y and
// y - 1, which level s - 1 wrote at phases t - 1, t - 2 and t - 3; level K
// writes f_out. The skew of two rows per level leaves no dependency inside
// a phase, so one barrier per phase orders everything, and each input row
// is read once: only the x halo is computed again.
//
// Rings: direction j is read lag_j = 2 + cy_j phases after it was written
// (the pull from row y - cy_j), so a level keeps lag_j + 1 rows of it, the
// input level kPrefetch more. The directions fall into three groups by lag
// (group 0: 4, 7, 8; group 1: 0, 1, 3; group 2: 2, 5, 6); a group keeps its
// rows slot by slot, three directions per slot, so one pointer per group
// and constant offsets reach all nine pulls. A ring row holds P planes
// (the fields of one direction) of the strip: 27 ring rows per level, 27 +
// 9 kPrefetch at the input level.

#pragma once

#include <cuda_runtime.h>

#include "region_source.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kPrefetch = 1;     // input rows in flight ahead of the completing one
constexpr int kSweepMaxK = 8;    // K = 9-16 fit one block per SM: 1.8-2x slower
constexpr int kSmemPerBlock = 232448;  // the 227 KB a block may have

template <int P>
__host__ __device__ constexpr int strip_width() {
  return P == 1 ? 128 : P <= 3 ? 64 : 32;
}

__host__ __device__ constexpr int dir_group(int j) {
  return j == 4 || j == 7 || j == 8 ? 0 : j == 2 || j == 5 || j == 6 ? 2 : 1;
}

__host__ __device__ constexpr int dir_slot(int j) {
  return j == 1 || j == 5 || j == 7 ? 1 : j == 3 || j == 6 || j == 8 ? 2 : 0;
}

// ring rows a level keeps per direction of group g: the next level reads
// them lag - 1 + g phases after they were written (lag 2 here; the coupled
// sweep's levels lag 4 where a density stage sits between them,
// coupled_step.cu), and the row being written
__host__ __device__ constexpr int sweep_depth(int g, bool first,
                                              int lag = 2) {
  return g + lag + (first ? kPrefetch : 0);
}

__host__ __device__ constexpr int sweep_group_base(int g, bool first,
                                                   int lag = 2) {
  return g == 0 ? 0
         : g == 1 ? 3 * sweep_depth(0, first, lag)
                  : 3 * (sweep_depth(0, first, lag) +
                         sweep_depth(1, first, lag));
}

__host__ __device__ constexpr int sweep_level_rows(bool first, int lag = 2) {
  return sweep_group_base(2, first, lag) + 3 * sweep_depth(2, first, lag);
}

template <int P>
__host__ __device__ constexpr int sweep_ring_floats(int K) {
  return (sweep_level_rows(true) + (K - 1) * sweep_level_rows(false)) * P *
         strip_width<P>();
}

// mask rows that levels 0..K read (the obstacle, K2 only)
__host__ __device__ constexpr int sweep_mask_rows(int K) {
  return 2 * K + kPrefetch + 1;
}

template <int P>
__host__ __device__ constexpr int sweep_smem(int K, bool mask) {
  return sweep_ring_floats<P>(K) * (int)sizeof(float) +
         (mask ? sweep_mask_rows(K) * strip_width<P>() : 0);
}

template <int P>
__host__ __device__ constexpr int sweep_max_k() {
  int k = kSweepMaxK;
  while (k > 1 && sweep_smem<P>(k, P == 1) > kSmemPerBlock) --k;
  return k;
}

// strips x segments work items of a rows x cols domain: strip i stores
// columns [i wo, min((i + 1) wo, cols)), segment j rows [j seg, min((j + 1)
// seg, rows)); as many segments as fill `slots` resident blocks in a wave
struct SweepPlan {
  int strips, wo, segments, seg;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline SweepPlan sweep_plan(int rows, int cols, int K, int wb, int slots) {
  SweepPlan p;
  p.wo = ceil_div(cols, ceil_div(cols, wb - 2 * K));
  p.strips = ceil_div(cols, p.wo);
  int segments = slots / p.strips;
  segments = segments < 1 ? 1 : segments > rows ? rows : segments;
  p.seg = ceil_div(rows, segments);
  p.segments = ceil_div(rows, p.seg);
  return p;
}

// Resident blocks of one kernel instantiation per card and K (the
// occupancy query for blocks of `threads`, cached), after raising its
// shared-memory limit.
struct SweepSlots {
  int sms[kMaxDevices] = {};
  int blocks[kMaxDevices][kSweepMaxK + 1] = {};

  template <class Kernel>
  cudaError_t get(Kernel kernel, int smem, int K, int& slots,
                  int threads = kSweepThreads) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || K < 1 || K > kSweepMaxK)
      return cudaErrorInvalidValue;
    if (!sms[dev]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemPerBlock);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      int n = 0;
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      sms[dev] = n;
    }
    if (!blocks[dev][K]) {
      int b = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel,
                                                          threads, smem);
      if (err != cudaSuccess) return err;
      blocks[dev][K] = b < 1 ? 1 : b;
    }
    slots = sms[dev] * blocks[dev][K];
    return cudaSuccess;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring offsets (in floats) of phase t: the group rows level s reads
// (written at phases t - 1, t - 2, t - 3: rows y + 1, y, y - 1), for s = 1
// from the input ring and for s >= 2 from a ring of level s - 1, the group
// rows a level writes, and the input ring's group rows that the row issued
// at phase t goes to.
template <int P>
struct SweepPhase {
  static constexpr int kRow = P * strip_width<P>();
  int rd_in[3], rd[3], wr[3], ld[3];

  __device__ __forceinline__ explicit SweepPhase(int t) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      // the input row issued at phase t, that of phase t + kPrefetch
      ld[g] = (sweep_group_base(g, true) +
               3 * ((t + kPrefetch) % sweep_depth(g, true))) * kRow;
      // t - 1 - g + depth >= 1: no remainder of a negative number
      rd_in[g] = (sweep_group_base(g, true) +
                  3 * ((t - 1 - g + sweep_depth(g, true)) %
                       sweep_depth(g, true))) * kRow;
      rd[g] = (sweep_group_base(g, false) +
               3 * ((t - 1 - g + sweep_depth(g, false)) %
                    sweep_depth(g, false))) * kRow;
      wr[g] = (sweep_group_base(g, false) + 3 * (t % sweep_depth(g, false))) *
              kRow;
    }
  }
};

// The input ring's offset (in floats, column 0) of plane q = j P + p of the
// row issued this phase, from the phase's group rows ld (SweepPhase).
template <int P>
__device__ __forceinline__ int sweep_load_offset(int q, const int (&ld)[3]) {
  const int j = q / P, g = dir_group(j);
  const int row = g == 0 ? ld[0] : g == 1 ? ld[1] : ld[2];
  return row + (dir_slot(j) * P + q % P) * strip_width<P>();
}

// The pulls of one cell from a level's three group rows (each pointer at
// the cell's column): g0 row y + 1 (directions 4, 7, 8), g1 row y (0, 1,
// 3), g2 row y - 1 (2, 5, 6); field p of 9 values.
template <int P>
struct RingPull {
  static constexpr int W = strip_width<P>(), R = P * W;
  const float *g0, *g1, *g2;

  __device__ __forceinline__ void operator()(int p, float (&s)[9]) const {
    const int o = p * W;
    s[0] = g1[o];
    s[1] = g1[R + o - 1];
    s[2] = g2[o];
    s[3] = g1[2 * R + o + 1];
    s[4] = g0[o];
    s[5] = g2[R + o - 1];
    s[6] = g2[2 * R + o + 1];
    s[7] = g0[R + o + 1];
    s[8] = g0[2 * R + o - 1];
  }
};

// Direction j of field p into a level's ring (group rows at the cell's
// column) or into f_out (plane j F + p of `plane` floats).
template <int P>
struct RingPut {
  static constexpr int W = strip_width<P>(), R = P * W;
  float *w0, *w1, *w2;

  __device__ __forceinline__ void operator()(int j, int p, float v) const {
    float* g = dir_group(j) == 0 ? w0 : dir_group(j) == 1 ? w1 : w2;
    g[dir_slot(j) * R + p * W] = v;
  }
};

template <int P>
struct GlobalPut {
  float* out;
  size_t plane;

  __device__ __forceinline__ void operator()(int j, int p, float v) const {
    out[(size_t)(j * P + p) * plane] = v;
  }
};

}  // namespace
