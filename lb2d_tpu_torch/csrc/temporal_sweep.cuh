// K D2Q9 lattice-Boltzmann steps per pass over f, for Hopper (sm_90a): the
// row sweep of K2 (temporal_step.cu) and K9 (halo_step.cu).
//
// Replaces lb2d_tpu/ops/fused.py:make_temporal_pipe_step with each of its
// physics: "flow" (the pressure-driven pipe flow, with or without an
// obstacle), "velocity_inlet" (the velocity inlet with the zero-gradient
// outlet, periodic in y; here also with the velocity outlet and an
// obstacle, as the model's plain step allows), and the fully periodic
// "diffusion" and "noisy_fisher" of the advection-diffusion family. The
// TPU kernel sweeps 16-row chunks in order and keeps K-1 VMEM rings of
// intermediate steps; what is kept is the idea: read f once and write it
// once for K steps, so HBM traffic per step falls from 72 B/cell to 72/K.
//
// Design: the row sweep of row_sweep.cuh, for every physics. A block takes
// a work item, a strip of 128 columns (its stored columns and a K-column
// halo on each side, wrapped in x) and a segment of rows, and sweeps the
// segment one row per phase: the input row of the next phase arrives by
// cp.async while level s = 1..K computes row ys - K + t - 2 s from level
// s - 1's ring of rows in shared memory; level K writes straight to f_out,
// and one barrier per phase orders it all. Each input row is read once,
// only the x halo (2K columns per strip) is computed again, and the y halo
// is K warm-up rows at each end of a segment; the segments fill one wave
// of resident blocks (row_sweep.cuh: sweep_plan). The obstacle mask
// streams through its own ring of byte rows. Each cell uses cell_update, velocity_cell_update or diffusion_cell_update
// (pipe_cell.cuh) with its wrapped global coordinates, so the BCs and the
// mask apply exactly as in K single steps, and the y-periodic families need
// no seam patch (the TPU kernel's chunks do not wrap in y, so lb2d_tpu's
// models recompute the seam rows with plain steps). The zero-gradient
// outlet reads three more values of the cell's own column (3, 6, 7 at rows
// y, y - 1, y + 1), from the group rows its pulls read. The noise of a cell
// at stage s is the Philox normal of (its global index, step0 + s - 1)
// (philox.cuh): a halo cell computed twice draws the same normal in both
// strips, so K2 at any K follows K single plain steps with noise on.
//
// Bound: per cell and step, 72/K B of HBM (f read and written once per
// launch) against the card's 3.35 TB/s, and the update's arithmetic,
// computed 128 / (128 - 2K) times over for the x halo. The flow updates are
// instruction-bound: a thread takes two columns 64 apart of its level, so
// their pulls, arithmetic and stores overlap; collide (pipe_cell.cuh), as
// in every flow kernel, shares the terms of opposite directions and
// multiplies by the equilibrium's exact reciprocals, so 1 / rho and the
// Zou-He columns' divisions are the only IEEE divisions left. A level's two
// cells are 690 SASS instructions with 4 FCHK (962 and 22 with a division
// per constant); the BC branches, one barrier a phase and the ring index
// remain. The
// diffusion family forms its (1 + c.u / cs2) once per launch. Each
// thread's input planes are constants of an unrolled copy per load lane.
// Shared memory per block,
// (27 K + 9) rows of 128 floats (row_sweep.cuh), sets the blocks per SM:
// 4 up to K = 3, 3 up to K = 5, 2 up to K = 8; K <= 8, as K =
// 9-16 (one block per SM) ran 1.8-2x slower per step. On an H100 80GB HBM3
// at 700 W (PERF.md, section 6): 4096^2 flow 0.17 ms per step at K =
// 4 (0.26 with the divisions), 2048^2 diffusion 0.035 at K = 8 and noisy
// Fisher 0.075 at K = 4, against 0.35, 0.086 and 0.122 for the first K2's
// 32 x 32 tiles.
//
// The first K2 ran 32 x 32 tiles with a K-cell halo, three
// blocks per SM and a block-wide barrier per step: at K = 3 it read 1.51x
// the cells it wrote and computed 1.16x the updates it kept, and larger K
// lost more to the halo than it saved in bytes. K2's velocity inlet keeps
// those tiles on small grids (temporal_step.cu says why).
//
// K9 is the same sweep on one shard of a domain-decomposed grid: it
// replaces lb2d_tpu/ops/fused_halo.py:make_temporal_halo_step for the
// physics above. The sweep's body (sweep_steps) takes the region's source
// as a template parameter and runs under two kernels: K2's
// (temporal_step_kernel) reads the periodic grid (GridSource, its row
// index kept wrapped from phase to phase), K9's (halo_sweep_kernel) a
// shard and its halos (region_source.cuh's HaloSource: the shard, the
// K-row halos from its y-neighbours and, on 2-D meshes, the K-column strips
// from its x-neighbours), each thread's column placed once per sweep. One
// kernel for both ran K2 2% slower per step. K9 writes the shard's rows,
// and every cell keeps its global coordinates, so the BCs, the mask and
// the noise are those of K2 on the whole grid, through the same per-cell
// updates. A strip reads at most K cells past the shard, inside its halo.
// Bound as K2's, plus the halo's bytes (2K rows and, on 2-D meshes, 2K
// columns per shard). On an H100 80GB HBM3 at 700 W (PERF.md, section 6):
// a 2048 x 8192 flow shard 0.308 ms per step at K = 4 (1.18x K2's time per
// cell: its 69 strips take 5 segments of 410 rows, 345 of 396 resident
// blocks), 1024^2 diffusion and noisy Fisher shards 0.012 at K = 8 and
// 0.025 at K = 4, against 0.413, 0.025 and 0.043 in 32 x 32 tiles.

#pragma once

#include <type_traits>

#include "pipe_cell.cuh"
#include "region_source.cuh"
#include "row_sweep.cuh"

namespace {

// physics, a template parameter of the kernels
constexpr int kFlow = 0;          // pressure inlet/outlet, walls (a, b = rho)
constexpr int kVelocityOpen = 1;  // velocity inlet, open outlet (a, b = u)
constexpr int kVelocityPair = 2;  // velocity inlet and outlet (a, b = u)
constexpr int kDiffusion = 3;     // periodic, linear feq, growth (a, b = u, v)
constexpr int kNoisyFisher = 4;   // kDiffusion + Philox noise and clip

// A thread computes kCols columns, kSpan apart, of every kLanes-th level:
// two independent cells that share their rows, so one thread overlaps them.
constexpr int kCols = 2;
constexpr int kMinBlocks = 3;  // __launch_bounds__: 85 registers a thread

// K2 and K9: K steps of the domain d, whose region comes from src
// (region_source.cuh), into f_out[9][d.rows][d.cols], one work item (strip
// blockIdx.x, segment blockIdx.y of `plan`) per block. K2's source is the
// whole periodic grid (GridSource, d the grid itself): it reads row `row`
// of f_in at its wrapped column, the row kept wrapped from phase to phase.
// K9's is one shard and its halos (HaloSource): a thread places its column
// in the region once and reads row y of it through src.at_placed, and a
// strip reads no further than K cells past the shard, inside the halo.
// Every cell's BCs, mask and noise use its global coordinates wrap(d.y0 +
// y, d.ny), wrap(d.x0 + x, d.nx).
template <int kPhys, bool kIncomp, bool kObstacle, class Src>
__device__ __forceinline__ void sweep_steps(const Src& src,
                                            const int* __restrict__ mask,
                                            float* __restrict__ f_out,
                                            const Domain& d, int K,
                                            const SweepPlan& plan,
                                            const StepParams& prm) {
  constexpr bool kGrid = std::is_same<Src, GridSource>::value;
  constexpr bool kVelocity = kPhys == kVelocityOpen || kPhys == kVelocityPair;
  constexpr int W = strip_width<1>();
  constexpr int kSpan = W / kCols;
  constexpr int kLanes = kSweepThreads / kSpan;  // levels side by side
  constexpr int kLoadLanes = kSweepThreads / W;  // threads per input column
  constexpr int kLoads = (9 + kLoadLanes - 1) / kLoadLanes;
  constexpr int kLevel = sweep_level_rows(false) * W;
  extern __shared__ float smem[];
  float* const ring_in = smem;
  float* const rings = smem + sweep_level_rows(true) * W;  // levels 1..K-1
  unsigned char* const solid =
      reinterpret_cast<unsigned char*>(smem + sweep_ring_floats<1>(K));
  const int mask_rows = sweep_mask_rows(K);

  const int xs = blockIdx.x * plan.wo, ys = blockIdx.y * plan.seg;
  const int width = min(plan.wo, d.cols - xs) + 2 * K;  // region columns
  const int rows = min(plan.seg, d.rows - ys);          // rows written
  const int inputs = rows + 2 * K;                      // input rows
  const int y0 = ys - K;  // domain row of the first input row
  const size_t plane = (size_t)d.rows * d.cols;

  // the loads: column cl (domain column xs - K + cl; K2 wraps it into the
  // grid, K9 places it in the region once), planes lane_l, lane_l +
  // kLoadLanes, ...
  const int cl = threadIdx.x % W, lane_l = threadIdx.x / W;
  int xl;
  if constexpr (kGrid) {
    xl = wrap(xs - K + cl, d.cols);
  } else {
    xl = src.place_x(xs - K + cl);
  }
  // the cells: columns c + i kSpan of levels lane + 1, lane + 1 + kLanes, ..
  const int c = threadIdx.x % kSpan, lane = threadIdx.x / kSpan;
  int gx[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    gx[i] = wrap(d.x0 + xs - K + c + i * kSpan, d.nx);

  // the input row of phase t (K2: wrapped grid row `row`) into group rows
  // ld (and its mask cell, returned)
  auto issue = [&](int t, int row, const int (&ld)[3]) {
    bool sol = false;
    if (cl < width && t < inputs) {
      const float* p;
      size_t stride;
      if constexpr (kGrid) {
        p = src.f + (size_t)row * d.cols + xl;
        stride = plane;
      } else {
        p = src.at_placed(y0 + t, xl, stride);
      }
      // the thread's planes as constants: one unrolled copy per lane
#pragma unroll
      for (int l = 0; l < kLoadLanes; ++l) {
        if (l != lane_l) continue;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int q = l + i * kLoadLanes;
          if (q < 9) cp_async4(ring_in + sweep_load_offset<1>(q, ld) + cl,
                               p + q * stride);
        }
      }
      if (kObstacle && lane_l == 0) {
        if constexpr (kGrid) {
          sol = __ldg(mask + (size_t)row * d.cols + xl) != 0;
        } else {
          sol = src.solid_placed(mask, y0 + t, xl);
        }
      }
    }
    cp_async_commit();
    return sol;
  };
  auto put_mask = [&](int t, bool sol) {
    if (kObstacle && lane_l == 0 && cl < width && t < inputs)
      solid[(t % mask_rows) * W + cl] = sol;
  };
  auto next_row = [&](int r) { return r + 1 == d.ny ? 0 : r + 1; };
  float coef[9];  // the diffusion family's (1 + c_j.u / cs2)
  if (kPhys == kDiffusion || kPhys == kNoisyFisher)
    feq_coefficients(prm.a, prm.b, coef);

  // the global row of phase t's input row, and (K2) of the row issued at
  // phase t
  int row_t = wrap(d.y0 + y0, d.ny);
  int row_next = row_t;
#pragma unroll
  for (int t = 0; t < kPrefetch; ++t) {
    const SweepPhase<1> ph(t - kPrefetch);
    put_mask(t, issue(t, row_next, ph.ld));
    row_next = next_row(row_next);
  }

  for (int t = 0; t < rows + 3 * K; ++t) {
    const SweepPhase<1> ph(t);
    const bool sol_next = issue(t + kPrefetch, row_next, ph.ld);
    const int t_mask = t % mask_rows;
    for (int s = 1 + lane; s <= K; s += kLanes) {
      if (t < 3 * s || t >= inputs + s) continue;
      bool act[kCols], any = false;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        act[i] = c + i * kSpan >= s && c + i * kSpan < width - s;
        any |= act[i];
      }
      if (!any) continue;
      int gy = row_t - 2 * s;
      if (gy < 0) gy = wrap(gy, d.ny);
      const bool first = s == 1;
      const float* in = first ? ring_in : rings + (s - 2) * kLevel;
      const float* g0 = in + (first ? ph.rd_in[0] : ph.rd[0]);
      const float* g1 = in + (first ? ph.rd_in[1] : ph.rd[1]);
      const float* g2 = in + (first ? ph.rd_in[2] : ph.rd[2]);
      int m = t_mask - 2 * s;
      m += m < 0 ? mask_rows : 0;
      float v[kCols][9], out[kCols][9], up[kCols][3];
      bool sol[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        // an idle cell reads a kept column of its level and stores nothing
        const int ci = act[i] ? c + i * kSpan : s;
        const RingPull<1> pull = {g0 + ci, g1 + ci, g2 + ci};
        pull(0, v[i]);
        sol[i] = kObstacle && solid[m * W + ci];
        up[i][0] = up[i][1] = up[i][2] = 0.0f;
        if (kPhys == kVelocityOpen && gx[i] == d.nx - 1) {
          // the zero-gradient outlet: the cell's own 3, 6 and 7 of rows y,
          // y - 1 and y + 1 (group rows 1, 2, 0), what its upstream cell
          // pulled
          up[i][0] = g1[2 * W + ci];
          up[i][1] = g2[2 * W + ci];
          up[i][2] = g0[W + ci];
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if constexpr (kPhys == kFlow) {
          cell_update<kIncomp, kObstacle>(v[i], out[i], gy, gx[i], d.ny,
                                          d.nx, sol[i], prm.omega, prm.a,
                                          prm.b);
        } else if constexpr (kVelocity) {
          velocity_cell_update<kPhys == kVelocityPair, kIncomp, kObstacle>(
              v[i], up[i], out[i], gx[i], d.nx, sol[i], prm.omega, prm.a,
              prm.b);
        } else {
          diffusion_cell_update<kPhys == kNoisyFisher>(
              v[i], out[i], prm, (unsigned long long)gy * d.nx + gx[i],
              prm.step0 + (s - 1), coef);
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (!act[i]) continue;
        if (s == K) {  // domain row y0 + t - 2K, column xs - K + c + i kSpan
          // (K2: the grid's gy, gx)
          const int oy = kGrid ? gy : y0 + t - 2 * K;
          const int ox = kGrid ? gx[i] : xs - K + c + i * kSpan;
          const GlobalPut<1> put = {f_out + (size_t)oy * d.cols + ox, plane};
#pragma unroll
          for (int j = 0; j < 9; ++j) put(j, 0, out[i][j]);
        } else {
          float* o = rings + (s - 1) * kLevel + c + i * kSpan;
          const RingPut<1> put = {o + ph.wr[0], o + ph.wr[1], o + ph.wr[2]};
#pragma unroll
          for (int j = 0; j < 9; ++j) put(j, 0, out[i][j]);
        }
      }
    }
    cp_async_wait<kPrefetch>();  // the row of phase t has landed
    put_mask(t + kPrefetch, sol_next);
    __syncthreads();
    row_t = next_row(row_t);
    row_next = next_row(row_next);
  }
}

// K2: the grid's own kernel, its source and domain known to the compiler
// (one kernel templated on the source ran K2 2% slower per step; PERF.md,
// section 6)
template <int kPhys, bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kSweepThreads, kMinBlocks)
temporal_step_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                     const int* __restrict__ mask, int ny, int nx, int K,
                     SweepPlan plan, StepParams prm) {
  sweep_steps<kPhys, kIncomp, kObstacle>(GridSource{f_in, ny, nx}, mask,
                                         f_out, Domain{ny, nx, 0, 0, ny, nx},
                                         K, plan, prm);
}

// K9: one shard d from its halos
template <int kPhys, bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kSweepThreads, kMinBlocks)
halo_sweep_kernel(HaloSource src, const int* __restrict__ mask,
                  float* __restrict__ f_out, Domain d, int K, SweepPlan plan,
                  StepParams prm) {
  sweep_steps<kPhys, kIncomp, kObstacle>(src, mask, f_out, d, K, plan, prm);
}

// Launch a sweep kernel, whose arguments are `head` then K, plan and prm,
// on a rows x cols domain: the work items fill one wave of resident blocks
// (`cache`: the kernel's occupancy per card and K).
template <bool kObstacle, class Kernel, class... Head>
cudaError_t launch_sweep(Kernel kernel, SweepSlots& cache, int rows, int cols,
                         int K, const StepParams& prm, cudaStream_t stream,
                         Head... head) {
  if (K < 1 || K > sweep_max_k<1>()) return cudaErrorInvalidValue;
  const int smem = sweep_smem<1>(K, kObstacle);
  int slots = 0;
  const cudaError_t err = cache.get(kernel, smem, K, slots);
  if (err != cudaSuccess) return err;
  const SweepPlan plan = sweep_plan(rows, cols, K, strip_width<1>(), slots);
  if (plan.segments > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(plan.strips, plan.segments), kSweepThreads, smem, stream>>>(
      head..., K, plan, prm);
  return cudaGetLastError();
}

}  // namespace
