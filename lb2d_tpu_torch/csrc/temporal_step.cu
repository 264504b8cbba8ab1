// K D2Q9 lattice-Boltzmann steps per pass over f, for Hopper (sm_90a): K2.
//
// Replaces lb2d_tpu/ops/fused.py:make_temporal_pipe_step with each of its
// physics: "flow" (the pressure-driven pipe flow, with or without an
// obstacle), "velocity_inlet" (the velocity inlet with the zero-gradient
// outlet, periodic in y; here also with the velocity outlet and an
// obstacle, as the model's plain step allows), and the fully periodic
// "diffusion" and "noisy_fisher" of the advection-diffusion family. The
// TPU kernel sweeps 16-row chunks in order and keeps K-1 VMEM rings of
// intermediate steps; its skewed loop, DMA semaphores and 128-lane
// alignment are scheduling for a sequential grid and are not carried over.
// What is kept is the idea: read f once and write it once for K steps, so
// HBM traffic per step falls from 72 B/cell towards 72/K.
//
// Design: each block owns a 32 x 32 region of cells (kTile) whose inner
// (32 - 2K)^2 cells it writes; the K-cell ring around them is the halo.
// The block loads the region's 9 planes into shared memory (periodic wrap,
// so any ny x nx works and a tile may wrap onto itself on a small grid),
// then runs K steps between two shared-memory buffers. Step s is computed
// on the cells at least s from the region's edge, which pull only from
// cells valid at step s-1; the last step writes the inner cells straight
// to f_out. Each cell uses cell_update, velocity_cell_update or
// diffusion_cell_update (pipe_cell.cuh) with its wrapped global
// coordinates, so the BCs and the mask apply exactly as in K single steps,
// and the y-periodic families need no seam patch (the TPU kernel's chunks
// do not wrap in y, so lb2d_tpu's models recompute the seam rows with
// plain steps). The noise of a cell at stage s is the Philox normal of
// (its global index, step0 + s - 1) (philox.cuh): a halo cell recomputed
// here draws the same normal as the block that owns it, so K2 at any K
// follows K single plain steps with noise on.
//
// Bound: per cell written, the block reads 1024/(32-2K)^2 cells' 36 B
// (neighbouring blocks' overlapping halos mostly come from L2) and writes
// 36 B once for K steps; it recomputes the halo, (32-2s)^2 cells at step s.
// The noisy update adds ten Philox rounds and logf/sqrtf/cosf per
// cell-step, paid again on every recomputed halo cell, so each physics has
// its own best K (PERF.md: 3 for flow and diffusion, 2 for noisy_fisher
// at 2048^2-4096^2; the diffusion update, though cheaper than flow's,
// takes as long per cell-step, so the tile structure, not arithmetic,
// bounds this kernel).
// Two 36 KB buffers (plus 1 KB of mask) let three blocks share an SM. This
// first version loads with plain loads and synchronises the whole block
// between steps; cp.async/TMA double buffering, larger tiles and warp
// specialisation are left to later work.
//
// K9 (halo_step_kernel, lb2d_halo_step) is K2's design on one shard of a
// domain-decomposed grid: it replaces lb2d_tpu/ops/fused_halo.py:
// make_temporal_halo_step for the physics above. Its region loads through
// region_source.cuh's HaloSource (the shard, the K-row halos from its
// y-neighbours and, on 2-D meshes, the K-column strips from its
// x-neighbours) instead of the grid's wrap, it writes the shard's cells,
// and every cell keeps its global coordinates, so the BCs, the mask and
// the noise are those of K2 on the whole grid, through the same per-cell
// updates. Bound as K2's, plus the halo's bytes (2K rows and, on 2-D
// meshes, 2K columns per shard). The two kernels keep separate step loops:
// one loop templated on the region's source made nvcc allocate K2's
// registers differently, and K2 ran 7.6-22% slower (PERF.md, section 6).

#include "pipe_cell.cuh"
#include "region_source.cuh"

namespace {

constexpr int kTile = 32;                       // region edge, halo included
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kTile;  // 8
constexpr int kPasses = kTile / kRowsPerPass;   // 4 rows per thread
constexpr int kPlane = kTile * kTile;           // cells per region plane
constexpr int kMaxK = 8;                        // inner edge >= 16

// physics, a template parameter of the kernel
constexpr int kFlow = 0;          // pressure inlet/outlet, walls (a, b = rho)
constexpr int kVelocityOpen = 1;  // velocity inlet, open outlet (a, b = u)
constexpr int kVelocityPair = 2;  // velocity inlet and outlet (a, b = u)
constexpr int kDiffusion = 3;     // periodic, linear feq, growth (a, b = u, v)
constexpr int kNoisyFisher = 4;   // kDiffusion + Philox noise and clip

template <int kPhys, bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kThreads, 3)
temporal_step_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                     const int* __restrict__ mask, int ny, int nx, int K,
                     StepParams prm) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + 9 * kPlane;
  unsigned char* solid = reinterpret_cast<unsigned char*>(smem + 18 * kPlane);

  const int inner = kTile - 2 * K;
  const int y0 = blockIdx.y * inner - K;  // unwrapped row of region row 0
  const int x0 = blockIdx.x * inner - K;
  const int c = threadIdx.x % kTile;
  const int r_first = threadIdx.x / kTile;
  const int gx = wrap(x0 + c, nx);
  const size_t plane = (size_t)ny * nx;

  // the step-0 region
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r_first + i * kRowsPerPass;
    const size_t g = (size_t)wrap(y0 + r, ny) * nx + gx;
#pragma unroll
    for (int j = 0; j < 9; ++j) cur[j * kPlane + r * kTile + c] = f_in[j * plane + g];
    if (kObstacle) solid[r * kTile + c] = mask[g] != 0;
  }
  __syncthreads();

  for (int s = 1; s <= K; ++s) {
    const bool last = s == K;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = r_first + i * kRowsPerPass;
      if (r < s || r >= kTile - s || c < s || c >= kTile - s) continue;
      if (last && (y0 + r >= ny || x0 + c >= nx)) continue;  // ragged edge
      const int gy = wrap(y0 + r, ny);
      const float* p = cur + r * kTile + c;
      float v[9], out[9];
      v[0] = p[0 * kPlane];
      v[1] = p[1 * kPlane - 1];
      v[2] = p[2 * kPlane - kTile];
      v[3] = p[3 * kPlane + 1];
      v[4] = p[4 * kPlane + kTile];
      v[5] = p[5 * kPlane - kTile - 1];
      v[6] = p[6 * kPlane - kTile + 1];
      v[7] = p[7 * kPlane + kTile + 1];
      v[8] = p[8 * kPlane + kTile - 1];
      const bool sol = kObstacle && solid[r * kTile + c];
      if constexpr (kPhys == kFlow) {
        cell_update<kIncomp, kObstacle>(v, out, gy, gx, ny, nx, sol, prm.omega,
                                        prm.a, prm.b);
      } else if constexpr (kPhys == kDiffusion || kPhys == kNoisyFisher) {
        diffusion_cell_update<kPhys == kNoisyFisher>(
            v, out, prm, (unsigned long long)gy * nx + gx, prm.step0 + (s - 1));
      } else {
        float up[3] = {0.0f, 0.0f, 0.0f};
        if (kPhys == kVelocityOpen && gx == nx - 1) {
          up[0] = p[3 * kPlane];
          up[1] = p[6 * kPlane - kTile];
          up[2] = p[7 * kPlane + kTile];
        }
        velocity_cell_update<kPhys == kVelocityPair, kIncomp, kObstacle>(
            v, up, out, gx, nx, sol, prm.omega, prm.a, prm.b);
      }
      if (last) {
        const size_t g = (size_t)gy * nx + gx;
#pragma unroll
        for (int j = 0; j < 9; ++j) f_out[j * plane + g] = out[j];
      } else {
#pragma unroll
        for (int j = 0; j < 9; ++j) nxt[j * kPlane + r * kTile + c] = out[j];
      }
    }
    if (!last) {
      __syncthreads();  // step s complete before step s+1 reads it
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <int kPhys, bool kIncomp, bool kObstacle>
cudaError_t launch(const float* f_in, float* f_out, const int* mask, int ny,
                   int nx, int K, const StepParams& prm, cudaStream_t stream) {
  const int smem = 18 * kPlane * (int)sizeof(float) + (kObstacle ? kPlane : 0);
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        temporal_step_kernel<kPhys, kIncomp, kObstacle>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int inner = kTile - 2 * K;
  const dim3 grid((nx + inner - 1) / inner, (ny + inner - 1) / inner);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  temporal_step_kernel<kPhys, kIncomp, kObstacle>
      <<<grid, kThreads, smem, stream>>>(f_in, f_out, mask, ny, nx, K, prm);
  return cudaGetLastError();
}

template <int kPhys>
cudaError_t dispatch(const float* f_in, float* f_out, const int* mask, int ny,
                     int nx, int K, const StepParams& prm, int incompressible,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (incompressible) {
    return mask ? launch<kPhys, true, true>(f_in, f_out, mask, ny, nx, K, prm, s)
                : launch<kPhys, true, false>(f_in, f_out, mask, ny, nx, K, prm, s);
  }
  return mask ? launch<kPhys, false, true>(f_in, f_out, mask, ny, nx, K, prm, s)
              : launch<kPhys, false, false>(f_in, f_out, mask, ny, nx, K, prm, s);
}

// K9: K steps of one shard, the domain d, whose region comes from src.
// K2's loop; the region's cells (y, x) are the shard's, unwrapped, their
// global coordinates wrap(d.y0 + y, d.ny) and wrap(d.x0 + x, d.nx).
template <int kPhys, bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kThreads, 3)
halo_step_kernel(HaloSource src, const int* __restrict__ mask,
                 float* __restrict__ f_out, Domain d, int K,
                 StepParams prm) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + 9 * kPlane;
  unsigned char* solid = reinterpret_cast<unsigned char*>(smem + 18 * kPlane);

  const int inner = kTile - 2 * K;
  const int y0 = blockIdx.y * inner - K;  // shard row of region row 0
  const int x0 = blockIdx.x * inner - K;
  const int c = threadIdx.x % kTile;
  const int r_first = threadIdx.x / kTile;
  const int gx = wrap(d.x0 + x0 + c, d.nx);
  const size_t plane = (size_t)d.rows * d.cols;

  // the step-0 region
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = r_first + i * kRowsPerPass;
    size_t stride;
    const float* p = src.at(y0 + r, x0 + c, stride);
#pragma unroll
    for (int j = 0; j < 9; ++j) cur[j * kPlane + r * kTile + c] = __ldg(p + j * stride);
    if (kObstacle) solid[r * kTile + c] = src.solid(mask, y0 + r, x0 + c);
  }
  __syncthreads();

  for (int s = 1; s <= K; ++s) {
    const bool last = s == K;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = r_first + i * kRowsPerPass;
      if (r < s || r >= kTile - s || c < s || c >= kTile - s) continue;
      if (last && (y0 + r >= d.rows || x0 + c >= d.cols)) continue;  // ragged edge
      const int gy = wrap(d.y0 + y0 + r, d.ny);
      const float* p = cur + r * kTile + c;
      float v[9], out[9];
      v[0] = p[0 * kPlane];
      v[1] = p[1 * kPlane - 1];
      v[2] = p[2 * kPlane - kTile];
      v[3] = p[3 * kPlane + 1];
      v[4] = p[4 * kPlane + kTile];
      v[5] = p[5 * kPlane - kTile - 1];
      v[6] = p[6 * kPlane - kTile + 1];
      v[7] = p[7 * kPlane + kTile + 1];
      v[8] = p[8 * kPlane + kTile - 1];
      const bool sol = kObstacle && solid[r * kTile + c];
      if constexpr (kPhys == kFlow) {
        cell_update<kIncomp, kObstacle>(v, out, gy, gx, d.ny, d.nx, sol,
                                        prm.omega, prm.a, prm.b);
      } else if constexpr (kPhys == kDiffusion || kPhys == kNoisyFisher) {
        diffusion_cell_update<kPhys == kNoisyFisher>(
            v, out, prm, (unsigned long long)gy * d.nx + gx,
            prm.step0 + (s - 1));
      } else {
        float up[3] = {0.0f, 0.0f, 0.0f};
        if (kPhys == kVelocityOpen && gx == d.nx - 1) {
          up[0] = p[3 * kPlane];
          up[1] = p[6 * kPlane - kTile];
          up[2] = p[7 * kPlane + kTile];
        }
        velocity_cell_update<kPhys == kVelocityPair, kIncomp, kObstacle>(
            v, up, out, gx, d.nx, sol, prm.omega, prm.a, prm.b);
      }
      if (last) {
        const size_t g = (size_t)(y0 + r) * d.cols + (x0 + c);
#pragma unroll
        for (int j = 0; j < 9; ++j) f_out[j * plane + g] = out[j];
      } else {
#pragma unroll
        for (int j = 0; j < 9; ++j) nxt[j * kPlane + r * kTile + c] = out[j];
      }
    }
    if (!last) {
      __syncthreads();  // step s complete before step s+1 reads it
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <int kPhys, bool kIncomp, bool kObstacle>
cudaError_t halo_launch(const HaloSource& src, const int* mask, float* f_out,
                        const Domain& d, int K, const StepParams& prm,
                        cudaStream_t stream) {
  const int smem = 18 * kPlane * (int)sizeof(float) + (kObstacle ? kPlane : 0);
  // once per instantiation and card: the attribute is the card's
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        halo_step_kernel<kPhys, kIncomp, kObstacle>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int inner = kTile - 2 * K;
  const dim3 grid((d.cols + inner - 1) / inner, (d.rows + inner - 1) / inner);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  halo_step_kernel<kPhys, kIncomp, kObstacle>
      <<<grid, kThreads, smem, stream>>>(src, mask, f_out, d, K, prm);
  return cudaGetLastError();
}

template <int kPhys>
cudaError_t halo_dispatch(const HaloSource& src, const int* mask,
                          float* f_out, const Domain& d, int K,
                          const StepParams& prm, int incompressible,
                          cudaStream_t s) {
  if (incompressible) {
    return mask ? halo_launch<kPhys, true, true>(src, mask, f_out, d, K, prm, s)
                : halo_launch<kPhys, true, false>(src, mask, f_out, d, K, prm, s);
  }
  return mask ? halo_launch<kPhys, false, true>(src, mask, f_out, d, K, prm, s)
              : halo_launch<kPhys, false, false>(src, mask, f_out, d, K, prm, s);
}

}  // namespace

// k_steps pressure-driven steps of f_in into f_out. f_in, f_out: [9, ny, nx]
// float32, contiguous, distinct. mask: [ny, nx] int32 or NULL.
// 1 <= k_steps <= 8. Launches on `stream` and returns the launch's CUDA
// error code.
extern "C" int lb2d_temporal_step(const float* f_in, float* f_out,
                                  const int* mask, int ny, int nx, int k_steps,
                                  float omega, float inlet_rho,
                                  float outlet_rho, int incompressible,
                                  void* stream) {
  if (ny < 1 || nx < 1 || k_steps < 1 || k_steps > kMaxK)
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, inlet_rho, outlet_rho, 0.0f, 0.0f, 0u, 0u, 0ull};
  return (int)dispatch<kFlow>(f_in, f_out, mask, ny, nx, k_steps, prm,
                              incompressible, stream);
}

// k_steps velocity-inlet steps of f_in into f_out (inlet velocity u_w;
// outlet velocity u_e with velocity_outlet, else the zero-gradient outlet).
// Arguments and result as lb2d_temporal_step; nx >= 2.
extern "C" int lb2d_temporal_velocity_step(const float* f_in, float* f_out,
                                           const int* mask, int ny, int nx,
                                           int k_steps, float omega, float u_w,
                                           float u_e, int velocity_outlet,
                                           int incompressible, void* stream) {
  if (ny < 1 || nx < 2 || k_steps < 1 || k_steps > kMaxK)
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u_w, u_e, 0.0f, 0.0f, 0u, 0u, 0ull};
  if (velocity_outlet)
    return (int)dispatch<kVelocityPair>(f_in, f_out, mask, ny, nx, k_steps,
                                        prm, incompressible, stream);
  return (int)dispatch<kVelocityOpen>(f_in, f_out, mask, ny, nx, k_steps, prm,
                                      incompressible, stream);
}

// k_steps steps of the periodic advection-diffusion family of f_in into
// f_out: imposed lattice velocity (u, v), growth g; with noisy, noise
// amplitude dg, Philox key (key0, key1), global steps step0 .. step0 +
// k_steps - 1, and the clip. Arguments and result as lb2d_temporal_step.
extern "C" int lb2d_temporal_diffusion_step(
    const float* f_in, float* f_out, int ny, int nx, int k_steps, float omega,
    float u, float v, float g, float dg, int noisy, unsigned key0,
    unsigned key1, unsigned long long step0, void* stream) {
  if (ny < 1 || nx < 1 || k_steps < 1 || k_steps > kMaxK)
    return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u, v, g, dg, key0, key1, step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noisy)
    return (int)launch<kNoisyFisher, false, false>(f_in, f_out, nullptr, ny,
                                                   nx, k_steps, prm, s);
  return (int)launch<kDiffusion, false, false>(f_in, f_out, nullptr, ny, nx,
                                               k_steps, prm, s);
}

// K9: k_steps steps of one shard f[9][H][W], global rows [y0, y0 + H) and
// columns [x0, x0 + W) of an ny x nx grid, into f_out[9][H][W], from its
// halos (region_source.cuh: HaloSource): top, bot [9][hk][W]; left, right
// [9][H + 2hk][hk], or both NULL when W == nx (x wraps within the shard).
// mask: the obstacle mask of the region [H + 2hk][W + 2hk], or NULL.
// physics: 0 pressure-driven flow (a, b = inlet, outlet rho), 1 velocity
// inlet with the zero-gradient outlet, 2 with the velocity outlet (a, b =
// u_w, u_e), 3 diffusion, 4 noisy Fisher (a, b = u, v; g, dg, key, step0 as
// lb2d_temporal_diffusion_step). 1 <= k_steps <= min(8, hk). Launches on
// `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_halo_step(const float* f, const float* top,
                              const float* bot, const float* left,
                              const float* right, const int* mask,
                              float* f_out, int H, int W, int hk, int y0,
                              int x0, int ny, int nx, int k_steps,
                              int physics, int incompressible, float omega,
                              float a, float b, float g, float dg,
                              unsigned key0, unsigned key1,
                              unsigned long long step0, void* stream) {
  if (H < 1 || W < 1 || hk < 1 || k_steps < 1 || k_steps > kMaxK ||
      k_steps > hk || (left == nullptr) != (right == nullptr) ||
      (left == nullptr && W != nx) || y0 < 0 || y0 + H > ny || x0 < 0 ||
      x0 + W > nx || (physics == kVelocityOpen && nx < 2))
    return (int)cudaErrorInvalidValue;
  const HaloSource src = {f, top, bot, left, right, H, W, hk};
  const Domain d = {H, W, y0, x0, ny, nx};
  const StepParams prm = {omega, a, b, g, dg, key0, key1, step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (physics) {
    case kFlow:
      return (int)halo_dispatch<kFlow>(src, mask, f_out, d, k_steps, prm,
                                       incompressible, s);
    case kVelocityOpen:
      return (int)halo_dispatch<kVelocityOpen>(src, mask, f_out, d, k_steps,
                                               prm, incompressible, s);
    case kVelocityPair:
      return (int)halo_dispatch<kVelocityPair>(src, mask, f_out, d, k_steps,
                                               prm, incompressible, s);
    case kDiffusion:
      return (int)halo_launch<kDiffusion, false, false>(
          src, nullptr, f_out, d, k_steps, prm, s);
    case kNoisyFisher:
      return (int)halo_launch<kNoisyFisher, false, false>(
          src, nullptr, f_out, d, k_steps, prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
