// n D2Q9 lattice-Boltzmann steps in one launch, for Hopper (sm_90a): K3.
//
// Replaces lb2d_tpu/ops/fused.py:make_resident_pipe_step with each of its
// physics: "flow", "velocity_inlet" (here with either outlet and an
// optional obstacle, as K2's velocity variant) and the periodic
// "diffusion" and "noisy_fisher". On the TPU the whole state sits in VMEM
// and one kernel loops over the n steps, so a small grid pays no dispatch
// per step. A block of a GPU cannot hold a grid of useful size and blocks
// cannot wait for each other in an ordinary launch, so the counterpart here
// is a cooperative launch: as many blocks as can be resident at once walk
// the cells in a grid-stride loop, one step at a time, between f and a
// scratch buffer, with a grid-wide barrier (cooperative_groups grid.sync)
// between steps. The step count n is a runtime argument, so one build
// serves any run length. The noisy physics draws the Philox normal of
// (cell, step0 + i) at in-launch step i (philox.cuh), so the run is the
// same trajectory as n plain steps or K2 launches from global step step0.
// (The TPU kernel reseeds per launch step; its realization depends on the
// launch, this one does not.)
//
// Bound: on small grids (the reference's 32x256, 8,192 cells) one step is
// a few microseconds of barrier and L2 latency, against a host launch of
// more than ten microseconds per step for K1; both buffers stay in the
// 50 MB L2 for grids up to a few hundred thousand cells. Reads of the
// previous step go through L2 only (__ldcg): other blocks wrote them in
// this launch. This first version keeps the state in global memory (L2);
// holding it in the shared memory of a thread-block cluster, with cluster
// barriers instead of grid barriers, is left to later work.

#include <cooperative_groups.h>

#include "pipe_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;

// physics, a template parameter of the kernel (as in temporal_step.cu)
constexpr int kFlow = 0;
constexpr int kVelocityOpen = 1;
constexpr int kVelocityPair = 2;
constexpr int kDiffusion = 3;
constexpr int kNoisyFisher = 4;

template <int kPhys, bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kBlock)
resident_run_kernel(float* f, float* scratch, const int* __restrict__ mask,
                    int ny, int nx, int n, StepParams prm) {
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)ny * nx;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float* src = f;
  float* dst = scratch;
  if (n & 1) {  // odd n: start from a copy, so that the last step writes f
    for (size_t i = first; i < 9 * plane; i += stride) scratch[i] = f[i];
    grid.sync();
    src = scratch;
    dst = f;
  }
  for (int step = 0; step < n; ++step) {
    for (size_t cell = first; cell < plane; cell += stride) {
      const int y = (int)(cell / nx);
      const int x = (int)(cell - (size_t)y * nx);
      float s[9], out[9];
      pull<true>(src, y, x, ny, nx, s);
      const bool solid = kObstacle && mask[cell] != 0;
      if constexpr (kPhys == kFlow) {
        cell_update<kIncomp, kObstacle>(s, out, y, x, ny, nx, solid,
                                        prm.omega, prm.a, prm.b);
      } else if constexpr (kPhys == kDiffusion || kPhys == kNoisyFisher) {
        diffusion_cell_update<kPhys == kNoisyFisher>(s, out, prm, cell,
                                                     prm.step0 + step);
      } else {
        // the zero-gradient outlet takes the pre-stream f[3, y, nx-1],
        // f[6, y-1, nx-1], f[7, y+1, nx-1] (pipe_cell.cuh)
        float up[3] = {0.0f, 0.0f, 0.0f};
        if (kPhys == kVelocityOpen && x == nx - 1) {
          const int ym = y == 0 ? ny - 1 : y - 1;
          const int yp = y == ny - 1 ? 0 : y + 1;
          up[0] = __ldcg(src + 3 * plane + cell);
          up[1] = __ldcg(src + 6 * plane + (size_t)ym * nx + x);
          up[2] = __ldcg(src + 7 * plane + (size_t)yp * nx + x);
        }
        velocity_cell_update<kPhys == kVelocityPair, kIncomp, kObstacle>(
            s, up, out, x, nx, solid, prm.omega, prm.a, prm.b);
      }
#pragma unroll
      for (int j = 0; j < 9; ++j) dst[j * plane + cell] = out[j];
    }
    grid.sync();  // step complete everywhere before the next one pulls
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <int kPhys, bool kIncomp, bool kObstacle>
cudaError_t launch(float* f, float* scratch, const int* mask, int ny, int nx,
                   int n, StepParams prm, cudaStream_t stream) {
  static int max_blocks = 0;  // co-resident blocks, once per instantiation
  if (max_blocks == 0) {
    int device, sms, per_sm;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, resident_run_kernel<kPhys, kIncomp, kObstacle>, kBlock, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    max_blocks = sms * per_sm;
  }
  const long long cells = (long long)ny * nx;
  const long long need = (cells + kBlock - 1) / kBlock;
  const int blocks = (int)(need < max_blocks ? need : max_blocks);
  void* args[] = {&f, &scratch, &mask, &ny, &nx, &n, &prm};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)resident_run_kernel<kPhys, kIncomp, kObstacle>,
      dim3(blocks), dim3(kBlock), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kPhys>
cudaError_t dispatch(float* f, float* scratch, const int* mask, int ny,
                     int nx, int n, const StepParams& prm, int incompressible,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (incompressible) {
    return mask ? launch<kPhys, true, true>(f, scratch, mask, ny, nx, n, prm, s)
                : launch<kPhys, true, false>(f, scratch, mask, ny, nx, n, prm, s);
  }
  return mask ? launch<kPhys, false, true>(f, scratch, mask, ny, nx, n, prm, s)
              : launch<kPhys, false, false>(f, scratch, mask, ny, nx, n, prm, s);
}

}  // namespace

// n pressure-driven steps of f in place, in one launch. f, scratch:
// [9, ny, nx] float32, contiguous, distinct (scratch's contents are
// overwritten). mask: [ny, nx] int32 or NULL. n >= 1. Launches on `stream`
// and returns the launch's CUDA error code.
extern "C" int lb2d_resident_run(float* f, float* scratch, const int* mask,
                                 int ny, int nx, int n, float omega,
                                 float inlet_rho, float outlet_rho,
                                 int incompressible, void* stream) {
  if (ny < 1 || nx < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, inlet_rho, outlet_rho, 0.0f, 0.0f, 0u, 0u, 0ull};
  return (int)dispatch<kFlow>(f, scratch, mask, ny, nx, n, prm,
                              incompressible, stream);
}

// n velocity-inlet steps of f in place, in one launch (inlet velocity u_w;
// outlet velocity u_e with velocity_outlet, else the zero-gradient outlet;
// periodic in y). Arguments and result as lb2d_resident_run; nx >= 2.
extern "C" int lb2d_resident_velocity_run(float* f, float* scratch,
                                          const int* mask, int ny, int nx,
                                          int n, float omega, float u_w,
                                          float u_e, int velocity_outlet,
                                          int incompressible, void* stream) {
  if (ny < 1 || nx < 2 || n < 1) return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u_w, u_e, 0.0f, 0.0f, 0u, 0u, 0ull};
  if (velocity_outlet)
    return (int)dispatch<kVelocityPair>(f, scratch, mask, ny, nx, n, prm,
                                        incompressible, stream);
  return (int)dispatch<kVelocityOpen>(f, scratch, mask, ny, nx, n, prm,
                                      incompressible, stream);
}

// n steps of the periodic advection-diffusion family of f in place, in one
// launch: imposed lattice velocity (u, v), growth g; with noisy, noise
// amplitude dg, Philox key (key0, key1), global steps step0 .. step0 + n -
// 1, and the clip. Arguments and result as lb2d_resident_run.
extern "C" int lb2d_resident_diffusion_run(
    float* f, float* scratch, int ny, int nx, int n, float omega, float u,
    float v, float g, float dg, int noisy, unsigned key0, unsigned key1,
    unsigned long long step0, void* stream) {
  if (ny < 1 || nx < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const StepParams prm = {omega, u, v, g, dg, key0, key1, step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noisy)
    return (int)launch<kNoisyFisher, false, false>(f, scratch, nullptr, ny, nx,
                                                   n, prm, s);
  return (int)launch<kDiffusion, false, false>(f, scratch, nullptr, ny, nx, n,
                                               prm, s);
}
