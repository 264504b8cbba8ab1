// n D2Q9 pipe-flow steps in one launch, for Hopper (sm_90a): K3.
//
// Replaces lb2d_tpu/ops/fused.py:make_resident_pipe_step with
// physics="flow". On the TPU the whole state sits in VMEM and one kernel
// loops over the n steps, so a small grid pays no dispatch per step. A
// block of a GPU cannot hold a grid of useful size and blocks cannot wait
// for each other in an ordinary launch, so the counterpart here is a
// cooperative launch: as many blocks as can be resident at once walk the
// cells in a grid-stride loop, one step at a time, between f and a scratch
// buffer, with a grid-wide barrier (cooperative_groups grid.sync) between
// steps. The step count n is a runtime argument, so one build serves any
// run length.
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

template <bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kBlock)
resident_run_kernel(float* f, float* scratch, const int* __restrict__ mask,
                    int ny, int nx, int n, float omega, float rin,
                    float rout) {
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
      cell_update<kIncomp, kObstacle>(s, out, y, x, ny, nx, solid, omega, rin,
                                      rout);
#pragma unroll
      for (int j = 0; j < 9; ++j) dst[j * plane + cell] = out[j];
    }
    grid.sync();  // step complete everywhere before the next one pulls
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <bool kIncomp, bool kObstacle>
cudaError_t launch(float* f, float* scratch, const int* mask, int ny, int nx,
                   int n, float omega, float rin, float rout,
                   cudaStream_t stream) {
  static int max_blocks = 0;  // co-resident blocks, once per instantiation
  if (max_blocks == 0) {
    int device, sms, per_sm;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, resident_run_kernel<kIncomp, kObstacle>, kBlock, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    max_blocks = sms * per_sm;
  }
  const long long cells = (long long)ny * nx;
  const long long need = (cells + kBlock - 1) / kBlock;
  const int blocks = (int)(need < max_blocks ? need : max_blocks);
  void* args[] = {&f, &scratch, &mask, &ny, &nx, &n, &omega, &rin, &rout};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)resident_run_kernel<kIncomp, kObstacle>, dim3(blocks),
      dim3(kBlock), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// n steps of f in place, in one launch. f, scratch: [9, ny, nx] float32,
// contiguous, distinct (scratch's contents are overwritten). mask: [ny, nx]
// int32 or NULL. n >= 1. Launches on `stream` and returns the launch's CUDA
// error code.
extern "C" int lb2d_resident_run(float* f, float* scratch, const int* mask,
                                 int ny, int nx, int n, float omega,
                                 float inlet_rho, float outlet_rho,
                                 int incompressible, void* stream) {
  if (ny < 1 || nx < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (incompressible) {
    err = mask ? launch<true, true>(f, scratch, mask, ny, nx, n, omega, inlet_rho, outlet_rho, s)
               : launch<true, false>(f, scratch, mask, ny, nx, n, omega, inlet_rho, outlet_rho, s);
  } else {
    err = mask ? launch<false, true>(f, scratch, mask, ny, nx, n, omega, inlet_rho, outlet_rho, s)
               : launch<false, false>(f, scratch, mask, ny, nx, n, omega, inlet_rho, outlet_rho, s);
  }
  return (int)err;
}
