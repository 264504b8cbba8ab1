// One D2Q9 pressure-driven pipe-flow step for Hopper (sm_90a): K1.
//
// Replaces the single-step Pallas kernels of lb2d_tpu/ops/fused.py:
// make_fused_pipe_step (blocked row tiles with halo DMAs) and
// make_pipelined_pipe_step (single sweep through a VMEM ring). Both compute
// the same step from the tile math at fused.py:56-215; their VMEM rings,
// DMA semaphores, (8,128) alignment and narrow boundary tiles are TPU
// scheduling and are not carried over. Here one thread owns one cell
// (y, x), x fastest: it pulls its 9 values with periodic wrap, applies
// cell_update (pipe_cell.cuh: BCs, bounce-back, moments, feq, BGK) and
// writes the 9 results to f_out (out of place; the caller ping-pongs).
//
// Bound: HBM bandwidth. Each cell-step reads 9 and writes 9 float32
// values, 72 B, plus 4 B for the int32 obstacle mask when there is one;
// the arithmetic is ~150 flops per cell, far below the card's ratio. The
// pull reads of neighbouring rows are served from L1/L2, so one pass moves
// the minimum bytes for one step. Fewer bytes per step need several steps
// per pass: that is temporal_step.cu (K2).

#include "pipe_cell.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kIncomp, bool kObstacle>
__global__ void __launch_bounds__(kBlock)
pipe_step_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                 const int* __restrict__ mask, int ny, int nx, float omega,
                 float rin, float rout) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  if (x >= nx) return;
  const size_t plane = (size_t)ny * nx;
  for (int y = blockIdx.y; y < ny; y += gridDim.y) {
    const size_t cell = (size_t)y * nx + x;
    float s[9], out[9];
    pull(f_in, y, x, ny, nx, s);
    const bool solid = kObstacle && mask[cell] != 0;
    cell_update<kIncomp, kObstacle>(s, out, y, x, ny, nx, solid, omega, rin,
                                    rout);
#pragma unroll
    for (int j = 0; j < 9; ++j) f_out[j * plane + cell] = out[j];
  }
}

template <bool kIncomp, bool kObstacle>
void launch(const float* f_in, float* f_out, const int* mask, int ny, int nx,
            float omega, float rin, float rout, cudaStream_t stream) {
  const dim3 grid((nx + kBlock - 1) / kBlock, ny < 65535 ? ny : 65535);
  pipe_step_kernel<kIncomp, kObstacle><<<grid, kBlock, 0, stream>>>(
      f_in, f_out, mask, ny, nx, omega, rin, rout);
}

}  // namespace

// f_in, f_out: [9, ny, nx] float32, contiguous, distinct. mask: [ny, nx]
// int32 or NULL. Launches on `stream` and returns cudaGetLastError().
extern "C" int lb2d_pipe_step(const float* f_in, float* f_out, const int* mask,
                              int ny, int nx, float omega, float inlet_rho,
                              float outlet_rho, int incompressible,
                              void* stream) {
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (incompressible) {
    if (mask) launch<true, true>(f_in, f_out, mask, ny, nx, omega, inlet_rho, outlet_rho, s);
    else launch<true, false>(f_in, f_out, mask, ny, nx, omega, inlet_rho, outlet_rho, s);
  } else {
    if (mask) launch<false, true>(f_in, f_out, mask, ny, nx, omega, inlet_rho, outlet_rho, s);
    else launch<false, false>(f_in, f_out, mask, ny, nx, omega, inlet_rho, outlet_rho, s);
  }
  return (int)cudaGetLastError();
}
