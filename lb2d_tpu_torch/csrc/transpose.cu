// P2 for Hopper (sm_90a): out = in^T for a float32 in[rows][cols].
//
// Replaces benchmarks/probe_transpose.py:make_tr, a TPU probe that reads
// [128, n] row tiles of A into VMEM, transposes each there and writes
// [n, 128] column tiles of A^T. Here a block moves one 32 x 32 tile through
// shared memory: its 32 x 8 threads read the tile's rows (each warp one
// 128-byte row segment: coalesced), then write the tile's columns as rows
// of out (coalesced again). The tile is padded to 33 columns, so a warp's
// column read of shared memory hits 32 banks. Any rows x cols: the ragged
// edge tiles are masked.
//
// Bound: bytes, each element read once and written once (8 B): at the
// probe's default [4224, 8192], 276.8 MB, 0.0826 ms at the H100 SXM data
// sheet's 3.35 TB/s. A transpose is exact, so kernel and plain version
// (x.t().contiguous()) agree bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // rows of threads: each thread moves 4 elements

__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int rows, int cols) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
#pragma unroll
  for (int k = 0; k < kTile; k += kRows) {
    const int r = r0 + ty + k, c = c0 + tx;
    if (r < rows && c < cols) tile[ty + k][tx] = in[(size_t)r * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTile; k += kRows) {
    const int c = c0 + ty + k, r = r0 + tx;  // out row c, column r
    if (c < cols && r < rows) out[(size_t)c * rows + r] = tile[tx][ty + k];
  }
}

}  // namespace

// out[cols][rows] = in[rows][cols]^T (float32, contiguous, distinct).
// Launches on `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_transpose(const float* in, float* out, int rows, int cols,
                              void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  transpose_kernel<<<grid, dim3(kTile, kRows), 0,
                     static_cast<cudaStream_t>(stream)>>>(in, out, rows,
                                                          cols);
  return (int)cudaGetLastError();
}
