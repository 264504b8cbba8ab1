// Standard normals of one global step, for Hopper (sm_90a): P1.
//
// Replaces benchmarks/tpu_tests.py:_kernel_normals, the probe that draws
// the TPU's on-core PRNG normals (pltpu.prng_random_bits + Box-Muller,
// lb2d_tpu/ops/fused.py:295-302) into an array so that their statistics can
// be tested. Here the generator is the counter-based Philox of philox.cuh,
// and lb2d_normals fills out[cell] with exactly the normal that the noisy
// kernels (temporal_step.cu, resident_run.cu) draw for that cell at that
// step. lb2d_philox_bits writes the four raw Philox words instead, so the
// integer part can be held to the plain version (ops/random.py) bit for
// bit.
//
// Bound: one thread per cell; 4 B written per cell against ten Philox
// rounds (4 integer multiplies and 4 xors each) and logf, sqrtf, cosf, so
// operations, not bytes, bound it at every size.

#include "philox.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
normals_kernel(float* __restrict__ out, long long n, unsigned k0, unsigned k1,
               unsigned long long step) {
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride)
    out[i] = cell_normal((unsigned long long)i, step, k0, k1);
}

__global__ void __launch_bounds__(kBlock)
philox_bits_kernel(unsigned* __restrict__ out, long long n, unsigned k0,
                   unsigned k1, unsigned long long step) {
  const long long stride = (long long)gridDim.x * kBlock;
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride) {
    const uint4 b = philox4x32_10(
        make_uint4((unsigned)i, (unsigned)step, (unsigned)(step >> 32), 0u),
        k0, k1);
    out[i] = b.x;
    out[n + i] = b.y;
    out[2 * n + i] = b.z;
    out[3 * n + i] = b.w;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  return (int)(blocks < 65536 ? blocks : 65536);
}

}  // namespace

// out[i] = the standard normal of cell i at global step `step` under the
// Philox key (key0, key1), i < n. out: n float32. Launches on `stream` and
// returns the launch's CUDA error code.
extern "C" int lb2d_normals(float* out, long long n, unsigned key0,
                            unsigned key1, unsigned long long step,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  normals_kernel<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n, key0, key1, step);
  return (int)cudaGetLastError();
}

// out[w * n + i] = word w of philox4x32_10({i, step mod 2^32, step >> 32,
// 0}, key), i < n. out: 4 n uint32. Launches on `stream` and returns the
// launch's CUDA error code.
extern "C" int lb2d_philox_bits(unsigned* out, long long n, unsigned key0,
                                unsigned key1, unsigned long long step,
                                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_bits_kernel<<<grid_for(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(out, n, key0, key1,
                                                            step);
  return (int)cudaGetLastError();
}
