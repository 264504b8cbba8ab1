// The D2Q9 moments of a flow state for Hopper (sm_90a): rho, u and v of
// f[9][ny][nx] (float32), any subset of the three planes.
//
// Replaces no TPU kernel: the JAX package computes the moments with plain
// jnp (lb2d_tpu/ops/moments.py), which XLA fuses into one pass. It was
// added for the flow models' readout (device_field, get_fields), where the
// port's plain version (ops/moments.py: density, momentum) ran as about
// nine generic PyTorch passes over the state, wrote a 9-plane temporary
// for each velocity component and built the lattice's velocities from host
// lists, two pageable copies on which the host waited every call. Here one
// launch reads each population once, with the velocities compiled in, and
// writes only the planes asked for (a null pointer: not asked); nothing is
// copied from the host and nothing waits on the card.
//
// Bound: bytes. 36 B read and 4 B written per cell per plane asked (one
// launch per device_field): at 4096^2, 671 MB, 0.200 ms at the H100 SXM
// data sheet's 3.35 TB/s; at 3751 x 1251, 0.056 ms; at 32 x 256 the launch
// latency. One cell a thread: a warp reads 9 contiguous segments.
//
// Numerics: float32, as the plain version computes it. The directions are
// summed in direction order, as collide (pipe_cell.cuh) sums them; the
// plain version's torch.sum adds the same terms in another order, a few
// ulp of the populations' sum apart. u = jx * (1 / rho) as
// hydro_compressible computes it, or u = jx (the He-Luo incompressible
// form); only adds and one multiply, so nvcc contracts nothing into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One cell a thread: n cells, planes n floats apart. D2Q9 numbering
// cx = 0 1 0 -1 0 1 -1 -1 1, cy = 0 0 1 0 -1 1 1 -1 -1.
template <bool kIncomp>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ f, float* __restrict__ rho_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) s[j] = f[j * n + i];
  const float rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7]
                    + s[8];
  float u = s[1] - s[3] + s[5] - s[6] - s[7] + s[8];
  float v = s[2] - s[4] + s[5] + s[6] - s[7] - s[8];
  if (!kIncomp) {
    const float inv = 1.0f / rho;
    u *= inv;
    v *= inv;
  }
  if (rho_out) rho_out[i] = rho;
  if (u_out) u_out[i] = u;
  if (v_out) v_out[i] = v;
}

}  // namespace

// rho, u, v (each [cells] float32, or NULL when not asked; at least one
// asked) of f[9][cells] (float32, contiguous, distinct from the outputs);
// u = j / rho, or u = j with incompressible. Launches on `stream` and
// returns the launch's CUDA error code.
extern "C" int lb2d_moments(const float* f, float* rho, float* u, float* v,
                            long long cells, int incompressible,
                            void* stream) {
  if (cells < 1 || (cells + kThreads - 1) / kThreads > 0x7fffffffLL
      || (!rho && !u && !v))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((cells + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (incompressible)
    moments_kernel<true><<<blocks, kThreads, 0, s>>>(f, rho, u, v, cells);
  else
    moments_kernel<false><<<blocks, kThreads, 0, s>>>(f, rho, u, v, cells);
  return (int)cudaGetLastError();
}
