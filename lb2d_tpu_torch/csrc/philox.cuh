// Counter-based Philox4x32-10 and Box-Muller on the card: the noise of the
// stochastic kernels (temporal_step.cu, resident_run.cu) and of P1
// (normals.cu).
//
// Replaces the TPU's on-core PRNG (pltpu.prng_seed + prng_random_bits +
// Box-Muller, lb2d_tpu/ops/fused.py:273-302), which the TPU kernels reseed
// per (sweep, chunk, stage), so that their noise depends on how the kernel
// is cut. Here the normal of cell (y, x) at global step `step` is a pure
// function of (key, step, cell):
//   bits = philox4x32_10({cell, step mod 2^32, step >> 32, 0}, key)
//   eta  = sqrt(-2 log u1) cos(2 pi u2), u1, u2 from the top 24 bits of
//          bits.x, bits.y (u1 offset by half a step, in (0, 1])
// with cell = y * nx + x, the wrapped global index. A K2 block that
// recomputes a neighbour's halo cell draws that cell's own normal, and K2
// at any K, K3 and the plain version (lb2d_tpu_torch/ops/random.py, the
// same bits) follow one trajectory.
//
// Numerics: no fast math. The bits are exact; logf, sqrtf and cosf round
// differently from torch's CPU and CUDA kernels by an ulp or two.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kPhiloxM0 = 0xD2511F53u;
constexpr unsigned kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned kPhiloxW1 = 0xBB67AE85u;

// Random123's philox4x32_10: 10 rounds, the key bumped before rounds 2-10.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The cos branch of the JAX kernels' Box-Muller (fused.py:273-292).
__device__ __forceinline__ float box_muller(unsigned b1, unsigned b2) {
  constexpr float kScale = 1.0f / 16777216.0f;  // 2^-24
  const float u1 = (float)(b1 >> 8) * kScale + 0.5f * kScale;  // exact
  const float u2 = (float)(b2 >> 8) * kScale;
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf((float)(2.0 * 3.14159265358979323846) * u2);
}

// The standard normal of `cell` at global step `step` under key (k0, k1).
__device__ __forceinline__ float cell_normal(unsigned long long cell,
                                             unsigned long long step,
                                             unsigned k0, unsigned k1) {
  const uint4 b = philox4x32_10(
      make_uint4((unsigned)cell, (unsigned)step, (unsigned)(step >> 32), 0u),
      k0, k1);
  return box_muller(b.x, b.y);
}

}  // namespace
