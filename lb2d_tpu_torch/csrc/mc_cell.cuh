// The per-cell pieces of K6, the multicomponent / porous step (mc_step.cu):
// the launch's constants, the lattices' velocity tables, the pull of one
// fluid's populations and the Shan-Chen pseudopotentials.
//
// The state is f[Q][C][ny][nx] (plane j * C + i is direction j of fluid i,
// the TPU kernel's f[q C][H][nx], lb2d_tpu/ops/fused_mc.py:734). Every
// expression follows the plain PyTorch step
// (lb2d_tpu_torch/ops/fused_mc.py:mc_step_reference) term by term, with
// its constants rounded once to float32 on the host
// (lb2d_tpu_torch/ops/fused_mc.py:_mc_params), except that the feq and Guo
// terms multiply by the reciprocals of their six denominators where the
// plain step divides (as the JAX kernel does, fused_mc.py:926-934): a
// division is a multi-instruction sequence, and 110 of them per cell made
// the step bound by instruction throughput. No fast math otherwise: IEEE
// division for the velocities and forces, expf/powf/sqrtf as PyTorch's
// CUDA ops call them.
// With the reciprocals and nvcc's FMA contraction, results differ from the
// plain step by a few ulp.
//
// A launch covers the whole periodic grid (K6, K7: the populations f, read
// through the grid's wrap) or one shard of a domain-decomposed grid (K6h,
// K7h: a HaloSource, region_source.cuh, whose halo is at least the
// lattice's reach). Either way a cell's post-stream density, its
// neighbours' densities and its ext planes are read at its global
// coordinates from whole-grid planes, so a shard's cells go through the
// same per-cell code, on the same values, as the unsharded launch's.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "region_source.cuh"

constexpr int kMcMaxFluids = 4;
constexpr int kMcMaxHooks = 16;
constexpr int kMcMaxCollisions = 8;
constexpr int kMcBeltTerms = 32;  // 8 first-belt + 24 two-belt terms

// Lb2dMcHook.kind
constexpr int kHookConstForce = 0;  // G_a += (p[0], p[1])
constexpr int kHookConstG = 1;      // G_a += (p[0], p[1]) rho_a
constexpr int kHookExt = 2;         // G_a += ext planes 2 ext_pair, +1
constexpr int kHookExtRho = 3;      // the same times rho_a
constexpr int kHookInteraction = 4; // Shan-Chen between fluids a and b
// Lb2dMcHook.spec: the pseudopotential (single_component.cl:609-651)
constexpr int kPsiLinear = 0;
constexpr int kPsiShanChen = 1;     // p[1] = rho_0
constexpr int kPsiPow = 2;          // p[1] = exponent
constexpr int kPsiVdw = 3;          // p[1..4] = a, b, T, cs^2
// Lb2dMcCollision.kind
constexpr int kCollEating = 0;
constexpr int kCollGrowth = 1;

// One force hook, in registration order (ctypes mirror:
// lb2d_tpu_torch/ops/_build.py:McHook).
struct Lb2dMcHook {
  int kind, a, b;
  int spec, belt, clamped, ext_pair;
  float p[5];  // const: force or g; interaction: -G, then the psi parameters
};

// One collision hook (ctypes mirror: _build.py:McCollision).
struct Lb2dMcCollision {
  int kind, a, b;
  float lo, hi, rate;
};

// The constants of one mc_step launch, passed by value (ctypes mirror:
// lb2d_tpu_torch/ops/_build.py:McParams; the two change together). Per
// fluid: omega, 1 - omega, the Guo prefactor 1 - omega / 2, the
// reciprocals of the feq denominators 2 cs^4 eps and 2 cs^2 eps and of the
// Guo denominators cs^4 eps and cs^2 eps (cs^4 and cs^2 without porosity),
// and the drag's eps, eps nu_f, K, eps Fe, sqrt(K); w: the lattice weights;
// inv_cs2: 1 / cs^2.
struct Lb2dMcParams {
  float omega[kMcMaxFluids], one_minus_omega[kMcMaxFluids];
  float guo_pref[kMcMaxFluids];
  float inv_feq_cu2[kMcMaxFluids], inv_feq_usq[kMcMaxFluids];
  float inv_guo_cu[kMcMaxFluids], inv_guo_uf[kMcMaxFluids];
  float eps[kMcMaxFluids], drag_lin[kMcMaxFluids], K[kMcMaxFluids];
  float drag_fe[kMcMaxFluids], sqrt_K[kMcMaxFluids];
  float w[25];
  float inv_cs2, zero_density;
  int porous, num_hooks, num_collisions;
  Lb2dMcHook hooks[kMcMaxHooks];
  Lb2dMcCollision coll[kMcMaxCollisions];
};

namespace {

// Velocity j of the lattice: D2Q9 (lb2d_tpu_torch/core/lattice.py:78-84) or
// D2Q25 (:87-122), in the lattices' direction order. Called with j known at
// compile time (unrolled loops), so the tables fold away.
template <int Q>
__device__ __forceinline__ int dir_cx(int j) {
  if constexpr (Q == 9) {
    constexpr int t[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
    return t[j];
  } else {
    constexpr int t[25] = {0, 0,  0, 1,  -1, 1,  1,  -1, -1, 3,  -3, 0, 0,
                           1, 1, -1, -1, 3,  3,  -3, -3, 3,  3,  -3, -3};
    return t[j];
  }
}

template <int Q>
__device__ __forceinline__ int dir_cy(int j) {
  if constexpr (Q == 9) {
    constexpr int t[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
    return t[j];
  } else {
    constexpr int t[25] = {0, 1, -1, 0, 0,  1, -1, 1, -1, 0, 0,  3, -3,
                           3, -3, 3, -3, 1, -1, 1, -1, 3, -3, 3, -3};
    return t[j];
  }
}

// The interaction stencils, in the order of the plain step: terms 0-7 the
// D2Q9 moving vectors (belt 1 on every lattice, multi.py:517-529), 8-31 the
// two-belt stencil (single_component.py:533-646). The weight of term k times
// its c is belt_w(k) * c exactly (c is 0, +-1 or +-2), the float32 rounding
// of the plain step's double (wgt * c). Called with k known at compile time
// (mc_step's unrolled belt sums read psi from a shared-memory window, so no
// pseudopotential is inlined per term), so the tables fold away.
__device__ __forceinline__ int belt_dx(int k) {
  constexpr int t[kMcBeltTerms] = {
      1, 0, -1, 0, 1, -1, -1, 1,
      1, 0, -1, 0, 1, -1, -1, 1,
      2, 0, -2, 0, 2, 2, 1, -1, -2, -2, -1, 1, 2, -2, -2, 2};
  return t[k];
}

__device__ __forceinline__ int belt_dy(int k) {
  constexpr int t[kMcBeltTerms] = {
      0, 1, 0, -1, 1, 1, -1, -1,
      0, 1, 0, -1, 1, 1, -1, -1,
      0, 2, 0, -2, -1, 1, 2, 2, 1, -1, -2, -2, 2, 2, -2, -2};
  return t[k];
}

__device__ __forceinline__ float belt_w(int k) {
  constexpr float t[kMcBeltTerms] = {
      (float)(1.0 / 9.0), (float)(1.0 / 9.0), (float)(1.0 / 9.0),
      (float)(1.0 / 9.0), (float)(1.0 / 36.0), (float)(1.0 / 36.0),
      (float)(1.0 / 36.0), (float)(1.0 / 36.0),
      (float)(4.0 / 63.0), (float)(4.0 / 63.0), (float)(4.0 / 63.0),
      (float)(4.0 / 63.0), (float)(4.0 / 135.0), (float)(4.0 / 135.0),
      (float)(4.0 / 135.0), (float)(4.0 / 135.0),
      (float)(1.0 / 180.0), (float)(1.0 / 180.0), (float)(1.0 / 180.0),
      (float)(1.0 / 180.0),
      (float)(2.0 / 945.0), (float)(2.0 / 945.0), (float)(2.0 / 945.0),
      (float)(2.0 / 945.0), (float)(2.0 / 945.0), (float)(2.0 / 945.0),
      (float)(2.0 / 945.0), (float)(2.0 / 945.0),
      (float)(1.0 / 15120.0), (float)(1.0 / 15120.0), (float)(1.0 / 15120.0),
      (float)(1.0 / 15120.0)};
  return t[k];
}

// v mod n for v in [-n, 2n)
__device__ __forceinline__ int wrap1(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ int clamp_to(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The Q values that fluid i of cell (y, x) holds after the periodic stream
// and, for a zero-gradient fluid, the edge copy: an edge cell takes all the
// values of its adjacent interior cell, a corner those of the diagonal one
// (single_component.cl:417-519), so it pulls at the clamped cell
// (min(max(y, 1), ny - 2), same for x). Needs ny, nx >= 3.
template <int Q, int C>
__device__ __forceinline__ void pull_fluid(const float* __restrict__ f, int i,
                                           int y, int x, int ny, int nx,
                                           bool zero_gradient, float (&s)[Q]) {
  if (zero_gradient) {
    y = clamp_to(y, 1, ny - 2);
    x = clamp_to(x, 1, nx - 2);
  }
  const size_t plane = (size_t)ny * nx;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int r = wrap1(y - dir_cy<Q>(j), ny);
    const int c = wrap1(x - dir_cx<Q>(j), nx);
    s[j] = f[(size_t)(j * C + i) * plane + (size_t)r * nx + c];
  }
}

// The same pull for cell (y, x) of a shard (global cell (d.y0 + y, d.x0 +
// x)): a zero-gradient fluid's clamp by global coordinates, as a shift of
// the local cell toward the grid's interior, then the Q reads, which stay
// within the lattice's reach of the shard (a shard on the grid's edge
// receives the opposite shard's rows, which are what the wrap reads). A
// cell whose stencil lies in the shard itself, nearly every one, reads it
// directly; the others go through the halo source's pieces.
template <int Q, int C>
__device__ __forceinline__ void pull_fluid(const HaloSource& src,
                                           const Domain& d, int i, int y,
                                           int x, bool zero_gradient,
                                           float (&s)[Q]) {
  if (zero_gradient) {
    const int gy = d.y0 + y, gx = d.x0 + x;
    y += clamp_to(gy, 1, d.ny - 2) - gy;
    x += clamp_to(gx, 1, d.nx - 2) - gx;
  }
  constexpr int kReach = Q == 25 ? 3 : 1;
  if (y >= kReach && y < src.H - kReach && x >= kReach &&
      x < src.W - kReach) {
    const size_t plane = (size_t)src.H * src.W;
    const float* f = src.f + (size_t)i * plane + (size_t)y * src.W + x;
#pragma unroll
    for (int j = 0; j < Q; ++j)
      s[j] = __ldg(f + (size_t)(j * C) * plane -
                   (ptrdiff_t)dir_cy<Q>(j) * src.W - dir_cx<Q>(j));
    return;
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    size_t plane;
    const float* p = src.at(y - dir_cy<Q>(j), x - dir_cx<Q>(j), plane);
    s[j] = p[(size_t)(j * C + i) * plane];
  }
}

// pull_fluid for the launch's source: the whole grid f (d covers it;
// halo unused) or, kShard, the shard of halo
template <int Q, int C, bool kShard>
__device__ __forceinline__ void pull(const float* __restrict__ f,
                                     const HaloSource& halo, const Domain& d,
                                     int i, int y, int x, bool zero_gradient,
                                     float (&s)[Q]) {
  if constexpr (kShard)
    pull_fluid<Q, C>(halo, d, i, y, x, zero_gradient, s);
  else
    pull_fluid<Q, C>(f, i, y, x, d.ny, d.nx, zero_gradient, s);
}

// A launch's cell (y, x) of its d.rows x d.cols cells: its global
// coordinates and its index in a whole-grid plane (the cell itself for
// the grid)
template <bool kShard>
struct CellAt {
  int gy, gx;
  size_t global;
  __device__ __forceinline__ CellAt(const Domain& d, int y, int x,
                                    long long cell) {
    if constexpr (kShard) {
      gy = d.y0 + y;
      gx = d.x0 + x;
      global = (size_t)gy * d.nx + gx;
    } else {
      gy = y;
      gx = x;
      global = (size_t)cell;
    }
  }
};

// The pseudopotential of density r (single_component.cl:609-651), as
// lb2d_tpu_torch/models/multicomponent.py:get_psi writes it.
__device__ __forceinline__ float psi(const Lb2dMcHook& hk, float r,
                                     float zd) {
  switch (hk.spec) {
    case kPsiLinear:
      return r;
    case kPsiShanChen:
      return hk.p[1] * (1.0f - expf(-r / hk.p[1]));
    case kPsiPow:  // where(r > zd, max(r, zd)^a, 0)
      return r > zd ? powf(r, hk.p[1]) : 0.0f;
    default: {  // vdw
      const float P = (r * hk.p[3]) / (1.0f - r * hk.p[2]) - hk.p[1] * r * r;
      const float s = (2.0f * (P - hk.p[4] * r)) / hk.p[4];
      return sqrtf(s < 0.0f ? 0.0f : s);  // NaN passes, as torch.clamp
    }
  }
}

// arr[a] for a fluid index known only at run time, without dynamic indexing
// (which would move the array to local memory)
template <int C>
__device__ __forceinline__ float pick(const float (&arr)[C], int a) {
  float v = arr[0];
#pragma unroll
  for (int k = 1; k < C; ++k)
    if (a == k) v = arr[k];
  return v;
}

template <int C>
__device__ __forceinline__ void add_at(float (&arr)[C], int a, float v) {
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (a == k) arr[k] += v;
}

}  // namespace
