// The per-cell pieces of K7, the coupled families' K-step row sweep
// (coupled_step.cu): the launch's constants, each physics' traits, the
// density stage's values, the one-belt sums and the update.
//
// The state is f[9][F][ny][nx] (plane j * F + i is direction j of field i;
// F = 1 for the screened Fisher wave, 2 otherwise: population and
// surfactant or nutrient), K4's layout, so K4's rings and pulls
// (row_sweep.cuh) serve. Every expression follows the plain PyTorch steps
// (lb2d_tpu_torch/ops/fused_coupled.py:*_step_reference, JAX's XLA steps)
// term by term, with the constants rounded once to float32 on the host
// (fused_coupled.py:coupled_params). No fast math: expf and IEEE division
// as PyTorch's CUDA ops call them; with nvcc's FMA contraction, results
// differ from the plain steps by a few ulp.

#pragma once

#include "mc_cell.cuh"

// Lb2dCoupledParams.physics
constexpr int kRocketYeast = 0;  // rocket_yeast.cl:74-151, :233-399
constexpr int kRocketYeastForcesOnly = 1;  // rocket_yeast_forces_only.cl
constexpr int kScreenedFisher = 2;  // screened_poisson_waves.py:373-387
constexpr int kSurfactant = 3;  // surfactant_nutrient_waves.cl:74-128
constexpr int kClumpySurfactant = 4;  // + :130-199, :242-364

// The constants of one coupled launch, passed by value (ctypes mirror:
// lb2d_tpu_torch/ops/_build.py:CoupledParams; the two change together).
// omega / omega2: the population's and the second field's (surfactant c or
// nutrient n); lb_G: growth, lb_G2: the surfactant's production;
// neg_epsilon = -epsilon; sc_pref = -cs^2 G_chen (the pseudo-force);
// neg_G_chen = -G_chen (the forces-only pressure force); rho_o, c_o and
// alpha of the pseudopotential and the surface tension; int_alpha: alpha
// is an integer 1..4 (multiplied out, as JAX's kernel does); w: the D2Q9
// weights.
struct Lb2dCoupledParams {
  int physics;
  float omega, one_minus_omega, omega2, one_minus_omega2;
  float lb_G, lb_G2, neg_epsilon, rho_o, sc_pref, neg_G_chen, c_o, alpha;
  int int_alpha;
  float w[9];
};

namespace {

// F: fields; kBelt: the step reads its neighbours' post-stream densities
// (1) or only its own and the ext velocity planes (0)
template <int PHYS>
struct CoupledTraits {
  static constexpr int F = PHYS == kScreenedFisher ? 1 : 2;
  static constexpr bool kRocket =
      PHYS == kRocketYeast || PHYS == kRocketYeastForcesOnly;
  static constexpr int kBelt = kRocket || PHYS == kClumpySurfactant ? 1 : 0;
  static constexpr bool kForce =
      PHYS == kRocketYeast || PHYS == kClumpySurfactant;
};

constexpr float kCs2 = (float)(1.0 / 3.0);  // the plain steps divide by it
// w_j of the D2Q9 moving directions j = 1..8, in lattice order
__device__ __forceinline__ float w9(int j) {
  return j < 5 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0);
}

// psi = rho_o (1 - exp(-max(r, 0) / rho_o))
// (surfactant_nutrient_waves.cl:242-260)
__device__ __forceinline__ float psi_shan_chen(float r, float rho_o) {
  const float c = r < 0.0f ? 0.0f : r;
  return rho_o * (1.0f - expf(-c / rho_o));
}

// S = (1 - exp(-max(c, 0) / c_o))^alpha (rocket_yeast_forces_only.cl:45-62)
__device__ __forceinline__ float surface_tension(float r,
                                                 const Lb2dCoupledParams& p) {
  const float c = r < 0.0f ? 0.0f : r;
  const float base = 1.0f - expf(-c / p.c_o);
  if (p.int_alpha == 0) return powf(base, p.alpha);
  float S = base;
  for (int k = 1; k < p.int_alpha; ++k) S = S * base;
  return S;
}

// The density stage's third value of a cell, whose belt sums the update
// takes: psi of the population (rocket yeast, clumpy surfactant) or S of
// the surfactant (forces only), once per cell
template <int PHYS>
__device__ __forceinline__ float density_aux(float r0, float r1,
                                             const Lb2dCoupledParams& p) {
  if constexpr (PHYS == kRocketYeastForcesOnly) return surface_tension(r1, p);
  return psi_shan_chen(r0, p.rho_o);
}

// sum over j = 1..8 of w_j c_j v(x + c_j) of one plane, from the rows
// y + 1 (next), y and y - 1 (prev), each pointer at the cell's column; the
// plain steps' order (stencil_gradient, pseudo_force: one term per
// direction, the zero-c terms adding nothing)
__device__ __forceinline__ void belt_sums(const float* next, const float* own,
                                          const float* prev, float& sx,
                                          float& sy) {
  sx = 0.0f;
  sy = 0.0f;
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    const int cx = dir_cx<9>(j), cy = dir_cy<9>(j);
    const float v = (cy > 0 ? next : cy < 0 ? prev : own)[cx];
    if (cx != 0) sx += (w9(j) * (float)cx) * v;
    if (cy != 0) sy += (w9(j) * (float)cy) * v;
  }
}

// The update of one cell from its pulls s0 (population) and s1, their
// densities, the advection velocity (u, v) and the pseudo-force (Fx, Fy):
// linear feq and BGK per field, growth (Fisher G rho (1 - rho), or G rho n
// fed to the population and taken from the nutrient), production Gc rho,
// the force term w (c . F) / cs^2, and the population clip >= 0 for the
// rocket yeasts only (rocket_yeast.cl:127); put(j, i, value) stores
// direction j of field i.
template <int PHYS, class Put>
__device__ __forceinline__ void coupled_update(
    const float (&s0)[9], const float (&s1)[9], float r0, float r1, float u,
    float v, float Fx, float Fy, const Lb2dCoupledParams& p, const Put& put) {
  using T = CoupledTraits<PHYS>;
  float growth, second;  // the population's source, the second field's
  if constexpr (T::kRocket) {
    growth = p.lb_G * r0 * (1.0f - r0);
    second = p.lb_G2 * r0;
  } else if constexpr (PHYS == kScreenedFisher) {
    growth = p.lb_G * r0 * (1.0f - r0);
    second = 0.0f;
  } else {
    growth = p.lb_G * r0 * r1;
    second = -growth;
  }
  // the quotients (c . u) / cs^2 and w (c . F) / cs^2; directions 3, 4, 7,
  // 8 take those of their opposites 1, 2, 5, 6 negated (c, the sum and the
  // quotient negate exactly), the plain step's values bit for bit with half
  // its IEEE divisions
  float qu[9], qf[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float cx = (float)dir_cx<9>(j), cy = (float)dir_cy<9>(j);
    if (j == 3 || j == 4 || j == 7 || j == 8) {
      qu[j] = -qu[j - 2];
      if constexpr (T::kForce) qf[j] = -qf[j - 2];
    } else {
      qu[j] = (cx * u + cy * v) / kCs2;
      if constexpr (T::kForce) qf[j] = (p.w[j] * (cx * Fx + cy * Fy)) / kCs2;
    }
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float wj = p.w[j];
    const float lin = 1.0f + qu[j];
    float pop = s0[j] * p.one_minus_omega + p.omega * (wj * r0 * lin) +
                wj * growth;
    if constexpr (T::kForce) pop = pop + qf[j];
    if constexpr (T::kRocket) pop = pop < 0.0f ? 0.0f : pop;  // NaN passes
    put(j, 0, pop);
    if constexpr (T::F == 2) {
      const float sec = s1[j] * p.one_minus_omega2 +
                        p.omega2 * (wj * r1 * lin);
      put(j, 1, T::kRocket ? sec + wj * second : sec - wj * growth);
    }
  }
}

}  // namespace
