// The per-cell pieces of K7, the coupled families' step (coupled_step.cu):
// the launch's constants and the one-belt stencil sums.
//
// The state is f[9][F][ny][nx] (plane j * F + i is direction j of field i;
// F = 1 for the screened Fisher wave, 2 otherwise: population and
// surfactant or nutrient), K6's layout, so K6's pull (mc_cell.cuh) and its
// density pass serve. Every expression follows the plain PyTorch steps
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

// The constants of one coupled_step launch, passed by value (ctypes mirror:
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

constexpr float kCs2 = (float)(1.0 / 3.0);  // the plain steps divide by it
// w_j of the D2Q9 moving directions j = 1..8, in lattice order
__device__ __forceinline__ float w9(int j) {
  return j < 5 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0);
}

// sum over j = 1..8 of w_j c_j v(x + c_j) with periodic neighbours, v =
// value(plane[neighbour]); the plain steps' order (stencil_gradient,
// pseudo_force: one term per direction, the zero-c terms adding nothing).
template <typename Value>
__device__ __forceinline__ void belt1_sums(const float* __restrict__ plane,
                                           int y, int x, int ny, int nx,
                                           Value value, float& sx,
                                           float& sy) {
  sx = 0.0f;
  sy = 0.0f;
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    const int cx = dir_cx<9>(j), cy = dir_cy<9>(j);
    const float v =
        value(plane[(size_t)wrap1(y + cy, ny) * nx + wrap1(x + cx, nx)]);
    if (cx != 0) sx += (w9(j) * (float)cx) * v;
    if (cy != 0) sy += (w9(j) * (float)cy) * v;
  }
}

// psi = rho_o (1 - exp(-max(r, 0) / rho_o))
// (surfactant_nutrient_waves.cl:242-260)
__device__ __forceinline__ float psi_shan_chen(float r, float rho_o) {
  const float c = r < 0.0f ? 0.0f : r;
  return rho_o * (1.0f - expf(-c / rho_o));
}

}  // namespace
