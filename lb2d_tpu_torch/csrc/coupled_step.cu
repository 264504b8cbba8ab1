// K7 for Hopper (sm_90a): one step of the coupled two-field families.
//
// Replaces lb2d_tpu/ops/fused_coupled.py:make_rocket_yeast_step (:105, both
// variants), make_screened_fisher_step (:202) and make_surfactant_step
// (:251, plain and clumpy), the physics closures JAX runs on K6's halo
// machinery. Its K-step VMEM sweeps and density-emit stage are TPU
// scheduling and are not carried over. Here one step is K6's density pass
// (lb2d_mc_density on F periodic fields: the post-stream rho[F][ny][nx]
// that the one-belt stencils and the spectral solve read) and one launch of
// this kernel, one thread per cell, templated on the physics:
//
// - pull each field's 9 values (periodic), its rho in direction order;
// - the velocity: rocket yeast -eps grad(surfactant) / cs^2 over the
//   neighbours' rho (forces-only: -eps grad(S) / cs^2 with S = (1 -
//   exp(-c / c_o))^alpha, plus the pressure force -G_chen grad(rho_pop) (rho
//   - rho_o) / cs^2); the screened Fisher wave and the surfactant waves read
//   it from two ext planes (the K8 solve's output, held for K steps when
//   stale_velocity = K);
// - the Shan-Chen pseudo-force -cs^2 G_chen psi sum w c psi(x + c) of the
//   population (rocket yeast, clumpy surfactant);
// - linear feq and BGK per field, growth (Fisher G rho (1 - rho), or G rho
//   n fed to the population and taken from the nutrient), production
//   Gc rho, the force term w (c . F) / cs^2, and the population clip >= 0
//   for rocket yeast only (rocket_yeast.cl:127).
//
// Bound: bytes. Per cell-step the kernel reads f (36 F B) and writes it,
// reads the ext planes (8 B) or the neighbours' rho (mostly from L1/L2),
// and the density pass reads f and writes rho (40 F B): 112 B for one
// field, 184 for two with ext, against the 72 F of one read and write of
// f. A temporally blocked kernel with a rho window in shared memory is
// later work, as for K6 (PERF.md).

#include "coupled_cell.cuh"

namespace {

constexpr int kBlock = 256;

template <int PHYS>
__global__ void __launch_bounds__(kBlock)
coupled_step_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                    const float* __restrict__ rho_buf,
                    const float* __restrict__ ext, int ny, int nx,
                    Lb2dCoupledParams p) {
  constexpr int F = PHYS == kScreenedFisher ? 1 : 2;
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= (long long)ny * nx) return;
  const int y = (int)(cell / nx), x = (int)(cell % nx);
  const size_t plane = (size_t)ny * nx;

  float s0[9], s1[9];
  pull_fluid<9, F>(f_in, 0, y, x, ny, nx, false, s0);
  float r0 = s0[0], r1 = 0.0f;
#pragma unroll
  for (int j = 1; j < 9; ++j) r0 += s0[j];
  if constexpr (F == 2) {
    pull_fluid<9, F>(f_in, 1, y, x, ny, nx, false, s1);
    r1 = s1[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) r1 += s1[j];
  }

  // the advection velocity
  float u, v;
  if constexpr (PHYS == kRocketYeast) {  // rocket_yeast.py:401-410
    float gx, gy;
    belt1_sums(rho_buf + plane, y, x, ny, nx, [](float r) { return r; }, gx,
               gy);
    u = p.neg_epsilon * (gx / kCs2);
    v = p.neg_epsilon * (gy / kCs2);
  } else if constexpr (PHYS == kRocketYeastForcesOnly) {
    // rocket_yeast_forces_only.cl:45-62, 225-316
    const float c_o = p.c_o, alpha = p.alpha;
    const int ia = p.int_alpha;
    auto surface = [c_o, alpha, ia](float r) {
      const float c = r < 0.0f ? 0.0f : r;
      const float base = 1.0f - expf(-c / c_o);
      if (ia == 0) return powf(base, alpha);
      float S = base;
      for (int k = 1; k < ia; ++k) S = S * base;
      return S;
    };
    float sx, sy, gx, gy;
    belt1_sums(rho_buf + plane, y, x, ny, nx, surface, sx, sy);
    belt1_sums(rho_buf, y, x, ny, nx, [](float r) { return r; }, gx, gy);
    const float dr = r0 - p.rho_o;
    u = p.neg_epsilon * (sx / kCs2) + (p.neg_G_chen * (gx / kCs2)) * dr;
    v = p.neg_epsilon * (sy / kCs2) + (p.neg_G_chen * (gy / kCs2)) * dr;
  } else {  // the spectral solve's planes
    u = ext[cell];
    v = ext[plane + cell];
  }

  // the pseudo-force on the population
  float Fx = 0.0f, Fy = 0.0f;
  if constexpr (PHYS == kRocketYeast || PHYS == kClumpySurfactant) {
    const float rho_o = p.rho_o;
    float fx, fy;
    belt1_sums(rho_buf, y, x, ny, nx,
               [rho_o](float r) { return psi_shan_chen(r, rho_o); }, fx, fy);
    const float pref = p.sc_pref * psi_shan_chen(r0, rho_o);
    Fx = pref * fx;
    Fy = pref * fy;
  }

  float growth, second;  // the population's source, the second field's
  if constexpr (PHYS == kRocketYeast || PHYS == kRocketYeastForcesOnly) {
    growth = p.lb_G * r0 * (1.0f - r0);
    second = p.lb_G2 * r0;
  } else if constexpr (PHYS == kScreenedFisher) {
    growth = p.lb_G * r0 * (1.0f - r0);
    second = 0.0f;
  } else {
    growth = p.lb_G * r0 * r1;
    second = -growth;
  }

#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float cx = (float)dir_cx<9>(j), cy = (float)dir_cy<9>(j);
    const float wj = p.w[j];
    const float lin = 1.0f + (cx * u + cy * v) / kCs2;
    float pop = s0[j] * p.one_minus_omega + p.omega * (wj * r0 * lin) +
                wj * growth;
    if constexpr (PHYS == kRocketYeast || PHYS == kClumpySurfactant)
      pop = pop + (wj * (cx * Fx + cy * Fy)) / kCs2;
    if constexpr (PHYS == kRocketYeast || PHYS == kRocketYeastForcesOnly)
      pop = pop < 0.0f ? 0.0f : pop;  // NaN passes, as torch.clamp
    f_out[(size_t)(j * F) * plane + cell] = pop;
    if constexpr (F == 2) {
      const float sec = s1[j] * p.one_minus_omega2 +
                        p.omega2 * (wj * r1 * lin);
      f_out[(size_t)(j * F + 1) * plane + cell] =
          PHYS == kSurfactant || PHYS == kClumpySurfactant
              ? sec - wj * growth
              : sec + wj * second;
    }
  }
}

template <int PHYS>
cudaError_t launch(const float* f_in, float* f_out, const float* rho,
                   const float* ext, int ny, int nx,
                   const Lb2dCoupledParams& p, cudaStream_t stream) {
  const long long cells = (long long)ny * nx;
  const long long blocks = (cells + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  coupled_step_kernel<PHYS><<<(unsigned)blocks, kBlock, 0, stream>>>(
      f_in, f_out, rho, ext, ny, nx, p);
  return cudaGetLastError();
}

}  // namespace

// One coupled step of f_in into f_out (both [9][F][ny][nx] float32,
// distinct; F = 1 for kScreenedFisher, else 2). rho: the post-stream
// densities [F][ny][nx] from lb2d_mc_density (read by the rocket-yeast
// variants and the clumpy surfactant, else may be NULL); ext: the velocity
// planes [2][ny][nx] (read by the screened Fisher and surfactant physics,
// else may be NULL); ny, nx >= 3. Launches on `stream` and returns the
// launch's CUDA error code.
extern "C" int lb2d_coupled_step(const float* f_in, float* f_out,
                                 const float* rho, const float* ext, int ny,
                                 int nx, Lb2dCoupledParams prm, void* stream) {
  if (ny < 3 || nx < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prm.physics) {
    case kRocketYeast:
      return (int)launch<kRocketYeast>(f_in, f_out, rho, ext, ny, nx, prm, s);
    case kRocketYeastForcesOnly:
      return (int)launch<kRocketYeastForcesOnly>(f_in, f_out, rho, ext, ny,
                                                  nx, prm, s);
    case kScreenedFisher:
      return (int)launch<kScreenedFisher>(f_in, f_out, rho, ext, ny, nx, prm,
                                          s);
    case kSurfactant:
      return (int)launch<kSurfactant>(f_in, f_out, rho, ext, ny, nx, prm, s);
    case kClumpySurfactant:
      return (int)launch<kClumpySurfactant>(f_in, f_out, rho, ext, ny, nx,
                                            prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// sizeof(Lb2dCoupledParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_coupled_params_size() {
  return (int)sizeof(Lb2dCoupledParams);
}
