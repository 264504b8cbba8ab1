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
// K7h runs the same kernel on one shard of a domain-decomposed grid
// (lb2d_tpu_torch/parallel/sharded.py:ShardedCoupled): f is the shard and
// its one-cell halos (HaloSource, region_source.cuh), rho and the velocity
// planes are whole-grid planes on the shard's device (the density pass of
// every shard fills rho, K8 solves once per device from it), read at the
// cells' global coordinates, as K6h does (mc_step.cu); a shard's cells
// agree with the unsharded launch's bit for bit.
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

template <int PHYS, bool kShard>
__global__ void __launch_bounds__(kBlock)
coupled_step_kernel(const float* __restrict__ f_in, HaloSource halo,
                    float* __restrict__ f_out,
                    const float* __restrict__ rho_buf,
                    const float* __restrict__ ext, Domain d,
                    Lb2dCoupledParams p) {
  constexpr int F = PHYS == kScreenedFisher ? 1 : 2;
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= (long long)d.rows * d.cols) return;
  const int y = (int)(cell / d.cols), x = (int)(cell % d.cols);
  const CellAt<kShard> at(d, y, x, cell);
  const int gy = at.gy, gx = at.gx, ny = d.ny, nx = d.nx;
  const size_t plane = (size_t)ny * nx;  // rho's and ext's
  size_t out_plane = plane;               // f_out's
  if constexpr (kShard) out_plane = (size_t)d.rows * d.cols;

  float s0[9], s1[9];
  pull<9, F, kShard>(f_in, halo, d, 0, y, x, false, s0);
  float r0 = s0[0], r1 = 0.0f;
#pragma unroll
  for (int j = 1; j < 9; ++j) r0 += s0[j];
  if constexpr (F == 2) {
    pull<9, F, kShard>(f_in, halo, d, 1, y, x, false, s1);
    r1 = s1[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) r1 += s1[j];
  }

  // the advection velocity
  float u, v;
  if constexpr (PHYS == kRocketYeast) {  // rocket_yeast.py:401-410
    float grx, gry;
    belt1_sums(rho_buf + plane, gy, gx, ny, nx, [](float r) { return r; },
               grx, gry);
    u = p.neg_epsilon * (grx / kCs2);
    v = p.neg_epsilon * (gry / kCs2);
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
    float sx, sy, grx, gry;
    belt1_sums(rho_buf + plane, gy, gx, ny, nx, surface, sx, sy);
    belt1_sums(rho_buf, gy, gx, ny, nx, [](float r) { return r; }, grx, gry);
    const float dr = r0 - p.rho_o;
    u = p.neg_epsilon * (sx / kCs2) + (p.neg_G_chen * (grx / kCs2)) * dr;
    v = p.neg_epsilon * (sy / kCs2) + (p.neg_G_chen * (gry / kCs2)) * dr;
  } else {  // the spectral solve's planes
    u = ext[at.global];
    v = ext[plane + at.global];
  }

  // the pseudo-force on the population
  float Fx = 0.0f, Fy = 0.0f;
  if constexpr (PHYS == kRocketYeast || PHYS == kClumpySurfactant) {
    const float rho_o = p.rho_o;
    float fx, fy;
    belt1_sums(rho_buf, gy, gx, ny, nx,
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
    f_out[(size_t)(j * F) * out_plane + cell] = pop;
    if constexpr (F == 2) {
      const float sec = s1[j] * p.one_minus_omega2 +
                        p.omega2 * (wj * r1 * lin);
      f_out[(size_t)(j * F + 1) * out_plane + cell] =
          PHYS == kSurfactant || PHYS == kClumpySurfactant
              ? sec - wj * growth
              : sec + wj * second;
    }
  }
}

template <int PHYS, bool kShard>
cudaError_t launch(const float* f_in, const HaloSource& halo, float* f_out,
                   const float* rho, const float* ext, const Domain& d,
                   const Lb2dCoupledParams& p, cudaStream_t stream) {
  const long long cells = (long long)d.rows * d.cols;
  const long long blocks = (cells + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  coupled_step_kernel<PHYS, kShard><<<(unsigned)blocks, kBlock, 0, stream>>>(
      f_in, halo, f_out, rho, ext, d, p);
  return cudaGetLastError();
}

template <bool kShard>
cudaError_t dispatch(const float* f_in, const HaloSource& halo, float* f_out,
                     const float* rho, const float* ext, const Domain& d,
                     const Lb2dCoupledParams& prm, void* stream) {
  if (d.ny < 3 || d.nx < 3 || d.rows < 1 || d.cols < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prm.physics) {
#define LB2D_COUPLED(PHYS)                                               \
  case PHYS:                                                             \
    return launch<PHYS, kShard>(f_in, halo, f_out, rho, ext, d, prm, s);
    LB2D_COUPLED(kRocketYeast)
    LB2D_COUPLED(kRocketYeastForcesOnly)
    LB2D_COUPLED(kScreenedFisher)
    LB2D_COUPLED(kSurfactant)
    LB2D_COUPLED(kClumpySurfactant)
#undef LB2D_COUPLED
    default:
      return cudaErrorInvalidValue;
  }
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
  return (int)dispatch<false>(f_in, HaloSource{}, f_out, rho, ext,
                              Domain{ny, nx, 0, 0, ny, nx}, prm, stream);
}

// K7h: one coupled step of a shard f [9 F][H][W] (global rows [y0, y0 + H),
// columns [x0, x0 + W) of an ny x nx grid) with its hk >= 1 cell halos top,
// bot [9 F][hk][W] and, unless the shard spans the grid's width (both
// NULL), left, right [9 F][H + 2hk][hk], into f_out [9 F][H][W]; rho and
// ext are whole-grid planes ([F][ny][nx], [2][ny][nx]) read at the cells'
// global coordinates. Otherwise as lb2d_coupled_step.
extern "C" int lb2d_coupled_halo_step(const float* f, const float* top,
                                      const float* bot, const float* left,
                                      const float* right, float* f_out,
                                      const float* rho, const float* ext,
                                      int H, int W, int hk, int y0, int x0,
                                      int ny, int nx, Lb2dCoupledParams prm,
                                      void* stream) {
  const bool x_wraps = left == nullptr && right == nullptr;
  if (hk < 1 || H < 1 || W < 1 || y0 < 0 || x0 < 0 || y0 + H > ny ||
      x0 + W > nx || (x_wraps && (x0 != 0 || W != nx)) ||
      (left == nullptr) != (right == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<true>(f, HaloSource{f, top, bot, left, right, H, W, hk},
                             f_out, rho, ext, Domain{H, W, y0, x0, ny, nx},
                             prm, stream);
}

// sizeof(Lb2dCoupledParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_coupled_params_size() {
  return (int)sizeof(Lb2dCoupledParams);
}
