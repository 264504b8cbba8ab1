// K9: K D2Q9 steps of one shard of a domain-decomposed grid from its halos,
// for Hopper (sm_90a), with the physics of K2: the row sweep of
// temporal_sweep.cuh on region_source.cuh's HaloSource (that header says
// how). K9's multifield physics are in multifield_step.cu.

#include "temporal_sweep.cuh"

namespace {

template <int kPhys, bool kIncomp, bool kObstacle>
cudaError_t halo_launch(const HaloSource& src, const int* mask, float* f_out,
                        const Domain& d, int K, const StepParams& prm,
                        cudaStream_t stream) {
  static SweepSlots cache;  // per instantiation
  return launch_sweep<kObstacle>(
      halo_sweep_kernel<kPhys, kIncomp, kObstacle>, cache, d.rows, d.cols, K,
      prm, stream, src, mask, f_out, d);
}

template <int kPhys>
cudaError_t halo_dispatch(const HaloSource& src, const int* mask,
                          float* f_out, const Domain& d, int K,
                          const StepParams& prm, int incompressible,
                          cudaStream_t s) {
  if (incompressible) {
    return mask ? halo_launch<kPhys, true, true>(src, mask, f_out, d, K, prm, s)
                : halo_launch<kPhys, true, false>(src, mask, f_out, d, K, prm, s);
  }
  return mask ? halo_launch<kPhys, false, true>(src, mask, f_out, d, K, prm, s)
              : halo_launch<kPhys, false, false>(src, mask, f_out, d, K, prm, s);
}

}  // namespace

// K9: k_steps steps of one shard f[9][H][W], global rows [y0, y0 + H) and
// columns [x0, x0 + W) of an ny x nx grid, into f_out[9][H][W], from its
// halos (region_source.cuh: HaloSource): top, bot [9][hk][W]; left, right
// [9][H + 2hk][hk], or both NULL when W == nx (x wraps within the shard).
// mask: the obstacle mask of the region [H + 2hk][W + 2hk], or NULL.
// physics: 0 pressure-driven flow (a, b = inlet, outlet rho), 1 velocity
// inlet with the zero-gradient outlet, 2 with the velocity outlet (a, b =
// u_w, u_e), 3 diffusion, 4 noisy Fisher (a, b = u, v; g, dg, key, step0 as
// lb2d_temporal_diffusion_step). 1 <= k_steps <= min(sweep_max_k<1>() (8),
// hk). Launches on `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_halo_step(const float* f, const float* top,
                              const float* bot, const float* left,
                              const float* right, const int* mask,
                              float* f_out, int H, int W, int hk, int y0,
                              int x0, int ny, int nx, int k_steps,
                              int physics, int incompressible, float omega,
                              float a, float b, float g, float dg,
                              unsigned key0, unsigned key1,
                              unsigned long long step0, void* stream) {
  if (H < 1 || W < 1 || hk < 1 || k_steps < 1 ||
      k_steps > sweep_max_k<1>() || k_steps > hk ||
      (left == nullptr) != (right == nullptr) ||
      (left == nullptr && W != nx) || y0 < 0 || y0 + H > ny || x0 < 0 ||
      x0 + W > nx || (physics == kVelocityOpen && nx < 2))
    return (int)cudaErrorInvalidValue;
  const HaloSource src = {f, top, bot, left, right, H, W, hk};
  const Domain d = {H, W, y0, x0, ny, nx};
  const StepParams prm = {omega, a, b, g, dg, key0, key1, step0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (physics) {
    case kFlow:
      return (int)halo_dispatch<kFlow>(src, mask, f_out, d, k_steps, prm,
                                       incompressible, s);
    case kVelocityOpen:
      return (int)halo_dispatch<kVelocityOpen>(src, mask, f_out, d, k_steps,
                                               prm, incompressible, s);
    case kVelocityPair:
      return (int)halo_dispatch<kVelocityPair>(src, mask, f_out, d, k_steps,
                                               prm, incompressible, s);
    case kDiffusion:
      return (int)halo_launch<kDiffusion, false, false>(src, nullptr, f_out,
                                                        d, k_steps, prm, s);
    case kNoisyFisher:
      return (int)halo_launch<kNoisyFisher, false, false>(src, nullptr, f_out,
                                                          d, k_steps, prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
