// K6 for Hopper (sm_90a): one step of the multicomponent / porous engine.
//
// Replaces lb2d_tpu/ops/fused_mc.py:_make_halo_kernel as make_mc_halo_step
// (fused_mc.py:704-1053) fills it with the multicomponent physics. The TPU
// kernel is a 2K-stage software pipeline of CH-row chunks through VMEM
// rings, K steps per sweep, with its own density-emit stage; none of that is
// carried over. Here one step is two launches, both one thread per cell on
// any ny x nx (at least 3 x 3), templated on the lattice (Q = 9 or 25) and
// the number of fluids (C = 1..4):
//
// - mc_density (only when an interaction is registered): each fluid's
//   post-stream, post-edge density rho[C][ny][nx], summed in direction
//   order, for the interactions' neighbour reads.
// - mc_step: pull each fluid's Q values (periodic wrap; a zero-gradient
//   fluid's edge cell pulls at its clamped interior cell), form rho_i and
//   j_i, add the force hooks in registration order (constant, g rho, the
//   precomputed ext planes and ext x rho, Shan-Chen over the first or
//   second belt with psi of the neighbours' densities read from rho, with
//   periodic or clamped neighbours), then the Darcy + Forchheimer drag last
//   and zero G where rho <= zd (porous), the barycentric velocity (no
//   guard on rho_tot), porosity feq + Guo + BGK per fluid (Guo with rho and
//   eps when porous, neither otherwise), the eating / growth collisions on
//   the post-stream rho, and write f_out. Each fluid is pulled twice, once
//   for its moments and once for its collision, so registers hold
//   3C + 2 moments and one fluid's Q values, not Q C (D2Q25 x 2 fluids).
//
// Bound: bytes. Per cell-step mc_density reads f (4 Q C B) and writes rho
// (4 C B); mc_step reads f and, with interactions, rho (its neighbours'
// rho mostly from L1/L2), reads the ext planes and writes f once. At
// 8192^2 with C = 2 on D2Q9 that is 80 + 152 B per cell-step against the 144
// of one read and one write of f: the density pass is the price of the
// one-step design. On an H100 (700 W) mc_density runs at 1.08x its byte
// bound and mc_step at 2.2x, held by the interactions' gather of the
// neighbours' rho (PERF.md). Temporal blocking in shared memory and a
// single launch with a rho window in shared memory are later work.

#include "mc_cell.cuh"

namespace {

constexpr int kBlock = 256;

template <int Q, int C>
__global__ void __launch_bounds__(kBlock)
mc_density_kernel(const float* __restrict__ f, float* __restrict__ rho,
                  int ny, int nx, int zero_gradient_mask) {
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= (long long)ny * nx) return;
  const int y = (int)(cell / nx), x = (int)(cell % nx);
  const size_t plane = (size_t)ny * nx;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float s[Q];
    pull_fluid<Q, C>(f, i, y, x, ny, nx, (zero_gradient_mask >> i) & 1, s);
    float r = s[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) r += s[j];
    rho[(size_t)i * plane + cell] = r;
  }
}

// The belt sums of one interaction at cell (y, x): fxa += (w c_x) psi_b(x +
// c), ... over the stencil's terms [k0, k1), in the plain step's order
// (terms with w c = 0 add nothing there either).
__device__ __forceinline__ void belt_sums(
    const Lb2dMcHook& hk, float zd, const float* __restrict__ rho_a,
    const float* __restrict__ rho_b, int y, int x, int ny, int nx, float& fxa,
    float& fya, float& fxb, float& fyb) {
  const int k0 = hk.belt == 1 ? 0 : 8;
  const int k1 = hk.belt == 1 ? 8 : kMcBeltTerms;
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const int dx = kBeltDx[k], dy = kBeltDy[k];
    const int yy = hk.clamped ? clamp_to(y + dy, 0, ny - 1) : wrap(y + dy, ny);
    const int xx = hk.clamped ? clamp_to(x + dx, 0, nx - 1) : wrap(x + dx, nx);
    const size_t nb = (size_t)yy * nx + xx;
    const float pa = psi(hk, rho_a[nb], zd);
    const float pb = psi(hk, rho_b[nb], zd);
    if (dx != 0) {
      const float wx = kBeltW[k] * (float)dx;
      fxa += wx * pb;
      fxb += wx * pa;
    }
    if (dy != 0) {
      const float wy = kBeltW[k] * (float)dy;
      fya += wy * pb;
      fyb += wy * pa;
    }
  }
}

template <int Q, int C>
__global__ void __launch_bounds__(kBlock)
mc_step_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
               const float* __restrict__ rho_buf,
               const float* __restrict__ ext, int ny, int nx,
               int zero_gradient_mask, Lb2dMcParams prm) {
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= (long long)ny * nx) return;
  const int y = (int)(cell / nx), x = (int)(cell % nx);
  const size_t plane = (size_t)ny * nx;
  const float zd = prm.zero_density;

  // hydro per fluid (single_component.cl:214-274), direction order
  float rho[C], jx[C], jy[C], u[C], v[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float s[Q];
    pull_fluid<Q, C>(f_in, i, y, x, ny, nx, (zero_gradient_mask >> i) & 1, s);
    float r = s[0], ax = 0.0f, ay = 0.0f;
#pragma unroll
    for (int j = 1; j < Q; ++j) {
      r += s[j];
      if (dir_cx<Q>(j) != 0) ax += (float)dir_cx<Q>(j) * s[j];
      if (dir_cy<Q>(j) != 0) ay += (float)dir_cy<Q>(j) * s[j];
    }
    rho[i] = r;
    jx[i] = ax;
    jy[i] = ay;
    const bool good = r > zd;
    u[i] = good ? ax / r : 0.0f;
    v[i] = good ? ay / r : 0.0f;
  }

  // the force hooks in registration order
  float Gx[C], Gy[C];
#pragma unroll
  for (int i = 0; i < C; ++i) Gx[i] = Gy[i] = 0.0f;
  for (int h = 0; h < prm.num_hooks; ++h) {
    const Lb2dMcHook& hk = prm.hooks[h];
    switch (hk.kind) {
      case kHookConstForce:
        add_at<C>(Gx, hk.a, hk.p[0]);
        add_at<C>(Gy, hk.a, hk.p[1]);
        break;
      case kHookConstG: {
        const float ra = pick<C>(rho, hk.a);
        add_at<C>(Gx, hk.a, hk.p[0] * ra);
        add_at<C>(Gy, hk.a, hk.p[1] * ra);
        break;
      }
      case kHookExt:
      case kHookExtRho: {
        float ex = ext[(size_t)(2 * hk.ext_pair) * plane + cell];
        float ey = ext[(size_t)(2 * hk.ext_pair + 1) * plane + cell];
        if (hk.kind == kHookExtRho) {
          const float ra = pick<C>(rho, hk.a);
          ex = ex * ra;
          ey = ey * ra;
        }
        add_at<C>(Gx, hk.a, ex);
        add_at<C>(Gy, hk.a, ey);
        break;
      }
      default: {  // Shan-Chen (single_component.cl:652-793, :795-967)
        const float* rho_a = rho_buf + (size_t)hk.a * plane;
        const float* rho_b = rho_buf + (size_t)hk.b * plane;
        float fxa = 0.0f, fya = 0.0f, fxb = 0.0f, fyb = 0.0f;
        belt_sums(hk, zd, rho_a, rho_b, y, x, ny, nx, fxa, fya, fxb, fyb);
        const float ra = pick<C>(rho, hk.a), rb = pick<C>(rho, hk.b);
        const float sa = hk.p[0] * psi(hk, ra, zd);  // -G psi_a
        const float sb = hk.p[0] * psi(hk, rb, zd);
        // force -> force per density, zero-density guarded (:779-792)
        add_at<C>(Gx, hk.a, ra > zd ? (sa * fxa) / ra : 0.0f);
        add_at<C>(Gy, hk.a, ra > zd ? (sa * fya) / ra : 0.0f);
        add_at<C>(Gx, hk.b, rb > zd ? (sb * fxb) / rb : 0.0f);
        add_at<C>(Gy, hk.b, rb > zd ? (sb * fyb) / rb : 0.0f);
        break;
      }
    }
  }

  // Darcy + Forchheimer drag, applied last (single_component.cl:276-335)
  if (prm.porous) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float gx = Gx[i] * prm.eps[i] - (prm.drag_lin[i] * u[i]) / prm.K[i];
      float gy = Gy[i] * prm.eps[i] - (prm.drag_lin[i] * v[i]) / prm.K[i];
      const float vel = sqrtf(u[i] * u[i] + v[i] * v[i]);
      gx = gx - (prm.drag_fe[i] * vel * u[i]) / prm.sqrt_K[i];
      gy = gy - (prm.drag_fe[i] * vel * v[i]) / prm.sqrt_K[i];
      const bool good = rho[i] > zd;
      Gx[i] = good ? gx : 0.0f;
      Gy[i] = good ? gy : 0.0f;
    }
  }

  // barycentric velocity (single_component.cl:161-212), no guard on rho_tot
  float rho_tot = rho[0], sjx = jx[0], sjy = jy[0];
  float sgx = rho[0] * Gx[0] / 2.0f, sgy = rho[0] * Gy[0] / 2.0f;
#pragma unroll
  for (int i = 1; i < C; ++i) {
    rho_tot += rho[i];
    sjx += jx[i];
    sjy += jy[i];
    sgx += rho[i] * Gx[i] / 2.0f;
    sgy += rho[i] * Gy[i] / 2.0f;
  }
  const float ub = (sjx + sgx) / rho_tot;
  const float vb = (sjy + sgy) / rho_tot;
  const float usq = ub * ub + vb * vb;

  // porosity feq (:39-60) + Guo (:104-113 / multi.cl:115-126) + BGK, then
  // the collisions (:120-159, multi.cl:182-220) on the post-stream rho
  const float inv_cs2 = prm.inv_cs2;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float s[Q];
    pull_fluid<Q, C>(f_in, i, y, x, ny, nx, (zero_gradient_mask >> i) & 1, s);
    const float usq_term = usq * prm.inv_feq_usq[i];
    const float uF_term = (Gx[i] * ub + Gy[i] * vb) * prm.inv_guo_uf[i];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float cx = (float)dir_cx<Q>(j), cy = (float)dir_cy<Q>(j);
      const float cu = cx * ub + cy * vb;
      const float wr = prm.w[j] * rho[i];
      const float feq = wr * (1.0f + cu * inv_cs2 +
                              cu * cu * prm.inv_feq_cu2[i] - usq_term);
      const float cF = cx * Gx[i] + cy * Gy[i];
      const float base = (prm.porous ? wr : prm.w[j]) * prm.guo_pref[i];
      const float Fi = base * (cF * inv_cs2 + cF * cu * prm.inv_guo_cu[i] -
                               uF_term);
      float out = s[j] * prm.one_minus_omega[i] + prm.omega[i] * feq + Fi;
      for (int c = 0; c < prm.num_collisions; ++c) {
        const Lb2dMcCollision& col = prm.coll[c];
        if (col.kind == kCollEating) {
          if (col.a != i && col.b != i) continue;
          const float g = prm.w[j] * (col.rate * pick<C>(rho, col.a) *
                                      pick<C>(rho, col.b));
          if (col.a == i) out += g;
          if (col.b == i) out += -g;
        } else if (col.a == i) {
          const float r = rho[i];
          out += prm.w[j] * (r > col.lo && r < col.hi ? col.rate : 0.0f);
        }
      }
      f_out[(size_t)(j * C + i) * plane + cell] = out;
    }
  }
}

template <int Q, int C>
cudaError_t launch(const float* f_in, float* f_out, float* rho,
                   const float* ext, int ny, int nx, int zero_gradient_mask,
                   const Lb2dMcParams* prm, cudaStream_t stream) {
  const long long cells = (long long)ny * nx;
  const long long blocks = (cells + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (prm == nullptr)
    mc_density_kernel<Q, C><<<(unsigned)blocks, kBlock, 0, stream>>>(
        f_in, rho, ny, nx, zero_gradient_mask);
  else
    mc_step_kernel<Q, C><<<(unsigned)blocks, kBlock, 0, stream>>>(
        f_in, f_out, rho, ext, ny, nx, zero_gradient_mask, *prm);
  return cudaGetLastError();
}

// prm == nullptr: mc_density into rho; else mc_step
cudaError_t dispatch(int q, int fluids, const float* f_in, float* f_out,
                     float* rho, const float* ext, int ny, int nx,
                     int zero_gradient_mask, const Lb2dMcParams* prm,
                     void* stream) {
  if (ny < 3 || nx < 3) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LB2D_MC(Q, C)                                                     \
  if (q == Q && fluids == C)                                              \
    return launch<Q, C>(f_in, f_out, rho, ext, ny, nx, zero_gradient_mask, \
                        prm, s);
  LB2D_MC(9, 1)
  LB2D_MC(9, 2)
  LB2D_MC(9, 3)
  LB2D_MC(9, 4)
  LB2D_MC(25, 1)
  LB2D_MC(25, 2)
  LB2D_MC(25, 3)
  LB2D_MC(25, 4)
#undef LB2D_MC
  return cudaErrorInvalidValue;
}

}  // namespace

// Each fluid's post-stream density of f[q][fluids][ny][nx] into
// rho[fluids][ny][nx] (float32, contiguous); bit i of zero_gradient_mask
// marks fluid i's zero-gradient edges. q is 9 or 25, 1 <= fluids <= 4,
// ny, nx >= 3. Launches on `stream` and returns the launch's CUDA error
// code.
extern "C" int lb2d_mc_density(const float* f, float* rho, int ny, int nx,
                               int q, int fluids, int zero_gradient_mask,
                               void* stream) {
  return (int)dispatch(q, fluids, f, nullptr, rho, nullptr, ny, nx,
                       zero_gradient_mask, nullptr, stream);
}

// One multicomponent step of f_in into f_out (both [q][fluids][ny][nx],
// distinct). rho: the post-stream densities from lb2d_mc_density (read
// only by interaction hooks, else may be NULL); ext: the planes of the ext
// hooks ([2 pairs][ny][nx], else NULL); prm: the hooks and constants.
// Arguments and result otherwise as lb2d_mc_density.
extern "C" int lb2d_mc_step(const float* f_in, float* f_out, const float* rho,
                            const float* ext, int ny, int nx, int q,
                            int fluids, int zero_gradient_mask,
                            Lb2dMcParams prm, void* stream) {
  if (prm.num_hooks < 0 || prm.num_hooks > kMcMaxHooks ||
      prm.num_collisions < 0 || prm.num_collisions > kMcMaxCollisions)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, fluids, f_in, f_out, const_cast<float*>(rho), ext,
                       ny, nx, zero_gradient_mask, &prm, stream);
}

// sizeof(Lb2dMcParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_mc_params_size() {
  return (int)sizeof(Lb2dMcParams);
}
