// K6 for Hopper (sm_90a): one step of the multicomponent / porous engine.
//
// Replaces lb2d_tpu/ops/fused_mc.py:_make_halo_kernel as make_mc_halo_step
// (fused_mc.py:704-1053) fills it with the multicomponent physics. The TPU
// kernel is a 2K-stage software pipeline of CH-row chunks through VMEM
// rings, K steps per sweep, with its own density-emit stage; none of that is
// carried over. Here one step is two launches, both one thread per cell on
// any ny x nx (at least 3 x 3), templated on the lattice (Q = 9 or 25) and
// the number of fluids (C = 1..4), mc_density in blocks of 256 cells of a
// row, mc_step in tiles of 32 x 8 cells:
//
// - mc_density (only when an interaction is registered): each fluid's
//   post-stream, post-edge density rho[C][ny][nx], summed in direction
//   order, for the interactions' neighbour reads.
// - mc_step: pull each fluid's Q values (periodic wrap; a zero-gradient
//   fluid's edge cell pulls at its clamped interior cell), form rho_i and
//   j_i, add the force hooks in registration order (constant, g rho, the
//   precomputed ext planes and ext x rho, Shan-Chen over the first or
//   second belt with psi of the neighbours' densities, with periodic or
//   clamped neighbours: for each such hook the block evaluates psi of both
//   fluids once per cell of its tile and the belt around it into a window
//   in shared memory, read from rho in whole rows, and each cell sums its
//   belt from the window in the plain step's term order), then the Darcy +
//   Forchheimer drag last
//   and zero G where rho <= zd (porous), the barycentric velocity (no
//   guard on rho_tot), porosity feq + Guo + BGK per fluid (Guo with rho and
//   eps when porous, neither otherwise), the eating / growth collisions on
//   the post-stream rho, and write f_out. Each fluid is pulled twice, once
//   for its moments and once for its collision, so registers hold
//   3C + 2 moments and one fluid's Q values, not Q C (D2Q25 x 2 fluids).
//
// K6h runs the same two kernels on one shard of a domain-decomposed grid
// (lb2d_tpu_torch/parallel/sharded.py; the TPU kernel is itself the halo
// kernel, fused_mc.py:230 as make_mc_halo_step builds it with its halo
// chunks, 128-lane x strips and ext halos): f is the shard and its halos of
// the lattice's reach (1 row for D2Q9, 3 for D2Q25, exchanged before the
// step), read through region_source.cuh's HaloSource; mc_density writes the
// shard's band of a whole-grid rho[C][ny][nx] on its device, which every
// shard's density pass fills (and an exchange of the belt around each
// shard across devices completes) before any mc_step reads its neighbours'
// densities at their global coordinates; the ext planes are whole-grid
// planes too (the screened force, solved once per device from the source
// plane, gathered whole). Zero-gradient edges and clamped
// neighbours apply by global coordinates. The kernels are templated on the
// source, so a shard's cell runs the same code on the same values as the
// unsharded launch's and the two agree bit for bit.
//
// Bound: bytes. Per cell-step mc_density reads f (4 Q C B) and writes rho
// (4 C B); mc_step reads f and, with interactions, rho (its neighbours'
// rho mostly from L1/L2), reads the ext planes and writes f once. At
// 8192^2 with C = 2 on D2Q9 that is 80 + 152 B per cell-step against the 144
// of one read and one write of f: the density pass is the price of the
// one-step design. The psi window evaluates psi about 1.3 times per cell
// and fluid (1.7 with the second belt) where a gather per cell would take
// 8 (24), and the 32 x 8 tile lets the rows y +- 1 of f that its pulls
// read come from L1. Temporal blocking in shared memory and a single
// launch are later work.

#include "mc_cell.cuh"

namespace {

constexpr int kBlock = 256;

template <int Q, int C, bool kShard>
__global__ void __launch_bounds__(kBlock)
mc_density_kernel(const float* __restrict__ f, HaloSource halo,
                  float* __restrict__ rho, Domain d,
                  int zero_gradient_mask) {
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= (long long)d.rows * d.cols) return;
  const int y = (int)(cell / d.cols), x = (int)(cell % d.cols);
  const CellAt<kShard> at(d, y, x, cell);
  const size_t plane = (size_t)d.ny * d.nx;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float s[Q];
    pull<Q, C, kShard>(f, halo, d, i, y, x, (zero_gradient_mask >> i) & 1,
                         s);
    float r = s[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) r += s[j];
    rho[(size_t)i * plane + at.global] = r;
  }
}

// mc_step's tile: kTileX x kTileY cells, one warp per row, and a window
// of the tile plus the belts' reach (1 or 2 cells) on each side, where the
// block puts psi of both fluids of one interaction at a time
constexpr int kTileX = 32, kTileY = kBlock / kTileX;
constexpr int kMaxBelt = 2;
constexpr int kWindow = (kTileX + 2 * kMaxBelt) * (kTileY + 2 * kMaxBelt);

constexpr int kWindowPerThread = (2 * kWindow + kBlock - 1) / kBlock;

// The window of the interaction hk over the tile whose first cell is
// global cell (gy0, gx0): win[0 .. wx wy) psi of fluid a, win[wx wy .. 2
// wx wy) of fluid b (wx = kTileX + 2 reach, wy = kTileY + 2 reach), each
// neighbour wrapped (periodic) or clamped at global coordinates as the
// plain step shifts it. fetch_window reads the densities, a thread's
// kWindowPerThread reads all in flight at once (coalesced rows of rho);
// put_window evaluates psi of them into the window.
__device__ __forceinline__ void fetch_window(
    const Lb2dMcHook& hk, const float* __restrict__ rho_buf, size_t plane,
    int gy0, int gx0, int ny, int nx, float (&r)[kWindowPerThread]) {
  const int reach = hk.belt == 1 ? 1 : 2;
  const int wx = kTileX + 2 * reach, cells = wx * (kTileY + 2 * reach);
#pragma unroll
  for (int v = 0; v < kWindowPerThread; ++v) {
    const int i = threadIdx.x + v * kBlock;
    if (i < 2 * cells) {
      const int fluid = i >= cells, c = i - fluid * cells;
      const int iy = c / wx, ix = c - iy * wx;
      int yy = gy0 - reach + iy, xx = gx0 - reach + ix;
      if (hk.clamped) {
        yy = clamp_to(yy, 0, ny - 1);
        xx = clamp_to(xx, 0, nx - 1);
      } else {
        yy = wrap(yy, ny);
        xx = wrap(xx, nx);
      }
      r[v] = __ldg(rho_buf + (size_t)(fluid ? hk.b : hk.a) * plane +
                   (size_t)yy * nx + xx);
    }
  }
}

__device__ __forceinline__ void put_window(const Lb2dMcHook& hk, float zd,
                                           const float (&r)[kWindowPerThread],
                                           float* win) {
  const int reach = hk.belt == 1 ? 1 : 2;
  const int cells = (kTileX + 2 * reach) * (kTileY + 2 * reach);
#pragma unroll
  for (int v = 0; v < kWindowPerThread; ++v) {
    const int i = threadIdx.x + v * kBlock;
    if (i < 2 * cells) win[i] = psi(hk, r[v], zd);
  }
}

// The belt sums of one interaction at the cell at (ty, tx) of the tile:
// fxa += (w c_x) psi_b(x + c), ... over belt kBelt's terms of the stencil,
// in the plain step's order (terms with w c = 0 add nothing there either),
// psi read from the window put_window filled
template <int kBelt>
__device__ __forceinline__ void belt_sums(const float* win, int ty, int tx,
                                          float& fxa, float& fya, float& fxb,
                                          float& fyb) {
  constexpr int wx = kTileX + 2 * kBelt, cells = wx * (kTileY + 2 * kBelt);
  constexpr int k0 = kBelt == 1 ? 0 : 8;
  constexpr int k1 = kBelt == 1 ? 8 : kMcBeltTerms;
  const int c = (ty + kBelt) * wx + tx + kBelt;
#pragma unroll
  for (int k = k0; k < k1; ++k) {
    const int dx = belt_dx(k), dy = belt_dy(k);
    const float pa = win[c + dy * wx + dx];
    const float pb = win[cells + c + dy * wx + dx];
    if (dx != 0) {
      const float wgt = belt_w(k) * (float)dx;
      fxa += wgt * pb;
      fxb += wgt * pa;
    }
    if (dy != 0) {
      const float wgt = belt_w(k) * (float)dy;
      fya += wgt * pb;
      fyb += wgt * pa;
    }
  }
}

template <int Q, int C, bool kShard>
__global__ void __launch_bounds__(kBlock)
mc_step_kernel(const float* __restrict__ f_in, HaloSource halo,
               float* __restrict__ f_out,
               const float* __restrict__ rho_buf,
               const float* __restrict__ ext, Domain d,
               int zero_gradient_mask, Lb2dMcParams prm) {
  __shared__ float win[2 * kWindow];
  // the tile's cell (ty, tx); a thread past the domain's edge takes the
  // edge's cell (within the tile), works with the block and stores nothing
  const int bx0 = blockIdx.x * kTileX, by0 = blockIdx.y * kTileY;
  const int tx0 = threadIdx.x % kTileX, ty0 = threadIdx.x / kTileX;
  const bool live = bx0 + tx0 < d.cols && by0 + ty0 < d.rows;
  const int x = min(bx0 + tx0, d.cols - 1), y = min(by0 + ty0, d.rows - 1);
  const int tx = x - bx0, ty = y - by0;
  const long long cell = (long long)y * d.cols + x;
  const CellAt<kShard> at(d, y, x, cell);
  const int gy0 = at.gy - ty, gx0 = at.gx - tx;  // the tile's first cell
  const size_t plane = (size_t)d.ny * d.nx;  // rho's and ext's
  size_t out_plane = plane;                   // f_out's
  if constexpr (kShard) out_plane = (size_t)d.rows * d.cols;
  const float zd = prm.zero_density;

  // the first interaction's window: its densities are read here, in flight
  // while the cell pulls its populations, and put in shared memory after
  int first = -1;
  for (int h = prm.num_hooks - 1; h >= 0; --h)
    if (prm.hooks[h].kind >= kHookInteraction) first = h;
  float rw[kWindowPerThread];
  if (first >= 0)
    fetch_window(prm.hooks[first], rho_buf, plane, gy0, gx0, d.ny, d.nx, rw);

  // hydro per fluid (single_component.cl:214-274), direction order
  float rho[C], jx[C], jy[C], u[C], v[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float s[Q];
    pull<Q, C, kShard>(f_in, halo, d, i, y, x,
                         (zero_gradient_mask >> i) & 1, s);
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

  if (first >= 0) {
    put_window(prm.hooks[first], zd, rw, win);
    __syncthreads();
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
        float ex = ext[(size_t)(2 * hk.ext_pair) * plane + at.global];
        float ey = ext[(size_t)(2 * hk.ext_pair + 1) * plane + at.global];
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
        if (h != first) {
          __syncthreads();  // every cell is done with the last window
          fetch_window(hk, rho_buf, plane, gy0, gx0, d.ny, d.nx, rw);
          put_window(hk, zd, rw, win);
          __syncthreads();
        }
        float fxa = 0.0f, fya = 0.0f, fxb = 0.0f, fyb = 0.0f;
        if (hk.belt == 1)
          belt_sums<1>(win, ty, tx, fxa, fya, fxb, fyb);
        else
          belt_sums<2>(win, ty, tx, fxa, fya, fxb, fyb);
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
    pull<Q, C, kShard>(f_in, halo, d, i, y, x,
                         (zero_gradient_mask >> i) & 1, s);
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
      if (live) f_out[(size_t)(j * C + i) * out_plane + cell] = out;
    }
  }
}

template <int Q, int C, bool kShard>
cudaError_t launch(const float* f, const HaloSource& halo, float* f_out,
                   float* rho, const float* ext, const Domain& d,
                   int zero_gradient_mask, const Lb2dMcParams* prm,
                   cudaStream_t stream) {
  const long long cells = (long long)d.rows * d.cols;
  const long long blocks = (cells + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (prm == nullptr) {
    mc_density_kernel<Q, C, kShard><<<(unsigned)blocks, kBlock, 0, stream>>>(
        f, halo, rho, d, zero_gradient_mask);
  } else {
    const dim3 tiles((d.cols + kTileX - 1) / kTileX,
                     (d.rows + kTileY - 1) / kTileY);
    if (tiles.y > 65535) return cudaErrorInvalidValue;
    mc_step_kernel<Q, C, kShard><<<tiles, kBlock, 0, stream>>>(
        f, halo, f_out, rho, ext, d, zero_gradient_mask, *prm);
  }
  return cudaGetLastError();
}

// prm == nullptr: mc_density into rho; else mc_step. The grid's f (d
// covers the grid, halo unused) or, kShard, the shard of halo.
template <bool kShard>
cudaError_t dispatch(int q, int fluids, const float* f,
                     const HaloSource& halo, float* f_out, float* rho,
                     const float* ext, const Domain& d,
                     int zero_gradient_mask, const Lb2dMcParams* prm,
                     void* stream) {
  if (d.ny < 3 || d.nx < 3 || d.rows < 1 || d.cols < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LB2D_MC(Q, C)                                                    \
  if (q == Q && fluids == C)                                             \
    return launch<Q, C, kShard>(f, halo, f_out, rho, ext, d,             \
                                zero_gradient_mask, prm, s);
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

bool bad_params(const Lb2dMcParams& prm) {
  return prm.num_hooks < 0 || prm.num_hooks > kMcMaxHooks ||
         prm.num_collisions < 0 || prm.num_collisions > kMcMaxCollisions;
}

// A shard's source and domain; valid when its halo covers the lattice's
// reach (1 for D2Q9, 3 for D2Q25) and the shard lies in the grid
bool shard(const float* f, const float* top, const float* bot,
           const float* left, const float* right, int H, int W, int hk,
           int y0, int x0, int ny, int nx, int q, HaloSource& halo,
           Domain& d) {
  halo = HaloSource{f, top, bot, left, right, H, W, hk};
  d = Domain{H, W, y0, x0, ny, nx};
  const int reach = q == 25 ? 3 : 1;
  const bool x_wraps = left == nullptr && right == nullptr;
  return hk >= reach && H >= 1 && W >= 1 && y0 >= 0 && x0 >= 0 &&
         y0 + H <= ny && x0 + W <= nx && (!x_wraps || (x0 == 0 && W == nx)) &&
         (left == nullptr) == (right == nullptr);
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
  return (int)dispatch<false>(q, fluids, f, HaloSource{}, nullptr, rho,
                              nullptr, Domain{ny, nx, 0, 0, ny, nx},
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
  if (bad_params(prm)) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false>(q, fluids, f_in, HaloSource{}, f_out,
                              const_cast<float*>(rho), ext,
                              Domain{ny, nx, 0, 0, ny, nx},
                              zero_gradient_mask, &prm, stream);
}

// K6h's density pass: the shard f[q][fluids][H][W] (global rows [y0, y0 +
// H), columns [x0, x0 + W) of an ny x nx grid) with its hk-cell halos top,
// bot [q fluids][hk][W] and, unless the shard spans the grid's width (both
// NULL), left, right [q fluids][H + 2hk][hk]; writes the shard's band of
// each fluid's post-stream density into the whole-grid rho[fluids][ny][nx].
// hk is at least the lattice's reach. Otherwise as lb2d_mc_density.
extern "C" int lb2d_mc_halo_density(const float* f, const float* top,
                                    const float* bot, const float* left,
                                    const float* right, float* rho, int H,
                                    int W, int hk, int y0, int x0, int ny,
                                    int nx, int q, int fluids,
                                    int zero_gradient_mask, void* stream) {
  HaloSource halo;
  Domain d;
  if (!shard(f, top, bot, left, right, H, W, hk, y0, x0, ny, nx, q, halo, d))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<true>(q, fluids, f, halo, nullptr, rho, nullptr, d,
                             zero_gradient_mask, nullptr, stream);
}

// K6h's step: one step of the shard (pieces as lb2d_mc_halo_density) into
// f_out [q][fluids][H][W]; rho and ext are whole-grid planes ([fluids][ny]
// [nx] and [2 pairs][ny][nx]) read at the cells' global coordinates.
// Otherwise as lb2d_mc_step.
extern "C" int lb2d_mc_halo_step(const float* f, const float* top,
                                 const float* bot, const float* left,
                                 const float* right, float* f_out,
                                 const float* rho, const float* ext, int H,
                                 int W, int hk, int y0, int x0, int ny,
                                 int nx, int q, int fluids,
                                 int zero_gradient_mask, Lb2dMcParams prm,
                                 void* stream) {
  HaloSource halo;
  Domain d;
  if (bad_params(prm) ||
      !shard(f, top, bot, left, right, H, W, hk, y0, x0, ny, nx, q, halo, d))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<true>(q, fluids, f, halo, f_out,
                             const_cast<float*>(rho), ext, d,
                             zero_gradient_mask, &prm, stream);
}

// sizeof(Lb2dMcParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_mc_params_size() {
  return (int)sizeof(Lb2dMcParams);
}
