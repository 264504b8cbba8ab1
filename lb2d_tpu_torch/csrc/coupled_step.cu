// K7 for Hopper (sm_90a): K steps of the coupled two-field families per
// launch, as a row sweep with the post-stream density pass inside.
//
// Replaces lb2d_tpu/ops/fused_coupled.py:make_rocket_yeast_step (:105, both
// variants), make_screened_fisher_step (:202) and make_surfactant_step
// (:251, plain and clumpy), the physics closures JAX runs on K6's halo
// machinery (lb2d_tpu/ops/fused_mc.py:648), which fuse K steps per HBM
// sweep. Here K4's row sweep (row_sweep.cuh, multifield_step.cu) carries
// them: a block sweeps a strip of columns (W = 64 at F = 2, 128 at F = 1)
// down a segment of rows, the next input row's 9F planes arriving by
// cp.async while each level s = 1..K computes one row from the ring of the
// level below, and the last level writes f_out. A block has W / kCols
// threads per level, each computing kCols cells of its level's row a phase
// (coupled_cols below: one cell a thread for the physics with a density
// stage, two otherwise; K4's 256 threads of two cells each, half of them
// idle below K = 8, left the SM short of warps for this heavier update,
// 0.148 ms a step for rocket yeast at 1024^2 and K = 8).
// A level's cell:
//
// - pulls each field's 9 values from the ring below, its density the sum
//   in direction order;
// - takes the velocity: rocket yeast -eps grad(surfactant) / cs^2 over the
//   neighbours' densities (forces-only: -eps grad(S) / cs^2 with S = (1 -
//   exp(-c / c_o))^alpha, plus the pressure force -G_chen grad(rho_pop)
//   (rho - rho_o) / cs^2); the screened Fisher wave and the surfactant
//   waves read it from two ext planes at the cell's global coordinates (the
//   K8 solve's output, held for the launch's K steps: stale_velocity);
// - the Shan-Chen pseudo-force -cs^2 G_chen psi sum w c psi(x + c) of the
//   population (rocket yeast, clumpy surfactant);
// - and updates (coupled_cell.cuh: coupled_update).
//
// The physics that read the neighbours' densities (both rocket yeasts, the
// clumpy surfactant: kBelt) put a density stage between two levels: at
// phase t level s first computes the post-stream densities of row
// t - 4s + 2 of its input and the third value of each cell (psi of the
// population, or S of the surfactant: one expf per cell, where the
// one-step kernel below takes one per neighbour, eight) into a ring
// of four rows, then updates row t - 4s from the ring's rows around it and
// its own pulls. So a level lags four phases behind the one below (two for
// the others, as K4), a step reaches two cells (one) and a launch of K
// steps reads a halo of 2K (K) cells on each side of its strip and
// segment; each input row is still read once, one barrier a phase.
//
// K7h is the same kernel on one shard of a domain-decomposed grid
// (lb2d_tpu_torch/parallel/sharded.py:ShardedCoupled): its rows load
// through region_source.cuh's HaloSource from the shard and its halos of
// at least the launch's reach, every cell with its global coordinates, so
// a shard's cells agree with the whole grid's launch bit for bit.
//
// A K-step launch equals K one-step launches bit for bit: every level runs
// the same arithmetic on the same values.
//
// Shared memory: the rings of levels 0..K-1, (9 lag + 9) ring rows of F
// planes of the strip per level (lag 2 or 4) and 9 more prefetched at the
// input, and with kBelt the density rings, 4 rows of F + 1 planes per
// level: 4 ((45 K + 9) F W + 12 K W) bytes, 213.5 KB at F = 2, W = 64, K = 8
// (one block per SM), 109.1 KB at K = 4 (two); 4 (27 K + 9) F W otherwise,
// as K4: 115.2 KB at K = 8.
// Bound: per cell-step 72F / K B of HBM (f read and written once a launch)
// and 8 B of ext for the spectral physics, times W / (W - 2 reach K) for the
// strip's halo; the work, each cell's update and density stage, computed
// (W / (W - 2 reach K)) (1 + 2 reach K / segment) times over. The design
// moves the bound from the one-step kernel's bytes (72F, the density pass's
// 40F and the neighbours' densities each step) to the work at K = 4-8.

#include <type_traits>

#include "coupled_cell.cuh"
#include "region_source.cuh"
#include "row_sweep.cuh"

namespace {

constexpr int kDensitySlots = 4;  // rows of a density ring: y + 1, y, y - 1
                                  // read while the next one is written

template <int PHYS>
__host__ __device__ constexpr int coupled_reach() {
  return 1 + CoupledTraits<PHYS>::kBelt;
}

template <int PHYS>
__host__ __device__ constexpr int coupled_lag() {
  return 2 + 2 * CoupledTraits<PHYS>::kBelt;
}

template <int PHYS>
__host__ __device__ constexpr int density_planes() {
  return CoupledTraits<PHYS>::kBelt ? CoupledTraits<PHYS>::F + 1 : 0;
}

template <int PHYS>
__host__ __device__ constexpr int coupled_smem(int K) {
  constexpr int F = CoupledTraits<PHYS>::F, W = strip_width<F>();
  constexpr int L = coupled_lag<PHYS>();
  return ((sweep_level_rows(true, L) + (K - 1) * sweep_level_rows(false, L)) *
              F * W +
          K * kDensitySlots * density_planes<PHYS>() * W) *
         (int)sizeof(float);
}

template <int PHYS>
__host__ __device__ constexpr int coupled_max_k() {
  int k = kSweepMaxK;
  while (k > 1 && coupled_smem<PHYS>(k) > kSmemPerBlock) --k;
  return k;
}

// A block has W / kCols threads per level, each thread kCols cells of its
// level's row (kSpan = W / kCols apart) a phase: one for the physics with
// a density stage, two otherwise (K4's; one cell a thread lost 27% at the
// screened Fisher wave's K = 4, two lost 20% at rocket yeast's; PERF.md,
// section 6). The register budget is set for one block per SM at
// the most threads (K = 8), two for the physics without a belt at F = 2,
// whose K = 8 rings fit twice.
template <int PHYS>
__host__ __device__ constexpr int coupled_cols() {
  return CoupledTraits<PHYS>::kBelt ? 1 : 2;
}

template <int PHYS>
__host__ __device__ constexpr int coupled_span() {
  return strip_width<CoupledTraits<PHYS>::F>() / coupled_cols<PHYS>();
}

template <int PHYS>
__host__ __device__ constexpr int coupled_min_blocks() {
  return CoupledTraits<PHYS>::kBelt || CoupledTraits<PHYS>::F == 1 ? 1 : 2;
}

// The ring offsets (in floats) of phase t, levels lagging L phases: the
// input ring's group rows the row issued at phase t goes to (ld); the group
// rows a level's update pulls from, written L - 1 + g phases ago, from the
// input ring (rd_in) or a level ring (rd); those its density stage pulls
// from, written 1 + g phases ago (dd_in, dd); and the group rows a level
// writes (wr).
template <int P, int L>
struct CoupledPhase {
  static constexpr int kRow = P * strip_width<P>();
  int ld[3], rd_in[3], rd[3], dd_in[3], dd[3], wr[3];

  __device__ __forceinline__ explicit CoupledPhase(int t) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int din = sweep_depth(g, true, L), dl = sweep_depth(g, false, L);
      const int bin = sweep_group_base(g, true, L);
      const int bl = sweep_group_base(g, false, L);
      // t + depth - lag >= 1: no remainder of a negative number
      ld[g] = (bin + 3 * ((t + kPrefetch) % din)) * kRow;
      rd_in[g] = (bin + 3 * ((t - (L - 1) - g + din) % din)) * kRow;
      rd[g] = (bl + 3 * ((t - (L - 1) - g + dl) % dl)) * kRow;
      dd_in[g] = (bin + 3 * ((t - 1 - g + din) % din)) * kRow;
      dd[g] = (bl + 3 * ((t - 1 - g + dl) % dl)) * kRow;
      wr[g] = (bl + 3 * (t % dl)) * kRow;
    }
  }
};

__device__ __forceinline__ float density_of(const float (&s)[9]) {
  float r = s[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) r += s[j];
  return r;
}

// K steps of the domain d, whose cells come from src (region_source.cuh):
// the whole periodic grid (K7) or a shard and its halos (K7h), into
// f_out[9F][d.rows][d.cols], cut into the work items of `plan` (strip
// blockIdx.x, segment blockIdx.y); ext: the velocity planes [2][ny][nx]
// (the spectral physics). Domain cell (y, x) is global cell
// (wrap(d.y0 + y, d.ny), wrap(d.x0 + x, d.nx)).
template <int PHYS, class Src>
__global__ void __launch_bounds__(coupled_span<PHYS>() * kSweepMaxK,
                                  coupled_min_blocks<PHYS>())
coupled_sweep_kernel(Src src, float* __restrict__ f_out,
                     const float* __restrict__ ext, Domain d, int K,
                     SweepPlan plan, Lb2dCoupledParams p) {
  using T = CoupledTraits<PHYS>;
  constexpr int F = T::F, B = T::kBelt;
  constexpr int R = coupled_reach<PHYS>(), L = coupled_lag<PHYS>();
  constexpr int W = strip_width<F>();
  constexpr int kPlanes = 9 * F;
  constexpr int kLevel = sweep_level_rows(false, L) * F * W;
  constexpr int kDRow = density_planes<PHYS>() * W;
  extern __shared__ float smem[];
  float* const ring_in = smem;
  float* const rings = smem + sweep_level_rows(true, L) * F * W;  // 1..K-1
  float* const dens = rings + (K - 1) * kLevel;  // kBelt: levels 1..K

  const int halo = R * K;
  const int xs = blockIdx.x * plan.wo, ys = blockIdx.y * plan.seg;
  const int width = min(plan.wo, d.cols - xs) + 2 * halo;  // region columns
  const int rows = min(plan.seg, d.rows - ys);             // rows written
  const int inputs = rows + 2 * halo;                      // input rows
  const int y0 = ys - halo;  // domain row of the first input row
  const size_t out_plane = (size_t)d.rows * d.cols;
  const size_t ext_plane = (size_t)d.ny * d.nx;

  // the thread's level s and columns c + i kSpan; of each input row it
  // loads columns cl, cl + threads, ... (two where the block of kSpan K
  // threads is narrower than the strip) and of each its planes lane, lane +
  // lanes, ... (lanes threads per column)
  constexpr int kCols = coupled_cols<PHYS>(), kSpan = coupled_span<PHYS>();
  static_assert(!B || kCols == 1, "the density stage takes one column");
  const int threads = kSpan * K;
  const int c = threadIdx.x % kSpan, s = 1 + threadIdx.x / kSpan;
  const int cl = threadIdx.x % W, lane = threadIdx.x / W;
  const int lanes = threads < W ? 1 : threads / W;
  const int spread = threads < W ? W / threads : 1;
  int gx[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    gx[i] = wrap(d.x0 + xs - halo + c + i * kSpan, d.nx);

  auto issue = [&](int t, const int (&ld)[3]) {  // the input row of phase t
    if (t < inputs && lane < lanes) {
      for (int k = 0; k < spread; ++k) {
        const int col = cl + k * threads;
        if (col >= width) continue;
        size_t stride;
        const float* q0 = src.at(y0 + t, xs - halo + col, stride);
        for (int q = lane; q < kPlanes; q += lanes)
          cp_async4(ring_in + sweep_load_offset<F>(q, ld) + col,
                    q0 + q * stride);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kPrefetch; ++t)
    issue(t, CoupledPhase<F, L>(t - kPrefetch).ld);

  int row_t = wrap(d.y0 + y0, d.ny);  // global row of phase t's input row
  const int phases = rows + (R + L) * K;
  const bool first = s == 1;
  const float* in = first ? ring_in : rings + (s - 2) * kLevel;
  float* const dlev = dens + (s - 1) * kDensitySlots * kDRow;
  const int lo = R * (s - 1) + 1;  // the density stage's first row, column
  for (int t = 0; t < phases; ++t) {
    const CoupledPhase<F, L> ph(t);
    issue(t + kPrefetch, ph.ld);
    if constexpr (B) {  // the density stage: row t - L s + 2 of the input
      const int dr = t - L * s + 2;
      if (dr >= lo && dr < inputs - lo && c >= lo && c < width - lo) {
        float* const out = dlev + (t % kDensitySlots) * kDRow + c;
        const RingPull<F> pull = {in + (first ? ph.dd_in[0] : ph.dd[0]) + c,
                                  in + (first ? ph.dd_in[1] : ph.dd[1]) + c,
                                  in + (first ? ph.dd_in[2] : ph.dd[2]) + c};
        float sv[9];
        pull(0, sv);
        const float r0 = density_of(sv);
        pull(1, sv);
        const float r1 = density_of(sv);
        out[0] = r0;
        out[W] = r1;
        out[2 * W] = density_aux<PHYS>(r0, r1, p);
      }
    }
    const int ur = t - L * s;  // the level's row in the region
    if (ur >= R * s && ur < inputs - R * s) {
      int gy = row_t - L * s;
      if (gy < 0) gy = wrap(gy, d.ny);
      const float* g0 = in + (first ? ph.rd_in[0] : ph.rd[0]);
      const float* g1 = in + (first ? ph.rd_in[1] : ph.rd[1]);
      const float* g2 = in + (first ? ph.rd_in[2] : ph.rd[2]);
      // the density ring's rows y + 1, y, y - 1, written 1, 2, 3 phases ago
      const float* dnext = dlev + ((t + 3) % kDensitySlots) * kDRow;
      const float* down = dlev + ((t + 2) % kDensitySlots) * kDRow;
      const float* dprev = dlev + ((t + 1) % kDensitySlots) * kDRow;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int ci = c + i * kSpan;
        if (ci < R * s || ci >= width - R * s) continue;
        const RingPull<F> pull = {g0 + ci, g1 + ci, g2 + ci};
        float s0[9], s1[9];
        pull(0, s0);
        float r0, r1 = 0.0f;
        if constexpr (F == 2) pull(1, s1);
        if constexpr (B) {
          r0 = down[ci];
          r1 = down[W + ci];
        } else {
          r0 = density_of(s0);
          if constexpr (F == 2) r1 = density_of(s1);
        }
        float u, v, Fx = 0.0f, Fy = 0.0f;
        if constexpr (PHYS == kRocketYeast) {  // rocket_yeast.py:401-410
          float grx, gry;
          belt_sums(dnext + W + ci, down + W + ci, dprev + W + ci, grx, gry);
          u = p.neg_epsilon * (grx / kCs2);
          v = p.neg_epsilon * (gry / kCs2);
        } else if constexpr (PHYS == kRocketYeastForcesOnly) {
          // rocket_yeast_forces_only.cl:45-62, 225-316
          float sx, sy, grx, gry;
          belt_sums(dnext + 2 * W + ci, down + 2 * W + ci, dprev + 2 * W + ci,
                    sx, sy);
          belt_sums(dnext + ci, down + ci, dprev + ci, grx, gry);
          const float dr = r0 - p.rho_o;
          u = p.neg_epsilon * (sx / kCs2) +
              (p.neg_G_chen * (grx / kCs2)) * dr;
          v = p.neg_epsilon * (sy / kCs2) +
              (p.neg_G_chen * (gry / kCs2)) * dr;
        } else {  // the spectral solve's planes
          const size_t at = (size_t)gy * d.nx + gx[i];
          u = __ldg(ext + at);
          v = __ldg(ext + ext_plane + at);
        }
        if constexpr (T::kForce) {  // the pseudo-force on the population
          float fx, fy;
          belt_sums(dnext + 2 * W + ci, down + 2 * W + ci, dprev + 2 * W + ci,
                    fx, fy);
          const float pref = p.sc_pref * down[2 * W + ci];
          Fx = pref * fx;
          Fy = pref * fy;
        }
        if (s == K) {
          const GlobalPut<F> put = {
              f_out + (size_t)(y0 + ur) * d.cols + (xs - halo + ci),
              out_plane};
          coupled_update<PHYS>(s0, s1, r0, r1, u, v, Fx, Fy, p, put);
        } else {
          float* o = rings + (s - 1) * kLevel + ci;
          const RingPut<F> put = {o + ph.wr[0], o + ph.wr[1], o + ph.wr[2]};
          coupled_update<PHYS>(s0, s1, r0, r1, u, v, Fx, Fy, p, put);
        }
      }
    }
    cp_async_wait<kPrefetch>();  // the row of phase t has landed
    __syncthreads();
    row_t = row_t + 1 == d.ny ? 0 : row_t + 1;
  }
}

// K7's first design, one step a launch, kept for the screened families at
// K = 1, where
// the solve's density pass has just written each field's post-stream
// density rho[F][ny][nx]: one thread a cell pulls its 9F values from f (or
// the shard and its halos, kShard), reads the velocity planes and, for the
// clumpy surfactant, the neighbours' densities in rho at its global
// coordinates (psi of each of the 8, the order of belt_sums). A launch of
// one step has one level of the sweep's pipeline to fill and gains nothing
// from its rings; this kernel took 0.0107-0.0309 ms a launch at the exact
// main paths against the sweep's 0.0352-0.0552 at K = 1 (CUDA-graph
// replay on an H100 at 700 W; PERF.md, section 6), so the screened
// families' exact step launches it (ops/fused_coupled.py:
// _coupled_cell_step, _coupled_cell_step_halo).
constexpr int kCellBlock = 256;

template <int PHYS, bool kShard>
__global__ void __launch_bounds__(kCellBlock)
coupled_cell_kernel(const float* __restrict__ f_in, HaloSource halo,
                    float* __restrict__ f_out, const float* __restrict__ rho,
                    const float* __restrict__ ext, Domain d,
                    Lb2dCoupledParams p) {
  using T = CoupledTraits<PHYS>;
  static_assert(!T::kRocket, "the rocket yeasts run the sweep");
  constexpr int F = T::F;
  const long long cell = (long long)blockIdx.x * kCellBlock + threadIdx.x;
  if (cell >= (long long)d.rows * d.cols) return;
  const int y = (int)(cell / d.cols), x = (int)(cell % d.cols);
  const CellAt<kShard> at(d, y, x, cell);
  const size_t plane = (size_t)d.ny * d.nx;  // rho's and ext's
  const size_t out_plane = (size_t)d.rows * d.cols;

  float s0[9], s1[9];
  pull<9, F, kShard>(f_in, halo, d, 0, y, x, false, s0);
  const float r0 = density_of(s0);
  float r1 = 0.0f;
  if constexpr (F == 2) {
    pull<9, F, kShard>(f_in, halo, d, 1, y, x, false, s1);
    r1 = density_of(s1);
  }
  const float u = ext[at.global], v = ext[plane + at.global];
  float Fx = 0.0f, Fy = 0.0f;
  if constexpr (T::kForce) {  // the clumpy pseudo-force
    float fx = 0.0f, fy = 0.0f;
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const int cx = dir_cx<9>(j), cy = dir_cy<9>(j);
      const float psi = psi_shan_chen(
          rho[(size_t)wrap1(at.gy + cy, d.ny) * d.nx + wrap1(at.gx + cx, d.nx)],
          p.rho_o);
      if (cx != 0) fx += (w9(j) * (float)cx) * psi;
      if (cy != 0) fy += (w9(j) * (float)cy) * psi;
    }
    const float pref = p.sc_pref * psi_shan_chen(r0, p.rho_o);
    Fx = pref * fx;
    Fy = pref * fy;
  }
  const GlobalPut<F> put = {f_out + cell, out_plane};
  coupled_update<PHYS>(s0, s1, r0, r1, u, v, Fx, Fy, p, put);
}

template <int PHYS, bool kShard>
cudaError_t cell_launch(const float* f_in, const HaloSource& halo,
                        float* f_out, const float* rho, const float* ext,
                        const Domain& d, const Lb2dCoupledParams& p,
                        cudaStream_t stream) {
  if constexpr (CoupledTraits<PHYS>::kRocket) {
    return cudaErrorInvalidValue;
  } else {
    const long long blocks =
        ((long long)d.rows * d.cols + kCellBlock - 1) / kCellBlock;
    if (d.ny < 3 || d.nx < 3 || blocks > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    coupled_cell_kernel<PHYS, kShard>
        <<<(unsigned)blocks, kCellBlock, 0, stream>>>(f_in, halo, f_out, rho,
                                                      ext, d, p);
    return cudaGetLastError();
  }
}

template <int PHYS, class Src>
cudaError_t launch(const Src& src, float* f_out, const float* rho,
                   const float* ext, const Domain& d, int K,
                   const Lb2dCoupledParams& p, cudaStream_t stream) {
  if (K < 1 || K > coupled_max_k<PHYS>()) return cudaErrorInvalidValue;
  if (rho != nullptr) {  // one step, the solve's densities at hand
    if (K != 1) return cudaErrorInvalidValue;
    if constexpr (std::is_same<Src, HaloSource>::value)
      return cell_launch<PHYS, true>(nullptr, src, f_out, rho, ext, d, p,
                                     stream);
    else
      return cell_launch<PHYS, false>(src.f, HaloSource{}, f_out, rho, ext,
                                      d, p, stream);
  }
  if constexpr (std::is_same<Src, HaloSource>::value) {
    if (src.hk < coupled_reach<PHYS>() * K) return cudaErrorInvalidValue;
  }
  const auto kernel = coupled_sweep_kernel<PHYS, Src>;
  constexpr int W = strip_width<CoupledTraits<PHYS>::F>();
  const int smem = coupled_smem<PHYS>(K), threads = coupled_span<PHYS>() * K;
  static SweepSlots cache;  // per instantiation
  int slots = 0;
  const cudaError_t err = cache.get(kernel, smem, K, slots, threads);
  if (err != cudaSuccess) return err;
  const SweepPlan plan =
      sweep_plan(d.rows, d.cols, coupled_reach<PHYS>() * K, W, slots);
  if (plan.segments > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(plan.strips, plan.segments), threads, smem, stream>>>(
      src, f_out, ext, d, K, plan, p);
  return cudaGetLastError();
}

template <class Src>
cudaError_t dispatch(const Src& src, float* f_out, const float* rho,
                     const float* ext, const Domain& d, int K,
                     const Lb2dCoupledParams& prm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prm.physics) {
#define LB2D_COUPLED(PHYS) \
  case PHYS:               \
    return launch<PHYS>(src, f_out, rho, ext, d, K, prm, s);
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

// k_steps coupled steps of f_in into f_out (both [9][F][ny][nx] float32,
// contiguous, distinct; F = 1 for kScreenedFisher, else 2); ext: the
// velocity planes [2][ny][nx], held for the k_steps steps (read by the
// screened Fisher and surfactant physics, else may be NULL);
// 1 <= k_steps <= lb2d_coupled_max_k(physics). rho: NULL, or, for one step
// of a screened family on a grid of at least 3 x 3, the post-stream
// densities [F][ny][nx] of f_in, and the one-step kernel runs. Launches on
// `stream` and returns the launch's CUDA error code.
extern "C" int lb2d_coupled_sweep(const float* f_in, float* f_out,
                                  const float* rho, const float* ext, int ny,
                                  int nx, int k_steps, Lb2dCoupledParams prm,
                                  void* stream) {
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch(GridSource{f_in, ny, nx}, f_out, rho, ext,
                       Domain{ny, nx, 0, 0, ny, nx}, k_steps, prm, stream);
}

// K7h: k_steps coupled steps of a shard f [9 F][H][W] (global rows
// [y0, y0 + H), columns [x0, x0 + W) of an ny x nx grid) with its halos of
// hk >= reach k_steps cells (reach 2 for the physics that read the
// neighbours' densities, else 1): top, bot [9 F][hk][W] and, unless the
// shard spans the grid's width (both NULL), left, right [9 F][H + 2hk][hk],
// into f_out [9 F][H][W]; rho and ext are whole-grid [F][ny][nx],
// [2][ny][nx], read at the cells' global coordinates. Otherwise as
// lb2d_coupled_sweep.
extern "C" int lb2d_coupled_halo_sweep(const float* f, const float* top,
                                       const float* bot, const float* left,
                                       const float* right, float* f_out,
                                       const float* rho, const float* ext,
                                       int H, int W, int hk, int y0, int x0,
                                       int ny, int nx, int k_steps,
                                       Lb2dCoupledParams prm, void* stream) {
  const bool x_wraps = left == nullptr && right == nullptr;
  if (hk < 1 || H < 1 || W < 1 || y0 < 0 || x0 < 0 || y0 + H > ny ||
      x0 + W > nx || (x_wraps && (x0 != 0 || W != nx)) ||
      (left == nullptr) != (right == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(HaloSource{f, top, bot, left, right, H, W, hk}, f_out,
                       rho, ext, Domain{H, W, y0, x0, ny, nx}, k_steps, prm,
                       stream);
}

// The most steps of one launch of `physics` (shared memory), which
// lb2d_tpu_torch/ops/sweep.py:coupled_max_k mirrors; 0 for an unknown one.
extern "C" int lb2d_coupled_max_k(int physics) {
  switch (physics) {
    case kRocketYeast:
      return coupled_max_k<kRocketYeast>();
    case kRocketYeastForcesOnly:
      return coupled_max_k<kRocketYeastForcesOnly>();
    case kScreenedFisher:
      return coupled_max_k<kScreenedFisher>();
    case kSurfactant:
      return coupled_max_k<kSurfactant>();
    case kClumpySurfactant:
      return coupled_max_k<kClumpySurfactant>();
    default:
      return 0;
  }
}

// sizeof(Lb2dCoupledParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_coupled_params_size() {
  return (int)sizeof(Lb2dCoupledParams);
}
