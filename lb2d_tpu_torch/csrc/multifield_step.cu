// K steps of the multifield range expansions per pass, for Hopper (sm_90a):
// K4 and K5.
//
// K4 replaces lb2d_tpu/ops/fused.py:make_temporal_multifield_step with both
// of its physics: "fisher" (FisherExpansion: F competing populations,
// no-flux walls on all four sides) and "expansion" (Expansion: F - 1
// populations and a nutrient, Milstein noise and clips, fully periodic).
// K5 replaces fused.py:make_expansion_band_step: K Expansion steps on a
// band of R rows that wraps within itself, emitting the central 2K rows.
// K4 runs K2's row sweep (row_sweep.cuh, temporal_step.cu) on 9F planes,
// the TPU kernel's own loop (fused.py:1539, row chunks in order, rings of
// intermediate rows); K5 runs a cone of one cell per thread
// (band_cone_kernel, below). A K4 block sweeps a strip of at most
// 64 columns (F = 2, 3; 128 at F = 1, 32 at F >= 4) down a segment of
// rows: the next input row's 9F planes arrive by cp.async while each level
// computes its row from the ring of the level below, and the last level
// writes f_out. Every cell uses its wrapped global coordinates, so
// - the Fisher walls apply by global row and column and K4 equals K plain
//   steps, including the corner populations that keep their streamed
//   values: the TPU model's wall seam patch (multifield.py:250-286) is not
//   needed;
// - the Expansion's y-wrap is exact, so its main path needs no band patch
//   (multifield.py:355-419). K5 stays as the band step that shard seams
//   can use: on a band of `rows` rows it writes only rows [(R - 2K) / 2,
//   (R + 2K) / 2), with band row r drawing the noise of global row
//   (row0 + r) mod ny, through the same per-cell update.
// K5's 2K output rows are too few for a sweep (its 3K phases of pipeline
// fill) and for tiles (the first K4's 32 x 32 tiles: 43 blocks at 1024
// columns, each thread four cell updates in a row per step). What bounds
// it on this card is the chain of K cell updates and the launch, not its
// bytes (16 x 1024 x 27 planes, 0.8 us at 3.35 TB/s). So a block owns a
// strip of about nx / 128 columns (128 blocks, one an SM, at 1024) and
// computes only the cone that reaches its 2K x W outputs, one cell a
// thread: a launch is K updates and K - 1 barriers per thread, level 1
// reading the band straight from global memory (band_cone_kernel). Its
// shared memory holds levels 1 and 2 (36,720 B at F = 3, K = 4, 224
// threads). On an H100 80GB HBM3 at 700 W (PERF.md, section 6):
// 0.0089 ms a launch by CUDA-graph replay on the 1024^2 Expansion's 16-row
// band, against 0.0231 for the tiles.
// K9's multifield physics (lb2d_halo_multifield_step, replacing
// lb2d_tpu/ops/fused_halo.py:make_temporal_halo_step with "multifield_fisher"
// and "multifield_expansion") is the same kernel on one shard: its rows
// load through region_source.cuh's HaloSource, and the walls and the noise
// follow the global coordinates, so no wall or seam band is needed.
// The noise of a cell at stage s is the Philox normal of (its global cell
// index, step0 + s - 1, population) (multifield_cell.cuh), so a halo cell
// computed twice, K4 at any K, K5 and the plain step follow one
// trajectory. The TPU kernels reseed per (sweep, chunk, stage) and per
// band launch (fused.py:1626-1628, 1859), so their noise depends on the
// cut; this one does not.
//
// Shared memory: (27 K + 9) ring rows of F planes of the strip, 4 (27 K +
// 9) F W bytes: 60 KB at F = 2, K = 4 (three blocks per SM; the first K4's
// two 32 x 32 tiles of 18 planes took 147 KB, one block per SM, and idled
// the SM while that block loaded and at every step's barrier). K <= 8
// (row_sweep.cuh), which fits one block up to F = 8 (225 KB).
// Bound: per cell and step 72F/K B of HBM and the update's arithmetic,
// computed W / (W - 2K) times over for the x halo; the shared-memory reads
// are 18F per cell-step (each field pulled twice, see multifield_cell.cuh).
// A thread takes two columns of its level at F <= 2. On an H100 80GB HBM3
// at 700 W (PERF.md, section 6, PR 9): fisher 2048^2, F = 2, 0.105 ms per
// step at K = 8, expansion 1024^2, F = 3, 0.053 at K = 4, against 0.235
// and 0.106 for the tile loop.

#include "multifield_cell.cuh"
#include "region_source.cuh"
#include "row_sweep.cuh"

namespace {

// blocks per SM that the shared memory allows at K = 4: the register budget
// of __launch_bounds__ follows it
template <int F>
__host__ __device__ constexpr int min_blocks() {
  return 233472 / (sweep_smem<F>(4, false) + 1024) >= 3   ? 3
         : 233472 / (sweep_smem<F>(4, false) + 1024) >= 2 ? 2
                                                          : 1;
}

template <int F, bool kExpansion, class Pull, class Put>
__device__ __forceinline__ void multifield_cell(
    const Pull& pull, const Put& put, int gy, int gx, const Domain& d,
    unsigned long long step, const Lb2dMultifieldParams& prm,
    const float (&coef)[9]) {
  if constexpr (kExpansion) {
    expansion_cell_update<F>(pull, put, (unsigned long long)gy * d.nx + gx,
                             step, prm, coef);
  } else {
    fisher_cell_update<F>(pull, put, gy, gx, d.ny, d.nx, prm, coef);
  }
}

// columns per thread (kSpan = W / kCols apart): two cells of one level up
// to F = 2 (0.115 against 0.135 ms per step at 2048^2, K = 8, one call);
// one from F = 3, where two were slower (0.076 against 0.054 at 1024^2)
template <int F>
__host__ __device__ constexpr int cols_per_thread() {
  return F <= 2 ? 2 : 1;
}

// K steps of the domain d, whose cells come from src (region_source.cuh):
// the whole grid (K4), K5's band, or a shard and its halos (K9). The output
// f_out[9F][out_rows][d.cols] holds domain rows [out0, out0 + out_rows),
// cut into the work items of `plan` (strip blockIdx.x, segment
// blockIdx.y). The walls and the noise cell of domain cell (y, x) are
// those of global cell (wrap(d.y0 + y, d.ny), wrap(d.x0 + x, d.nx)).
template <int F, bool kExpansion, class Src>
__global__ void __launch_bounds__(kSweepThreads, min_blocks<F>())
multifield_kernel(Src src, float* __restrict__ f_out, Domain d, int K,
                  int out0, int out_rows, SweepPlan plan,
                  Lb2dMultifieldParams prm) {
  constexpr int W = strip_width<F>();
  constexpr int kCols = cols_per_thread<F>();
  constexpr int kSpan = W / kCols;
  constexpr int kLanes = kSweepThreads / kSpan;  // levels side by side
  constexpr int kPlanes = 9 * F;
  constexpr int kLoadLanes = kSweepThreads / W;  // threads per input column
  constexpr int kLoads = (kPlanes + kLoadLanes - 1) / kLoadLanes;
  constexpr int kLevel = sweep_level_rows(false) * F * W;
  extern __shared__ float smem[];
  float* const ring_in = smem;
  float* const rings = smem + sweep_level_rows(true) * F * W;  // 1..K-1

  const int xs = blockIdx.x * plan.wo, ys = blockIdx.y * plan.seg;
  const int width = min(plan.wo, d.cols - xs) + 2 * K;  // region columns
  const int rows = min(plan.seg, out_rows - ys);        // rows written
  const int inputs = rows + 2 * K;                      // input rows
  const int y0 = out0 + ys - K;     // domain row of the first input row
  const size_t out_plane = (size_t)out_rows * d.cols;

  // the loads: column cl, planes lane_l, lane_l + kLoadLanes, ...
  const int cl = threadIdx.x % W, lane_l = threadIdx.x / W;
  // the cells: columns c + i kSpan of levels lane + 1, lane + 1 + kLanes, ..
  const int c = threadIdx.x % kSpan, lane = threadIdx.x / kSpan;
  int gx[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    gx[i] = wrap(d.x0 + xs - K + c + i * kSpan, d.nx);

  auto issue = [&](int t, const int (&ld)[3]) {  // the input row of phase t
    if (cl < width && t < inputs) {
      size_t stride;
      const float* p = src.at(y0 + t, xs - K + cl, stride);
      // the thread's planes as constants: one unrolled copy per lane
#pragma unroll
      for (int l = 0; l < kLoadLanes; ++l) {
        if (l != lane_l) continue;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int q = l + i * kLoadLanes;
          if (q < kPlanes)
            cp_async4(ring_in + sweep_load_offset<F>(q, ld) + cl,
                      p + q * stride);
        }
      }
    }
    cp_async_commit();
  };
  float coef[9];
  feq_coefficients(prm.u, prm.v, coef);

#pragma unroll
  for (int t = 0; t < kPrefetch; ++t) issue(t, SweepPhase<F>(t - kPrefetch).ld);

  int row_t = wrap(d.y0 + y0, d.ny);  // global row of phase t's input row
  for (int t = 0; t < rows + 3 * K; ++t) {
    const SweepPhase<F> ph(t);
    issue(t + kPrefetch, ph.ld);
    for (int s = 1 + lane; s <= K; s += kLanes) {
      if (t < 3 * s || t >= inputs + s) continue;
      bool act[kCols], any = false;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        act[i] = c + i * kSpan >= s && c + i * kSpan < width - s;
        any |= act[i];
      }
      if (!any) continue;
      const int y = y0 + t - 2 * s;  // the level's domain row
      int gy = row_t - 2 * s;
      if (gy < 0) gy = wrap(gy, d.ny);
      const bool first = s == 1;
      const float* in = first ? ring_in : rings + (s - 2) * kLevel;
      const float* g0 = in + (first ? ph.rd_in[0] : ph.rd[0]);
      const float* g1 = in + (first ? ph.rd_in[1] : ph.rd[1]);
      const float* g2 = in + (first ? ph.rd_in[2] : ph.rd[2]);
      const unsigned long long step = prm.step0 + (s - 1);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (!act[i]) continue;
        const int ci = c + i * kSpan;
        const RingPull<F> pull = {g0 + ci, g1 + ci, g2 + ci};
        if (s == K) {
          const GlobalPut<F> put = {
              f_out + (size_t)(y - out0) * d.cols + (xs - K + ci), out_plane};
          multifield_cell<F, kExpansion>(pull, put, gy, gx[i], d, step, prm,
                                         coef);
        } else {
          float* o = rings + (s - 1) * kLevel + ci;
          const RingPut<F> put = {o + ph.wr[0], o + ph.wr[1], o + ph.wr[2]};
          multifield_cell<F, kExpansion>(pull, put, gy, gx[i], d, step, prm,
                                         coef);
        }
      }
    }
    cp_async_wait<kPrefetch>();  // the row of phase t has landed
    __syncthreads();
    row_t = row_t + 1 == d.ny ? 0 : row_t + 1;
  }
}

template <int F, bool kExpansion, class Src>
cudaError_t launch(const Src& src, float* f_out, const Domain& d, int K,
                   int out0, int out_rows, const Lb2dMultifieldParams& prm,
                   cudaStream_t stream) {
  if (K < 1 || K > sweep_max_k<F>()) return cudaErrorInvalidValue;
  const auto kernel = multifield_kernel<F, kExpansion, Src>;
  const int smem = sweep_smem<F>(K, false);
  static SweepSlots cache;  // per instantiation
  int slots = 0;
  const cudaError_t err = cache.get(kernel, smem, K, slots);
  if (err != cudaSuccess) return err;
  const SweepPlan plan = sweep_plan(out_rows, d.cols, K, strip_width<F>(),
                                    slots);
  if (plan.segments > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(plan.strips, plan.segments), kSweepThreads, smem, stream>>>(
      src, f_out, d, K, out0, out_rows, plan, prm);
  return cudaGetLastError();
}

// K5: K Expansion steps of a band as a cone of one cell per thread. A
// block owns a strip of W output columns and all 2K output rows; its
// level s (1..K) computes only the cells that reach them, the region of
// halo h = K - s: band rows [out0 - h, out0 + 2K + h), columns [xs - h, xs
// + W + h), thread t the cell (t / cols, t % cols). Level 1 pulls from the
// band in global memory (its band rows [out0 - K, out0 + 3K) lie inside
// the band, so they never wrap), levels 2..K from the level below in
// shared memory (odd levels in one buffer, even in the other), and level K
// writes f_out. The plan (band_plan; mirror ops/band_plan.py) aims at
// kBandBlocks strips; W shrinks until level 1 has at most kBandThreads
// cells and both buffers fit kSmemPerBlock.
constexpr int kBandThreads = 512;
constexpr int kBandBlocks = 128;

__host__ __device__ constexpr int band_level_rows(int K, int s) {
  return 4 * K - 2 * s;
}

__host__ __device__ constexpr int band_level_cols(int K, int s, int W) {
  return W + 2 * (K - s);
}

inline int band_smem(int F, int K, int W) {
  int cells = 0;
  for (int s = 1; s <= 2 && s < K; ++s)
    cells += band_level_rows(K, s) * band_level_cols(K, s, W);
  return 9 * F * cells * (int)sizeof(float);
}

inline int band_threads(int K, int W) {
  return (band_level_rows(K, 1) * band_level_cols(K, 1, W) + 31) / 32 * 32;
}

struct BandPlan {
  int width, strips, threads, smem;
};

// width 0: K steps do not fit even strips of one column
inline BandPlan band_plan(int F, int K, int nx) {
  int w = (nx + kBandBlocks - 1) / kBandBlocks;
  while (w > 0 && (band_threads(K, w) > kBandThreads ||
                   band_smem(F, K, w) > kSmemPerBlock))
    --w;
  if (w == 0) return {0, 0, 0, 0};
  return {w, (nx + w - 1) / w, band_threads(K, w), band_smem(F, K, w)};
}

// field p's 9 pulls of band row y, column x, from the band in global
// memory: f points at row y of plane 0, the columns x - 1, x, x + 1 wrapped
template <int F>
struct BandPull {
  const float* f;
  size_t plane;
  int nx, cm, c0, cp;

  __device__ __forceinline__ void operator()(int p, float (&s)[9]) const {
    const float* q = f + p * plane;
    const size_t d = F * plane;
    s[0] = __ldg(q + c0);
    s[1] = __ldg(q + d + cm);
    s[2] = __ldg(q + 2 * d - nx + c0);
    s[3] = __ldg(q + 3 * d + cp);
    s[4] = __ldg(q + 4 * d + nx + c0);
    s[5] = __ldg(q + 5 * d - nx + cm);
    s[6] = __ldg(q + 6 * d - nx + cp);
    s[7] = __ldg(q + 7 * d + nx + cp);
    s[8] = __ldg(q + 8 * d + nx + cm);
  }
};

// field p's 9 pulls of a cell from the level below in shared memory: p0 is
// the cell there (rows of `cols` cells, planes of `plane`)
template <int F>
struct ConePull {
  const float* p0;
  int cols, plane;

  __device__ __forceinline__ void operator()(int p, float (&s)[9]) const {
    const float* q = p0 + p * plane;
    const int d = F * plane;
    s[0] = q[0];
    s[1] = q[d - 1];
    s[2] = q[2 * d - cols];
    s[3] = q[3 * d + 1];
    s[4] = q[4 * d + cols];
    s[5] = q[5 * d - cols - 1];
    s[6] = q[6 * d - cols + 1];
    s[7] = q[7 * d + cols + 1];
    s[8] = q[8 * d + cols - 1];
  }
};

// K steps of band[9F][rows][nx] into f_out[9F][2K][nx], band rows [out0,
// out0 + 2K), out0 = (rows - 2K) / 2; band row y draws the noise of global
// row (row0 + y) mod ny of an ny x nx grid; block b owns columns [b W, (b +
// 1) W) of f_out
template <int F>
__global__ void __launch_bounds__(kBandThreads)
band_cone_kernel(const float* __restrict__ band, float* __restrict__ f_out,
                 int rows, int nx, int K, int W, int row0, int ny,
                 Lb2dMultifieldParams prm) {
  extern __shared__ float smem[];
  float* const odd = smem;  // levels 1, 3, ..
  float* const even =
      smem + 9 * F * band_level_rows(K, 1) * band_level_cols(K, 1, W);
  const int out0 = (rows - 2 * K) / 2, xs = blockIdx.x * W;
  const size_t plane = (size_t)rows * nx, out_plane = (size_t)2 * K * nx;
  float coef[9];
  feq_coefficients(prm.u, prm.v, coef);

  for (int s = 1; s <= K; ++s) {
    const int h = K - s, R = band_level_rows(K, s);
    const int C = band_level_cols(K, s, W);
    const int t = threadIdx.x, r = t / C, c = t % C;
    const bool last = s == K;
    if (t < R * C && !(last && xs + c >= nx)) {  // the ragged strip's edge
      const int y = out0 - h + r;  // band row
      const int gx = wrap(xs - h + c, nx);
      const unsigned long long cell =
          (unsigned long long)wrap(row0 + y, ny) * nx + gx;
      const unsigned long long step = prm.step0 + (s - 1);
      const GlobalPut<F> put =
          last ? GlobalPut<F>{f_out + (size_t)r * nx + xs + c, out_plane}
               : GlobalPut<F>{(s & 1 ? odd : even) + r * C + c,
                              (size_t)(R * C)};
      if (s == 1) {
        const BandPull<F> pull = {band + (size_t)y * nx, plane, nx,
                                  gx ? gx - 1 : nx - 1, gx,
                                  gx + 1 < nx ? gx + 1 : 0};
        expansion_cell_update<F>(pull, put, cell, step, prm, coef);
      } else {
        const int Cp = C + 2;  // the level below: halo h + 1
        const ConePull<F> pull = {(s & 1 ? even : odd) + (r + 1) * Cp + c + 1,
                                  Cp, (R + 2) * Cp};
        expansion_cell_update<F>(pull, put, cell, step, prm, coef);
      }
    }
    if (!last) __syncthreads();  // level s complete before s + 1 reads it
  }
}

template <int F>
cudaError_t band_launch(const float* band, float* f_out, int rows, int nx,
                        int K, int row0, int ny,
                        const Lb2dMultifieldParams& prm,
                        cudaStream_t stream) {
  const BandPlan plan = band_plan(F, K, nx);
  if (K < 1 || K > kSweepMaxK || plan.width == 0) return cudaErrorInvalidValue;
  // once per instantiation and card: the attribute is the card's
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_cone_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemPerBlock);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  band_cone_kernel<F><<<plan.strips, plan.threads, plan.smem, stream>>>(
      band, f_out, rows, nx, K, plan.width, row0, ny, prm);
  return cudaGetLastError();
}

template <bool kExpansion, class Src>
cudaError_t dispatch(int F, const Src& src, float* f_out, const Domain& d,
                     int K, int out0, int out_rows,
                     const Lb2dMultifieldParams& prm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LB2D_FIELDS(n)                                                      \
  case n:                                                                   \
    return launch<n, kExpansion>(src, f_out, d, K, out0, out_rows, prm, s);
  switch (F) {
    LB2D_FIELDS(2)
    LB2D_FIELDS(3)
    LB2D_FIELDS(4)
    LB2D_FIELDS(5)
    LB2D_FIELDS(6)
    LB2D_FIELDS(7)
    LB2D_FIELDS(8)
    case 1:
      if constexpr (!kExpansion)
        return launch<1, false>(src, f_out, d, K, out0, out_rows, prm, s);
      return cudaErrorInvalidValue;  // Expansion has a nutrient and >= 1 population
    default:
      return cudaErrorInvalidValue;
  }
#undef LB2D_FIELDS
}

}  // namespace

// k_steps multifield steps of f_in into f_out: f_in, f_out [9][F][ny][nx]
// float32, contiguous, distinct; 1 <= F <= 8 (2 <= F with expansion);
// 1 <= k_steps <= sweep_max_k<F>() (row_sweep.cuh). `expansion`
// selects the Expansion step, else FisherExpansion's. Launches on `stream`
// and returns the launch's CUDA error code.
extern "C" int lb2d_temporal_multifield_step(const float* f_in, float* f_out,
                                             int ny, int nx, int num_fields,
                                             int k_steps, int expansion,
                                             Lb2dMultifieldParams prm,
                                             void* stream) {
  if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const GridSource src = {f_in, ny, nx};
  const Domain d = {ny, nx, 0, 0, ny, nx};
  if (expansion)
    return (int)dispatch<true>(num_fields, src, f_out, d, k_steps, 0, ny, prm,
                               stream);
  return (int)dispatch<false>(num_fields, src, f_out, d, k_steps, 0, ny, prm,
                              stream);
}

// k_steps Expansion steps on band[9][F][rows][nx], whose rows wrap within
// the band, into out[9][F][2 k_steps][nx]: its rows [(rows - 2 k_steps) / 2,
// (rows + 2 k_steps) / 2). Band row r draws the noise of row (row0 + r) mod
// ny of an ny-row grid, 0 <= row0 < ny; rows >= 4 k_steps, so that the
// band's own wrap does not reach the emitted rows; 1 <= k_steps <=
// band_max_k<F>() (8, and 4 from F = 6). Other arguments and the result as
// lb2d_temporal_multifield_step.
extern "C" int lb2d_expansion_band_step(const float* band, float* out,
                                        int rows, int nx, int num_fields,
                                        int k_steps, int row0, int ny,
                                        Lb2dMultifieldParams prm,
                                        void* stream) {
  if (rows < 4 * k_steps || nx < 1 || ny < 1 || row0 < 0 || row0 >= ny)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_fields) {
#define LB2D_BAND(n)                                                   \
  case n:                                                              \
    return (int)band_launch<n>(band, out, rows, nx, k_steps, row0, ny, \
                               prm, s);
    LB2D_BAND(2)
    LB2D_BAND(3)
    LB2D_BAND(4)
    LB2D_BAND(5)
    LB2D_BAND(6)
    LB2D_BAND(7)
    LB2D_BAND(8)
#undef LB2D_BAND
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K9: k_steps multifield steps of one shard f[9F][H][W], global rows
// [y0, y0 + H) and columns [x0, x0 + W) of an ny x nx grid, into
// f_out[9F][H][W], from its halos (region_source.cuh: HaloSource): top, bot
// [9F][hk][W]; left, right [9F][H + 2hk][hk], or both NULL when W == nx.
// Fields, k_steps (also <= hk), `expansion` and prm as
// lb2d_temporal_multifield_step. Launches on `stream` and returns the
// launch's CUDA error code.
extern "C" int lb2d_halo_multifield_step(
    const float* f, const float* top, const float* bot, const float* left,
    const float* right, float* f_out, int H, int W, int hk, int y0, int x0,
    int ny, int nx, int num_fields, int k_steps, int expansion,
    Lb2dMultifieldParams prm, void* stream) {
  if (H < 1 || W < 1 || hk < 1 || k_steps > hk ||
      (left == nullptr) != (right == nullptr) ||
      (left == nullptr && W != nx) || y0 < 0 || y0 + H > ny || x0 < 0 ||
      x0 + W > nx)
    return (int)cudaErrorInvalidValue;
  const HaloSource src = {f, top, bot, left, right, H, W, hk};
  const Domain d = {H, W, y0, x0, ny, nx};
  if (expansion)
    return (int)dispatch<true>(num_fields, src, f_out, d, k_steps, 0, H, prm,
                               stream);
  return (int)dispatch<false>(num_fields, src, f_out, d, k_steps, 0, H, prm,
                              stream);
}

// sizeof(Lb2dMultifieldParams), which ops/_build.py holds its ctypes mirror to
extern "C" int lb2d_multifield_params_size() {
  return (int)sizeof(Lb2dMultifieldParams);
}
