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
// intermediate rows); K5 keeps the first K4's tile loop (band_tile_kernel,
// below, says why). A block sweeps a strip of at most
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

// K5's loop: K Expansion steps of a band in T x T tiles, each block
// writing the inner (T - 2K)^2 cells of its region (the first K4's loop,
// which K5 keeps: its 2K emitted rows make a row sweep's segments a few
// rows long, and its 3K phases of pipeline fill cost more than the tiles'
// halo, 0.0073 against 0.0062 ms per step at K = 4; PERF.md, PR 9). Two
// buffers of 9F planes of the tile: T = 32 up to F = 3, 24 up to 5, 16
// from 6, so K <= 8, and 4 from F = 6.
template <int F>
__host__ __device__ constexpr int band_tile_edge() {
  return F <= 3 ? 32 : F <= 5 ? 24 : 16;
}

template <int F>
__host__ __device__ constexpr int band_max_k() {
  return (band_tile_edge<F>() - 8) / 2 < 8 ? (band_tile_edge<F>() - 8) / 2 : 8;
}

template <int F>
__host__ __device__ constexpr int band_smem() {
  return 2 * 9 * F * band_tile_edge<F>() * band_tile_edge<F>() *
         (int)sizeof(float);
}

template <int F>
__host__ __device__ constexpr int band_min_blocks() {
  return 3 * band_smem<F>() <= kSmemPerBlock ? 3
         : 2 * band_smem<F>() <= kSmemPerBlock ? 2 : 1;
}

// field p's 9 pulls of the tile cell at p0 (direction 0 of field 0; plane q
// of a cell at q T^2 from it)
template <int F, int T>
struct TilePull {
  const float* p0;

  __device__ __forceinline__ void operator()(int p, float (&s)[9]) const {
    constexpr int dir = F * T * T;
    const float* q = p0 + p * T * T;
    s[0] = q[0];
    s[1] = q[1 * dir - 1];
    s[2] = q[2 * dir - T];
    s[3] = q[3 * dir + 1];
    s[4] = q[4 * dir + T];
    s[5] = q[5 * dir - T - 1];
    s[6] = q[6 * dir - T + 1];
    s[7] = q[7 * dir + T + 1];
    s[8] = q[8 * dir + T - 1];
  }
};

// K steps of the band domain d (GridSource: its rows wrap within it) into
// f_out[9F][out_rows][d.cols], domain rows [out0, out0 + out_rows); block
// row b writes output rows [b (T - 2K), (b + 1) (T - 2K)).
template <int F>
__global__ void __launch_bounds__(kSweepThreads, band_min_blocks<F>())
band_tile_kernel(GridSource src, float* __restrict__ f_out, Domain d, int K,
                 int out0, int out_rows, Lb2dMultifieldParams prm) {
  constexpr int T = band_tile_edge<F>();
  constexpr int TT = T * T;
  constexpr int kPlanes = 9 * F;
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + kPlanes * TT;

  const int inner = T - 2 * K;
  const int y0 = out0 + blockIdx.y * inner - K;  // domain row of region row 0
  const int x0 = blockIdx.x * inner - K;
  const size_t out_plane = (size_t)out_rows * d.cols;

  for (int i = threadIdx.x; i < TT; i += kSweepThreads) {
    size_t stride;
    const float* p = src.at(y0 + i / T, x0 + i % T, stride);
#pragma unroll 9
    for (int pl = 0; pl < kPlanes; ++pl) cur[pl * TT + i] = __ldg(p + pl * stride);
  }
  float coef[9];
  feq_coefficients(prm.u, prm.v, coef);
  __syncthreads();

  for (int s = 1; s <= K; ++s) {
    const bool last = s == K;
    for (int i = threadIdx.x; i < TT; i += kSweepThreads) {
      const int r = i / T, c = i % T;
      if (r < s || r >= T - s || c < s || c >= T - s) continue;
      const int oy = blockIdx.y * inner + r - K;  // output row at the last step
      if (last && (oy >= out_rows || x0 + c >= d.cols)) continue;  // ragged edge
      const int gy = wrap(d.y0 + y0 + r, d.ny), gx = wrap(d.x0 + x0 + c, d.nx);
      const GlobalPut<F> put = {
          last ? f_out + (size_t)oy * d.cols + (x0 + c) : nxt + i,
          last ? out_plane : (size_t)TT};
      expansion_cell_update<F>(TilePull<F, T>{cur + i}, put,
                               (unsigned long long)gy * d.nx + gx,
                               prm.step0 + (s - 1), prm, coef);
    }
    if (!last) {
      __syncthreads();  // step s complete before step s+1 reads it
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <int F>
cudaError_t band_launch(const GridSource& src, float* f_out, const Domain& d,
                        int K, int out0, int out_rows,
                        const Lb2dMultifieldParams& prm,
                        cudaStream_t stream) {
  if (K < 1 || K > band_max_k<F>()) return cudaErrorInvalidValue;
  constexpr int smem = band_smem<F>();
  static_assert(smem <= kSmemPerBlock, "the tile does not fit");
  // once per instantiation and card: the attribute is the card's
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_tile_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int inner = band_tile_edge<F>() - 2 * K;
  const dim3 grid((d.cols + inner - 1) / inner, (out_rows + inner - 1) / inner);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  band_tile_kernel<F><<<grid, kSweepThreads, smem, stream>>>(
      src, f_out, d, K, out0, out_rows, prm);
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
  // band row r is global row (row0 + r) mod ny; the rows that reach the
  // emitted ones, [(rows - 2 k_steps) / 2 - k_steps, (rows + 2 k_steps) / 2
  // + k_steps), lie inside the band, so they are never its own wrap's
  const GridSource src = {band, rows, nx};
  const Domain d = {rows, nx, row0, 0, ny, nx};
  const int out0 = (rows - 2 * k_steps) / 2, out_rows = 2 * k_steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_fields) {
#define LB2D_BAND(n)                                                     \
  case n:                                                                \
    return (int)band_launch<n>(src, out, d, k_steps, out0, out_rows, prm, s);
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
