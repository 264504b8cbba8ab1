// K steps of the multifield range expansions per pass, for Hopper (sm_90a):
// K4 and K5.
//
// K4 replaces lb2d_tpu/ops/fused.py:make_temporal_multifield_step with both
// of its physics: "fisher" (FisherExpansion: F competing populations,
// no-flux walls on all four sides) and "expansion" (Expansion: F - 1
// populations and a nutrient, Milstein noise and clips, fully periodic).
// K5 replaces fused.py:make_expansion_band_step: K Expansion steps on a
// band of R rows that wraps within itself, emitting the central 2K rows.
// Both run one kernel: the design of K2 (temporal_step.cu) with 9F planes.
// A block loads its region's 9F planes, with periodic wrap, into shared
// memory, runs K steps between two buffers (stage s on the cells at least
// s from the region's edge) and writes its inner cells once. Every cell
// uses its wrapped global coordinates, so
// - the Fisher walls apply by global row and column and K4 equals K plain
//   steps, including the corner populations that keep their streamed
//   values: the TPU model's wall seam patch (multifield.py:250-286) is not
//   needed;
// - the Expansion's y-wrap is exact, so its main path needs no band patch
//   (multifield.py:355-419). K5 stays as the band step that shard seams
//   can use: it is the same kernel on a band of `rows` rows, writing only
//   rows [(R - 2K) / 2, (R + 2K) / 2), with band row r drawing the noise
//   of global row (row0 + r) mod ny.
// K9's multifield physics (lb2d_halo_multifield_step, replacing
// lb2d_tpu/ops/fused_halo.py:make_temporal_halo_step with "multifield_fisher"
// and "multifield_expansion") is the same kernel on one shard: its region
// loads through region_source.cuh's HaloSource, and the walls and the noise
// follow the global coordinates, so no wall or seam band is needed.
// The noise of a cell at stage s is the Philox normal of (its global cell
// index, step0 + s - 1, population) (multifield_cell.cuh), so a halo cell
// recomputed here, K4 at any K, K5 and the plain step follow one
// trajectory. The TPU kernels reseed per (sweep, chunk, stage) and per
// band launch (fused.py:1626-1628, 1859), so their noise depends on the
// cut; this one does not.
//
// Shared memory: two buffers of 9F planes of a T x T region, 72 F T^2
// bytes, within the 227 KB a block may have: T = 32 for F <= 3 (216 KB at
// F = 3), 24 for F <= 5, 16 for F <= 8; K <= min(8, (T - 8) / 2), so the
// inner region keeps an edge of at least 8 cells.
// Bound: per cell written, the block reads T^2 / (T - 2K)^2 cells' 36F B
// (neighbouring halos mostly from L2) and writes 36F B once for K steps,
// recomputing the halo ((T - 2s)^2 cells at step s). The shared-memory
// reads are 18F per cell-step (each field pulled twice, see
// multifield_cell.cuh) and a block-wide barrier separates the steps. This
// first version loads with plain loads; cp.async/TMA double buffering and
// a smaller per-block footprint (more blocks per SM) are left to later
// work.

#include "multifield_cell.cuh"
#include "region_source.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemPerBlock = 232448;  // the 227 KB a block may have

template <int F>
__host__ __device__ constexpr int tile_edge() {
  return F <= 3 ? 32 : F <= 5 ? 24 : 16;
}

template <int F>
__host__ __device__ constexpr int max_k() {
  return (tile_edge<F>() - 8) / 2 < 8 ? (tile_edge<F>() - 8) / 2 : 8;
}

template <int F>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * 9 * F * tile_edge<F>() * tile_edge<F>() * (int)sizeof(float);
}

// blocks per SM that the shared memory allows: the register budget of
// __launch_bounds__ follows it
template <int F>
__host__ __device__ constexpr int min_blocks() {
  return 3 * smem_bytes<F>() <= kSmemPerBlock ? 3
         : 2 * smem_bytes<F>() <= kSmemPerBlock ? 2 : 1;
}

// K steps of the domain d, whose region cells come from src
// (region_source.cuh): the whole grid (K4), K5's band, or a shard and its
// halos (K9). The output f_out[9F][out_rows][d.cols] holds domain rows
// [out0, out0 + out_rows); block row b writes output rows [b (T - 2K),
// (b + 1) (T - 2K)). The walls and the noise cell of domain cell (y, x) are
// those of global cell (wrap(d.y0 + y, d.ny), wrap(d.x0 + x, d.nx)).
template <int F, bool kExpansion, class Src>
__global__ void __launch_bounds__(kThreads, min_blocks<F>())
multifield_kernel(Src src, float* __restrict__ f_out, Domain d, int K,
                  int out0, int out_rows, Lb2dMultifieldParams prm) {
  constexpr int T = tile_edge<F>();
  constexpr int TT = T * T;
  constexpr int kPlanes = 9 * F;
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + kPlanes * TT;

  const int inner = T - 2 * K;
  const int y0 = out0 + blockIdx.y * inner - K;  // unwrapped domain row of region row 0
  const int x0 = blockIdx.x * inner - K;
  const size_t out_plane = (size_t)out_rows * d.cols;

  for (int i = threadIdx.x; i < TT; i += kThreads) {
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
    for (int i = threadIdx.x; i < TT; i += kThreads) {
      const int r = i / T, c = i % T;
      if (r < s || r >= T - s || c < s || c >= T - s) continue;
      const int oy = blockIdx.y * inner + r - K;  // output row at the last step
      if (last && (oy >= out_rows || x0 + c >= d.cols)) continue;  // ragged edge
      const int gy = wrap(d.y0 + y0 + r, d.ny), gx = wrap(d.x0 + x0 + c, d.nx);
      float* dst = last ? f_out + (size_t)oy * d.cols + (x0 + c) : nxt + i;
      const size_t dst_plane = last ? out_plane : (size_t)TT;
      if constexpr (kExpansion) {
        const unsigned long long cell = (unsigned long long)gy * d.nx + gx;
        expansion_cell_update<F>(cur + i, T, dst, dst_plane, cell,
                                 prm.step0 + (s - 1), prm, coef);
      } else {
        fisher_cell_update<F>(cur + i, T, dst, dst_plane, gy, gx, d.ny, d.nx,
                              prm, coef);
      }
    }
    if (!last) {
      __syncthreads();  // step s complete before step s+1 reads it
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <int F, bool kExpansion, class Src>
cudaError_t launch(const Src& src, float* f_out, const Domain& d, int K,
                   int out0, int out_rows, const Lb2dMultifieldParams& prm,
                   cudaStream_t stream) {
  if (K < 1 || K > max_k<F>()) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<F>();
  static_assert(smem <= kSmemPerBlock, "the tile does not fit");
  // once per instantiation and card: the attribute is the card's
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        multifield_kernel<F, kExpansion, Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int inner = tile_edge<F>() - 2 * K;
  const dim3 grid((d.cols + inner - 1) / inner, (out_rows + inner - 1) / inner);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  multifield_kernel<F, kExpansion, Src><<<grid, kThreads, smem, stream>>>(
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
// 1 <= k_steps <= min(8, (T - 8) / 2) for F's tile edge T. `expansion`
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
// band's own wrap does not reach the emitted rows. Other arguments and the
// result as lb2d_temporal_multifield_step.
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
  return (int)dispatch<true>(num_fields, src, out, d, k_steps,
                             (rows - 2 * k_steps) / 2, 2 * k_steps, prm,
                             stream);
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
